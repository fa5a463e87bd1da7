"""llava-next-mistral-7b [vlm]: mistral backbone, anyres patch frontend STUB
(input_specs supplies precomputed patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, head_dim=128,
    frontend="patches", frontend_dim=1024, prefix_len=2048,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

SMOKE = ModelConfig(
    name="llava-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, head_dim=16,
    frontend="patches", frontend_dim=48, prefix_len=8,
    param_dtype=torch.float32,
)
