"""musicgen-medium [audio]: decoder-only over EnCodec tokens; conditioning
frontend STUB (precomputed frame embeddings). [arXiv:2306.05284; hf]"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab_size=2048, head_dim=64,
    frontend="frames", frontend_dim=768, prefix_len=256,
    source="arXiv:2306.05284",
)

SMOKE = ModelConfig(
    name="musicgen-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, head_dim=16,
    frontend="frames", frontend_dim=48, prefix_len=8,
    param_dtype=torch.float32,
)
