"""stablelm-1.6b [dense]. [hf:stabilityai/stablelm-2-1_6b; unverified]"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab_size=100352, head_dim=64,
    source="hf:stabilityai/stablelm-2-1_6b",
)

SMOKE = ModelConfig(
    name="stablelm-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, head_dim=16,
    param_dtype=torch.float32,
)
