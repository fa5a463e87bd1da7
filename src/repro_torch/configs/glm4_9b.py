"""glm4-9b [dense]: RoPE, GQA kv=2. [hf:THUDM/glm-4-9b; hf]"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab_size=151552, head_dim=128,
    source="hf:THUDM/glm-4-9b",
)

SMOKE = ModelConfig(
    name="glm4-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab_size=512, head_dim=16,
    param_dtype=torch.float32,
)
