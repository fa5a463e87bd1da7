"""qwen2-moe-a2.7b [moe]: 4 shared + 60 routed experts, top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=151936, head_dim=128,
    n_experts=60, top_k=4, n_shared_experts=4,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)

SMOKE = ModelConfig(
    name="qwen2-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=48,
    vocab_size=512, head_dim=16,
    n_experts=6, top_k=2, n_shared_experts=2,
    param_dtype=torch.float32,
)
