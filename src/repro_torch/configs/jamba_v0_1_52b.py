"""jamba-v0.1-52b [hybrid]: Mamba+attn 1:7 interleave, MoE 16e top-2 every
other layer. [arXiv:2403.19887; hf]"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=65536, head_dim=128,
    n_experts=16, top_k=2, moe_every=2, moe_offset=1,
    attn_every=8, attn_offset=4,
    ssm_state=16, ssm_heads=64, ssm_head_dim=128, ssm_expand=2,
    ssm_chunk=256,
    source="arXiv:2403.19887",
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=512, head_dim=16,
    n_experts=4, top_k=2, moe_every=2, moe_offset=1,
    attn_every=4, attn_offset=2,
    ssm_state=16, ssm_heads=8, ssm_head_dim=16, ssm_chunk=8,
    param_dtype=torch.float32,
)
