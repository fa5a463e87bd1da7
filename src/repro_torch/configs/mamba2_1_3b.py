"""mamba2-1.3b [ssm]: SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280,
    ssm_state=128, ssm_heads=64, ssm_head_dim=64, ssm_expand=2,
    ssm_chunk=256,
    source="arXiv:2405.21060",
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=512,
    ssm_state=16, ssm_heads=8, ssm_head_dim=16, ssm_chunk=8,
    param_dtype=torch.float32,
)
