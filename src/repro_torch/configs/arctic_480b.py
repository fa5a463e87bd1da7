"""arctic-480b [moe]: 128 routed experts (top-2) + dense residual FFN.
[hf:Snowflake/snowflake-arctic-base; hf]"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab_size=32000, head_dim=128,
    n_experts=128, top_k=2, dense_residual=True,
    source="hf:Snowflake/snowflake-arctic-base",
)

SMOKE = ModelConfig(
    name="arctic-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab_size=512, head_dim=16,
    n_experts=8, top_k=2, dense_residual=True,
    param_dtype=torch.float32,
)
