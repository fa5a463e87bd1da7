"""command-r-plus-104b [dense]: GQA kv=8, no-bias.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=33792,
    vocab_size=256000, head_dim=128,
    source="hf:CohereForAI/c4ai-command-r-v01",
)

SMOKE = ModelConfig(
    name="command-r-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, head_dim=16,
    param_dtype=torch.float32,
)
