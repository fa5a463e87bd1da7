"""The paper's own primary workload: OpenAI GPT-2 (base) — used by the
TTA benchmarks (Fig 11, Table 1) and examples. [Radford et al. 2019]"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gpt2-paper", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab_size=50257, head_dim=64, activation="gelu",
    source="Radford et al. 2019 (paper §5.1.2)",
)

SMOKE = ModelConfig(
    name="gpt2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, head_dim=16, activation="gelu",
    param_dtype=torch.float32,
)
