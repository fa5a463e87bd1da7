"""smollm-360m [dense]: llama-arch small.
[hf:HuggingFaceTB/SmolLM-135M; hf]"""
import torch

from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_ff=2560,
    vocab_size=49152, head_dim=64,
    source="hf:HuggingFaceTB/SmolLM-135M",
)

SMOKE = ModelConfig(
    name="smollm-smoke", family="dense",
    n_layers=2, d_model=60, n_heads=3, n_kv_heads=1, d_ff=96,
    vocab_size=512, head_dim=20,
    param_dtype=torch.float32,
)
