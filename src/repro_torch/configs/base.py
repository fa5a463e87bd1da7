"""Architecture + run-shape configuration schema.

Counterpart of ``src/repro/configs/base.py``: the same ``ModelConfig``
fields (``param_dtype`` is a ``torch.dtype``). Every architecture provides a
``CONFIG`` (the published numbers) and a ``SMOKE`` (a reduced same-family
config for CPU tests). The run shapes (``ShapeConfig``, ``SHAPES``) come
with the dry-run tools (ROADMAP A21).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                 # 0 for attention-free (ssm)
    n_kv_heads: int
    d_ff: int                    # 0 for attention-free
    vocab_size: int
    head_dim: int = 0            # default d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1           # MoE replaces MLP in layers l % moe_every == moe_offset
    moe_offset: int = 0
    n_shared_experts: int = 0    # qwen2-moe: shared experts alongside routed
    dense_residual: bool = False # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_heads: int = 0           # d_inner // ssm_head_dim
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_k: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0          # hybrid: one attn layer per `attn_every` layers
    attn_offset: int = 0         # position of the attn layer within the period
    # --- misc ---
    norm: str = "rms"
    activation: str = "silu"
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    # --- frontend stub (vlm / audio) ---
    frontend: str | None = None  # 'patches' | 'frames'
    frontend_dim: int = 0        # incoming embedding width
    prefix_len: int = 0          # prefix positions in train/prefill sequences
    # --- numerics ---
    param_dtype: torch.dtype = torch.bfloat16
    # chunked (flash-style) attention block size for train/prefill when
    # seq_len exceeds it; 0 = always dense (cost-model mode)
    attn_chunk: int = 4096
    # --- provenance ---
    source: str = ""

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))
