"""Architecture + run-shape configuration schema.

Counterpart of ``src/repro/configs/base.py``: the same ``ModelConfig``
fields (``param_dtype`` is a ``torch.dtype``). Every architecture provides a
``CONFIG`` (the published numbers) and a ``SMOKE`` (a reduced same-family
config for CPU tests). Shapes are the four assignment-wide cells;
``input_specs`` builds ``device="meta"`` tensors as stand-ins for a cell's
inputs (no allocation).
"""
from __future__ import annotations

import dataclasses
from typing import Any

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

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def is_attn_layer(self, layer: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_every:
            return layer % self.attn_every == self.attn_offset
        return True

    def is_moe_layer(self, layer: int) -> bool:
        if not self.n_experts:
            return False
        return layer % self.moe_every == self.moe_offset

    def sub_quadratic(self) -> bool:
        """True when the arch can decode 500k context (SSM/hybrid)."""
        return self.family in ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic():
        return False, ("pure full-attention arch: 500k-token decode needs "
                       "sub-quadratic attention (skip per assignment; see "
                       "DESIGN.md)")
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                *, batch_override: int | None = None) -> dict[str, Any]:
    """Meta-device stand-ins for every model input of this cell.

    train/prefill: full sequences (tokens + labels for train). The frontend
    stub supplies precomputed patch/frame embeddings as a prefix.
    decode: one new token per sequence (the KV cache / SSM state belongs to
    the serving state).
    """
    b = batch_override or shape.global_batch
    s = shape.seq_len

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        p = min(cfg.prefix_len, s // 2) if cfg.frontend else 0
        specs: dict[str, Any] = {"tokens": spec((b, s - p), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = spec((b, s - p), torch.int32)
        if p:
            specs["prefix_embeds"] = spec((b, p, cfg.frontend_dim),
                                          torch.float32)
        return specs

    # decode: one token against existing state
    return {"tokens": spec((b, 1), torch.int32)}
