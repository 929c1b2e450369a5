"""Model configuration dataclass (the port's own copy, torch dtypes).

Mirrors ``repro/models/config.py`` for the fields the dense and xLSTM
(``ssm``) serving paths read, the slot and paged KV layouts and the int8 KV
cache included (the ``ssm`` family has no KV cache and ignores them).  The
``family`` field is kept so a configuration can name a family the port does
not serve yet; the model and engine raise ``NotImplementedError`` for it.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads

    activation: str = "swiglu"        # swiglu | geglu | gelu
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_type: str = "standard"       # standard | none
    rope_theta: float = 1_000_000.0
    window: int | None = None         # sliding-window attention
    tie_embeddings: bool = False
    embed_scale: bool = False         # scale embeddings by sqrt(d)
    logit_softcap: float | None = None

    slstm_every: int = 0              # xLSTM: one sLSTM block in N (0: none)

    kv_quant: str = "none"            # none | int8 (per-token absmax scale)
    kv_layout: str = "slot"           # slot | paged
    kv_block_size: int = 16           # tokens per page (paged layout only)
    kv_pool_blocks: int = 0           # shared-pool blocks (0 = B * pages/slot)

    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.kv_layout not in ("slot", "paged"):
            raise ValueError(f"unknown kv_layout {self.kv_layout!r}")
        if self.kv_layout == "paged" and self.kv_block_size < 1:
            raise ValueError("kv_block_size must be >= 1 for paged layout")
