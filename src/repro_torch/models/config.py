"""Model configuration dataclass (the port's own copy, torch dtypes).

Mirrors ``repro/models/config.py`` for the fields the dense, MoE, xLSTM
(``ssm``), Zamba2 (``hybrid``), Whisper (``audio``) and Qwen2-VL (``vlm``:
the dense backbone with M-RoPE, its patch frontend a stub in both packages)
serving paths read, the slot and paged KV layouts and the int8 KV cache
included (the ``ssm`` family has no KV cache and ignores them), and the
training route's ``remat`` (``"block"``: each layer under
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``).  The
reference's other execution knobs (``scan_layers``, ``use_kernels``) have no
counterpart here.  A ``family`` the port does not know is refused
by the model and engine with ``NotImplementedError``.
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
    rope_type: str = "standard"       # standard | mrope | none
    rope_theta: float = 1_000_000.0
    # M-RoPE: the head's d/2 frequency slots split into sections, each
    # rotated by its own (temporal, height, width) position stream
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    window: int | None = None         # sliding-window attention
    tie_embeddings: bool = False
    embed_scale: bool = False         # scale embeddings by sqrt(d)
    logit_softcap: float | None = None

    # MoE: experts, experts a token takes, and the capacity factor of a
    # routing group (capacity = S * top_k / n_experts * factor tokens a
    # group an expert, at least top_k, at most S; the rest drop)
    n_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25

    # SSM: Mamba2 (hybrid) state width, head width, expansion and conv
    # taps; xLSTM's sLSTM cadence; Zamba2's shared attention blocks
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    slstm_every: int = 0              # xLSTM: one sLSTM block in N (0: none)
    shared_attn_every: int = 6        # Zamba2: a shared block every N layers
    n_shared_blocks: int = 2          # Zamba2: distinct shared blocks

    # Whisper: encoder depth and the audio frames a request brings
    n_encoder_layers: int = 0
    encoder_frames: int = 1500

    kv_quant: str = "none"            # none | int8 (per-token absmax scale)
    kv_layout: str = "slot"           # slot | paged
    kv_block_size: int = 16           # tokens per page (paged layout only)
    kv_pool_blocks: int = 0           # shared-pool blocks (0 = B * pages/slot)

    dtype: torch.dtype = torch.bfloat16
    remat: str = "block"              # none | block (the training route)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.kv_layout not in ("slot", "paged"):
            raise ValueError(f"unknown kv_layout {self.kv_layout!r}")
        if self.kv_layout == "paged" and self.kv_block_size < 1:
            raise ValueError("kv_block_size must be >= 1 for paged layout")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim
