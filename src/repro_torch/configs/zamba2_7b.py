"""Zamba2-7B (family ``hybrid``): 81 Mamba2 layers, d_model 3584 (inner
width 7168: 112 SSM heads of 64, state 64, a 4-tap causal conv), and after
every 6 of them one of 2 alternating weight-shared transformer blocks (32
heads of 112, SwiGLU with d_ff 14336): 13 shared-block sites, each with its
own K/V; vocab 32000, bf16 [arXiv:2411.15242]."""

import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab_size=32000, head_dim=112,
        activation="swiglu", norm="rmsnorm",
        rope_theta=10000.0,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
        shared_attn_every=6, n_shared_blocks=2,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=5, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=256, head_dim=32,
        activation="swiglu", norm="rmsnorm",
        rope_theta=10000.0,
        ssm_state=16, ssm_head_dim=32, ssm_expand=2, ssm_conv=4,
        shared_attn_every=2, n_shared_blocks=2,
        dtype=torch.float32, remat="none",
    )
