"""Qwen3-8B: 36 layers, d_model 4096, 32 query heads over 8 KV heads of
128, a per-head RMSNorm on q and k before RoPE (``qk_norm``), d_ff 12288,
RoPE theta 1e6, vocab 151936, bf16."""

import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b", family="dense",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=12288, vocab_size=151936, head_dim=128,
        activation="swiglu", norm="rmsnorm", qk_norm=True,
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab_size=256, head_dim=32,
        activation="swiglu", norm="rmsnorm", qk_norm=True,
        rope_theta=1e6, dtype=torch.float32, remat="none",
    )
