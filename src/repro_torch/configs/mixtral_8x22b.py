"""mixtral-8x22b (family ``moe``): 56 layers, d_model 6144, 48 query heads
over 8 KV heads of 128, 8 experts of d_ff 16384, top-2, vocab 32768, a
4096-token sliding window, bf16."""

import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=32768, head_dim=128,
        activation="swiglu", norm="rmsnorm",
        rope_theta=1e6, window=4096,
        n_experts=8, top_k=2,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab_size=256, head_dim=32,
        activation="swiglu", norm="rmsnorm",
        rope_theta=1e6, window=64,
        n_experts=4, top_k=2, dtype=torch.float32, remat="none",
    )
