"""Qwen1.5-4B: 40 layers, d_model 2560, 20 query heads over 20 KV heads
of 128 (MHA), d_ff 6912, q/k/v biases, RoPE theta 1e6, vocab 151936,
bf16."""

import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b", family="dense",
        n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
        d_ff=6912, vocab_size=151936, head_dim=128,
        activation="swiglu", norm="rmsnorm", qkv_bias=True,
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=256, head_dim=32,
        activation="swiglu", norm="rmsnorm", qkv_bias=True,
        rope_theta=1e6, dtype=torch.float32, remat="none",
    )
