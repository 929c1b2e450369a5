"""Qwen-7B, the EdgeLLM paper's second model: 32 layers, d_model 4096,
32 query heads over 4 KV heads of 128, d_ff 11008, vocab 151936, bf16."""

import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen-7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
        d_ff=11008, vocab_size=151936, head_dim=128,
        activation="swiglu", norm="rmsnorm", qkv_bias=True,
        rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen-7b-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab_size=256, head_dim=32,
        activation="swiglu", norm="rmsnorm", qkv_bias=True,
        rope_theta=10000.0, dtype=torch.float32,
    )
