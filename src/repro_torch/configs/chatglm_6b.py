"""ChatGLM2-6B, the EdgeLLM paper's primary model (Table II, Fig. 11):
28 layers, d_model 4096, 32 query heads over 2 KV heads of 128 (multi-query
groups), d_ff 13696, vocab 65024, qkv bias, bf16."""

import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm-6b", family="dense",
        n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab_size=65024, head_dim=128,
        activation="swiglu", norm="rmsnorm", qkv_bias=True,
        rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chatglm-6b-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab_size=256, head_dim=32,
        activation="swiglu", norm="rmsnorm", qkv_bias=True,
        rope_theta=10000.0, dtype=torch.float32, remat="none",
    )
