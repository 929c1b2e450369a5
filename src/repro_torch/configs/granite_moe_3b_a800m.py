"""granite-moe-3b-a800m (family ``moe``): 32 layers, d_model 1536, 24 query
heads over 8 KV heads of 64, 40 experts of d_ff 512, top-8, vocab 49155,
tied embeddings, bf16."""

import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab_size=49155, head_dim=64,
        activation="swiglu", norm="rmsnorm",
        rope_theta=10000.0, tie_embeddings=True,
        n_experts=40, top_k=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab_size=256, head_dim=32,
        activation="swiglu", norm="rmsnorm",
        rope_theta=10000.0, tie_embeddings=True,
        n_experts=4, top_k=2, dtype=torch.float32, remat="none",
    )
