"""Gemma-2B: 18 layers, d_model 2048, 8 query heads over one KV head of
256 (MQA), the GeGLU FFN (d_ff 16384), embeddings scaled by sqrt(d_model)
and tied to the LM head, RoPE theta 1e4, vocab 256000, bf16."""

import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b", family="dense",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
        d_ff=16384, vocab_size=256000, head_dim=256,
        activation="geglu", norm="rmsnorm",
        rope_theta=10000.0, tie_embeddings=True, embed_scale=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=1,
        d_ff=256, vocab_size=256, head_dim=64,
        activation="geglu", norm="rmsnorm",
        rope_theta=10000.0, tie_embeddings=True, embed_scale=True,
        dtype=torch.float32, remat="none",
    )
