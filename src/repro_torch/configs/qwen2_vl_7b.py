"""Qwen2-VL-7B (family ``vlm``): the dense backbone of 28 layers, d_model
3584, 28 query heads over 4 KV heads of 128, d_ff 18944, vocab 152064, q/k/v
biases, and M-RoPE (sections 16, 24, 24 of the 64 frequency slots, theta
1e6).  The dynamic-resolution patch frontend is a stub, as in the reference:
``api.forward`` takes the patch embeddings (B, N, d) as ``vision_embeds``."""

import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab_size=152064, head_dim=128,
        activation="swiglu", norm="rmsnorm", qkv_bias=True,
        rope_type="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", family="vlm",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab_size=256, head_dim=32,
        activation="swiglu", norm="rmsnorm", qkv_bias=True,
        rope_type="mrope", mrope_sections=(4, 6, 6), rope_theta=1e6,
        dtype=torch.float32, remat="none",
    )
