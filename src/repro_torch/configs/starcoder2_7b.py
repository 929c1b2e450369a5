"""StarCoder2-7B: 32 layers, d_model 4608, 36 query heads over 4 KV heads of
128, LayerNorm, an ungated tanh-gelu FFN (d_ff 18432) with up and down
biases, q/k/v biases, RoPE theta 1e5, vocab 49152, bf16."""

import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b", family="dense",
        n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
        d_ff=18432, vocab_size=49152, head_dim=128,
        activation="gelu", norm="layernorm", qkv_bias=True,
        rope_theta=1e5,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b-smoke", family="dense",
        n_layers=2, d_model=144, n_heads=4, n_kv_heads=2,
        d_ff=288, vocab_size=256, head_dim=36,
        activation="gelu", norm="layernorm", qkv_bias=True,
        rope_theta=1e5, dtype=torch.float32,
    )
