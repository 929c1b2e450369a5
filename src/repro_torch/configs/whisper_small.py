"""Whisper-small: an encoder of 12 layers over 1500 audio frames and a
decoder of 12 layers, d_model 768, 12 heads of 64, an ungated gelu FFN
(d_ff 3072) with biases, LayerNorm, sinusoidal positions (no RoPE), vocab
51865 with the LM head tied to the token embedding, bf16.  The conv
frontend is a stub: a request brings its frame embeddings (frames, d)."""

import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="audio",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab_size=51865, head_dim=64,
        activation="gelu", norm="layernorm", rope_type="none",
        n_encoder_layers=12, encoder_frames=1500,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-smoke", family="audio",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=256, head_dim=32,
        activation="gelu", norm="layernorm", rope_type="none",
        n_encoder_layers=2, encoder_frames=32,
        dtype=torch.float32, remat="none",
    )
