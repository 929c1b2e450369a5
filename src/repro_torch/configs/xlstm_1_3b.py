"""xLSTM-1.3B (family ``ssm``): 48 residual blocks, d_model 2048, 4 heads,
one sLSTM block in every 8 (the xLSTM paper's 7:1 recipe), the rest mLSTM;
vocab 50304, bf16.  No attention and no KV cache: the recurrent state is
O(1) in the context length."""

import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304, head_dim=512,
        norm="rmsnorm", rope_type="none", slstm_every=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b-smoke", family="ssm",
        n_layers=4, d_model=128, n_heads=2, n_kv_heads=2,
        d_ff=0, vocab_size=256, head_dim=64,
        norm="rmsnorm", rope_type="none", slstm_every=2,
        dtype=torch.float32,
    )
