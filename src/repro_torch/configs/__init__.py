"""Architecture config registry of the port: ``qwen-7b``, ``chatglm-6b``,
``starcoder2-7b``, ``qwen1.5-4b``, ``qwen3-8b`` and ``gemma-2b`` (family
``dense``; starcoder2 brings LayerNorm and the ungated gelu FFN with
biases, qwen3 the per-head q/k norm, gemma head dim 256, MQA, GeGLU and
scaled, tied embeddings), ``granite-moe-3b-a800m`` and
``mixtral-8x22b`` (family ``moe``), ``xlstm-1.3b`` (family ``ssm``),
``zamba2-7b`` (family ``hybrid``: a Mamba2 backbone with shared attention
blocks), ``whisper-small`` (family ``audio``: an encoder-decoder whose
requests bring audio frames) and ``qwen2-vl-7b`` (family ``vlm``: the dense
backbone with M-RoPE, its patch frontend a stub), every architecture of the
reference's registry.

``get_config(name)`` gives the full-size configuration and
``get_smoke_config(name)`` the reduced same-family one the CPU tests use;
both accept ``dataclasses.replace`` overrides as keyword arguments.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    chatglm_6b, gemma_2b, granite_moe_3b_a800m, mixtral_8x22b, qwen1_5_4b,
    qwen2_vl_7b, qwen3_8b, qwen_7b, starcoder2_7b, whisper_small, xlstm_1_3b,
    zamba2_7b)

_MODULES = {"qwen-7b": qwen_7b, "chatglm-6b": chatglm_6b,
            "starcoder2-7b": starcoder2_7b, "qwen1.5-4b": qwen1_5_4b,
            "qwen3-8b": qwen3_8b, "gemma-2b": gemma_2b,
            "granite-moe-3b-a800m": granite_moe_3b_a800m,
            "mixtral-8x22b": mixtral_8x22b, "xlstm-1.3b": xlstm_1_3b,
            "whisper-small": whisper_small, "zamba2-7b": zamba2_7b,
            "qwen2-vl-7b": qwen2_vl_7b}


def _module(name: str):
    try:
        return _MODULES[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r} (the port's: "
                         f"{sorted(_MODULES)})") from None


def get_config(name: str, **overrides):
    cfg = _module(name).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(name: str, **overrides):
    cfg = _module(name).smoke_config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg

