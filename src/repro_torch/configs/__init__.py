"""Architecture config registry of the port: ``qwen-7b``, ``chatglm-6b``
and ``starcoder2-7b`` (family ``dense``; starcoder2 brings LayerNorm and the
ungated gelu FFN with biases) and ``xlstm-1.3b`` (family ``ssm``).

``get_config(name)`` gives the full-size configuration and
``get_smoke_config(name)`` the reduced same-family one the CPU tests use;
both accept ``dataclasses.replace`` overrides as keyword arguments.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import chatglm_6b, qwen_7b, starcoder2_7b, xlstm_1_3b

_MODULES = {"qwen-7b": qwen_7b, "chatglm-6b": chatglm_6b,
            "starcoder2-7b": starcoder2_7b, "xlstm-1.3b": xlstm_1_3b}


def _module(name: str):
    try:
        return _MODULES[name]
    except KeyError:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (the port serves the dense "
            f"and ssm families: {sorted(_MODULES)})") from None


def get_config(name: str, **overrides):
    cfg = _module(name).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(name: str, **overrides):
    cfg = _module(name).smoke_config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg

