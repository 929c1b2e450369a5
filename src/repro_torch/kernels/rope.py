"""Rotary position embeddings: the plain ``apply_rope``, the multimodal
``apply_mrope`` and the cos/sin table the fused q/k/v epilogue
(``kv_write.qkv_rope_write_cuda``) reads.

The reference computes RoPE inline (``repro/models/layers.py:99-140``).
The table's row ``p`` holds ``cos`` and ``sin`` of ``float(p) * freq_i``,
made with ``apply_rope``'s own operations (``rope_freqs``, the f32 product,
``torch.cos`` / ``torch.sin``), so each entry is bitwise what ``apply_rope``
computes for position ``p`` on the same device.  The kernel does not compute
``cosf`` / ``sinf`` itself: the CUDA toolkit's math library need not round
as the one PyTorch was built with, and then the fused path would part from
the plain one.
"""

from __future__ import annotations

import torch

_tables: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """f32 angles (b, 1, s, head_dim / 2) of int positions (b, s)."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    return positions[:, None, :, None].to(torch.float32) * freqs


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (b, h, s, d) rotated by f32 ``angles`` (b, 1, s, d / 2): the
    halves' pairs (i, i + d/2), in f32, rounded back to x's dtype."""
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (b, h, s, d); positions (b, s) int.  Angles in f32 from the int
    positions, as the reference computes them."""
    return _rotate(x, rope_angles(positions, x.shape[-1], theta))


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): x (b, h, s, d); positions (3, b, s) int,
    the temporal, height and width ids.  The d/2 frequency slots are split
    into ``sections`` (summing to d/2); slot i of section j turns by stream
    j's position.  Each angle is ``float(p) * freq_i``, the product
    ``apply_rope`` takes, so with the three streams equal this is bitwise
    ``apply_rope`` of one of them (the serving steps' case)."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"half the head dim ({half})")
    freqs = rope_freqs(x.shape[-1], theta, positions.device)
    _, b, s = positions.shape
    # each slot's position, (b, s, half): stream j repeated over section j
    # (built from views, no index tensor, so nothing is copied to the card)
    pos = torch.cat([positions[j, :, :, None].expand(b, s, n)
                     for j, n in enumerate(sections)], dim=-1)
    return _rotate(x, pos[:, None].to(torch.float32) * freqs)


def rope_table(head_dim: int, theta: float, rows: int,
               device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (rows, head_dim / 2) f32, of positions 0 .. rows-1;
    built once per (head_dim, theta, rows, device) and kept.  ``rows``
    comes from host integers (a cache's logical span).
    Building it inside a CUDA graph capture would record it into the graph,
    so that raises: the first call comes before (an engine's warm-up)."""
    device = torch.device(device)
    key = (head_dim, float(theta), rows, device)
    table = _tables.get(key)
    if table is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the RoPE table {key} is built inside a CUDA graph capture: "
                "run the step once before capturing it")
        pos = torch.arange(rows, dtype=torch.int32, device=device)[None]
        angles = rope_angles(pos, head_dim, theta)[0, 0]
        table = (torch.cos(angles), torch.sin(angles))
        _tables[key] = table
    return table
