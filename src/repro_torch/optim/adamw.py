"""AdamW over dict trees of tensors (port of ``repro/optim/adamw.py``).

The formulas are the reference's, one for one, in f32: global-norm
clipping, the two moments, bias correction, decoupled weight decay on
leaves with ``ndim >= 2`` (blocks are stacked on a leading layer axis, so a
stacked norm gamma ``(L, d)`` is decayed, as in the reference), and the
update of f32 master parameters.  The state is ``{"step", "m", "v"}``:
``step`` an int32 scalar, ``m`` and ``v`` f32 trees shaped like the
params, so that a checkpoint of ``{"opt": state}`` holds the reference's
``opt/step``, ``opt/m/...`` and ``opt/v/...`` leaves.

Unlike the reference's pure function, ``update`` writes the new moments
and parameters into the tensors it is given (each leaf's arithmetic is the
reference's, its result copied in), so a step holds one set of master
weights and moments, not two; ``step`` is replaced.  A caller that needs
the old values clones them first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.train.checkpoint import tree_paths


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    """``fn`` over the leaves of dict trees of one structure."""
    return {k: (tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def tree_leaves(tree: dict) -> list:
    """The leaves in the reference's order (dict keys sorted)."""
    return [leaf for _, leaf in tree_paths(tree)]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float | None = 1.0

    def init(self, params: dict) -> dict:
        leaf = tree_leaves(params)[0]
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=leaf.device),
                "m": tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params),
                "v": tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)}

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    def update(self, grads: dict, state: dict, params: dict):
        """Returns ``(params, state, metrics)``: the params and moments
        updated in place, ``state["step"]`` advanced, metrics
        ``{"grad_norm", "lr"}``.  Runs under a ``torch.profiler`` range
        named ``adamw``, so a traced step can tell the update's kernels
        from the loss's."""
        with torch.profiler.record_function("adamw"):
            return self._update(grads, state, params)

    def _update(self, grads: dict, state: dict, params: dict):
        f32 = torch.float32
        step = state["step"] + 1
        gnorm = global_norm(grads)
        scale = None
        if self.grad_clip is not None:
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** step.to(f32)
        bc2 = 1 - b2 ** step.to(f32)
        lr = self._lr(step)

        def upd(p, g, mm, vv):
            g = g.to(f32) if scale is None else g.to(f32) * scale
            mm.copy_(b1 * mm + (1 - b1) * g)
            vv.copy_(b2 * vv + (1 - b2) * torch.square(g))
            delta = (mm / bc1) / (torch.sqrt(vv / bc2) + self.eps)
            if self.weight_decay and p.dim() >= 2:     # decay matrices only
                delta = delta + self.weight_decay * p.to(f32)
            p.copy_((p.to(f32) - lr * delta).to(p.dtype))
            return p

        tree_map(upd, params, grads, state["m"], state["v"])
        state["step"] = step
        return params, state, {"grad_norm": gnorm, "lr": lr}


def global_norm(tree: dict) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree_leaves(tree)]
    return torch.sqrt(sum(leaves))


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor_frac + (1 - floor_frac) * 0.5 *
                      (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return lr
