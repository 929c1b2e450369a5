"""Training step: microbatched gradient accumulation + AdamW (port of
``repro/train/trainer.py``).

``make_train_step(cfg, opt, accum_steps)`` builds

    (params_f32, opt_state, batch, seed) -> (params, opt_state, metrics)

* params are f32 masters; the step casts them to ``cfg.dtype`` once (one
  cast a step, shared by the microbatches) and differentiates the loss
  with respect to that copy, so the gradients are in ``cfg.dtype``, as the
  reference's are;
* the global batch (G, S) is split into ``accum_steps`` microbatches of
  G / A rows, taken in order; their gradients accumulate in f32 and are
  divided by A, as are their losses;
* ``compress_grads`` models an int8 gradient exchange
  (``_grad_compress_int8``); ``opt.update`` then updates the masters and
  the moments (in place, ``optim/adamw.py``).

The reference's ``grad_specs`` (a sharding constraint per gradient) is
accepted as None only: sharded training waits for ROADMAP queue 1, item 7.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import api
from repro_torch.optim.adamw import AdamW, tree_leaves, tree_map
from repro_torch.train.checkpoint import tree_paths


def cast_tree(tree: dict, dtype: torch.dtype) -> dict:
    """Floating leaves cast to ``dtype`` (a leaf already of that dtype is
    returned as it is); the others kept."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def _grad_compress_int8(tree: dict, seed: int) -> dict:
    """Stochastic-rounding int8 quantize/dequantize of gradients, per leaf:
    ``q = clip(round(g / s + u), -127, 127) * s`` with ``s = (max|g| +
    1e-12) / 127`` and ``u`` uniform in [-0.5, 0.5), in f32.  The noise is
    drawn from a ``torch.Generator`` seeded with ``seed``, one draw a leaf
    in the reference's leaf order, so it is not the reference's
    ``jax.random`` draw: each value lies on its leaf's grid, within one
    step of ``g``, and the mean over seeds is ``g`` (the reference computes
    the scale in the gradient's dtype; here it is f32)."""
    paths = list(tree_paths(tree))
    gen = torch.Generator(device=paths[0][1].device).manual_seed(seed)
    out = {}
    for path, g in paths:
        g = g.to(torch.float32)
        scale = (g.abs().max() + 1e-12) / 127.0
        noise = torch.rand(g.shape, generator=gen, device=g.device,
                           dtype=torch.float32) - 0.5
        out[path] = torch.clamp(torch.round(g / scale + noise), -127,
                                127) * scale
    return _unflatten(out)


def compute_params(params: dict, dtype: torch.dtype) -> dict:
    """The masters cast to ``dtype`` as new leaves that require grad (the
    tree a step differentiates)."""
    return tree_map(lambda x: x.detach().requires_grad_(x.is_floating_point()),
                    cast_tree(params, dtype))


def loss_and_grads(cfg, compute: dict, batch: dict):
    """``(loss, metrics, grads)`` of ``api.loss_fn`` at ``compute`` (leaves
    that require grad): the loss with its aux term, detached, and the
    gradient of every leaf by its checkpoint path (dict keys joined by
    ``/``), in the leaves' dtype (zeros for a leaf the loss does not
    reach)."""
    paths = list(tree_paths(compute))
    loss, metrics = api.loss_fn(cfg, compute, batch)
    gs = torch.autograd.grad(loss, [t for _, t in paths], allow_unused=True)
    return loss.detach(), metrics, {
        path: torch.zeros_like(t) if g is None else g
        for (path, t), g in zip(paths, gs)}


def _microbatches(batch: dict, accum_steps: int) -> list[dict]:
    return [{k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                          *v.shape[1:])[a] for k, v in batch.items()}
            for a in range(accum_steps)]


def make_train_step(cfg, opt: AdamW, accum_steps: int = 1,
                    compress_grads: bool = False, grad_specs=None):
    """The train step of the module note.  ``batch`` holds ``tokens`` and
    ``labels`` (G, S) (and optionally ``mask``), G a multiple of
    ``accum_steps``; ``seed`` seeds the gradient compression's noise."""
    if grad_specs is not None:
        raise NotImplementedError(
            "grad_specs: sharded training is not ported (ROADMAP queue 1, "
            "item 7); pass None")

    def train_step(params: dict, opt_state: dict, batch: dict, seed: int = 0):
        compute = compute_params(params, cfg.dtype)
        if accum_steps == 1:
            _, metrics, flat = loss_and_grads(cfg, compute, batch)
        else:
            flat = None
            loss_sum = torch.zeros((), device=tree_leaves(compute)[0].device)
            for mb in _microbatches(batch, accum_steps):
                loss, _, g = loss_and_grads(cfg, compute, mb)
                if flat is None:
                    flat = {k: v.to(torch.float32) for k, v in g.items()}
                else:
                    for k, v in g.items():
                        flat[k] = flat[k] + v.to(torch.float32)
                loss_sum = loss_sum + loss
            flat = {k: v / accum_steps for k, v in flat.items()}
            metrics = {"loss": loss_sum / accum_steps,
                       "aux": torch.zeros((), device=loss_sum.device)}
        grads = _unflatten(flat)
        del compute
        if compress_grads:
            grads = _grad_compress_int8(grads, seed)
        params, opt_state, opt_metrics = opt.update(grads, opt_state, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def init_train_state(cfg, opt: AdamW, gen: torch.Generator):
    """f32 master params (``api.init_params`` of ``cfg`` in f32, from
    ``gen`` on ``gen.device``) and the optimizer's state."""
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params = api.init_params(cfg32, gen)
    return params, opt.init(params)
