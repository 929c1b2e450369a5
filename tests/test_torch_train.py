"""The port's training surface against the JAX reference, on the CPU.

Inputs are made from a seed with numpy and handed to both packages; weights
come from ``jax.random`` through ``repro_torch.interop``.  Each case states
its tolerance:

* ``api.loss_fn`` with and without a mask, and its gradient for every leaf,
  against ``jax.value_and_grad`` of the reference's, at the six dense smoke
  configs (f32): within ``TOL`` = 1e-5 relative (a leaf's error against its
  largest value; f32 sums taken in another order);
* ``make_train_step`` with ``accum_steps`` 1 and 2, three steps: ``step``
  exact, ``m`` and ``v`` within ``TOL`` of each leaf's largest value, the
  params within ``TOL`` of theirs plus ``ADAM_PATH_TOL`` of the path the
  learning rate allows (``ADAM_PATH_TOL``'s note says why);
* remat ``"block"`` bitwise ``"none"``; ``AdamW.update``, ``global_norm``
  and ``cosine_schedule`` against the reference's (a stacked norm gamma
  decayed); the int8 gradient compression's grid, error and mean;
* ``SyntheticTokens`` bitwise, ``Prefetcher``'s order and close;
  checkpoints across the two packages bitwise, ``keep`` and
  ``latest_step``; ``run_resumable`` as the reference's own tests drive it;
* kernel 7's plain backward against ``jax.vjp`` of the reference's XLA
  attention (1e-5 relative) and autograd of the dense oracle in float64
  (1e-5), a row that sees no key given zero gradients; the plain RMSNorm
  backward against ``jax.vjp`` of ``layers.rmsnorm``;
* the rules of the training route: no grad, no autograd node and the
  serving path's output bitwise; the other families and the card's ops
  without a backward kernel refuse; the launcher.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import pipeline as jpipe
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.optim import adamw as jadamw
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtrainer

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticTokens
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import _build, flash_attention_bwd, ops, rmsnorm_bwd
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_torch
from repro_torch.launch import train as train_launcher
from repro_torch.models import api, transformer
from repro_torch.optim.adamw import AdamW, cosine_schedule, global_norm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import (
    PreemptionGuard, RestartPolicy, StragglerWatchdog, run_resumable)
from repro_torch.train.trainer import (
    _grad_compress_int8, cast_tree, init_train_state, make_train_step)

DENSE_ARCHS = ("qwen-7b", "qwen3-8b", "gemma-2b", "qwen1.5-4b",
               "chatglm-6b", "starcoder2-7b")
# f32 on the CPU: the two packages sum in other orders (measured: 2e-6)
TOL = 1e-5
# AdamW's step of an element is lr * m^ / (sqrt(v^) + eps), a ratio of the
# element's own moments, so it carries the element's RELATIVE gradient
# error, which grows as the element's gradient shrinks against the leaf's
# largest (where the moments agree within TOL of that largest value): the
# key bias's gradient is zero in exact arithmetic (a shift common to every
# key cancels in the softmax), and a few weights' gradients nearly cancel.
# Their steps may differ by a share of the learning-rate path sum(lr_t);
# measured at most 1.8 % over the six configs and both accumulations.
ADAM_PATH_TOL = 0.05


def _jflat(tree) -> dict:
    """A JAX tree's leaves by the checkpoint path (dict keys, attribute
    names joined by "/") as numpy arrays."""
    def part(k):
        return str(getattr(k, "key", getattr(k, "name", k)))
    return {"/".join(part(k) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree) -> dict:
    return {p: t.detach().numpy() for p, t in ckpt.tree_paths(tree)}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _batch(rng, vocab, b=2, s=16, mask=False) -> dict:
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        out["mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return out


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _requiring_grad(params):
    for _, t in ckpt.tree_paths(params):
        t.requires_grad_(True)
    return params


# -- the loss and its gradients ----------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["mean", "mask"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_loss_and_gradients_match_the_reference(arch, masked):
    jcfg = jax_smoke_config(arch)
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(np.random.default_rng(0), jcfg.vocab_size, mask=masked)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: japi.loss_fn(jcfg, p, _jbatch(batch)), has_aux=True)(jp)
    tp = _requiring_grad(params_from_numpy(jax.tree.map(np.asarray, jp),
                                           "cpu"))
    loss, m = api.loss_fn(get_smoke_config(arch), tp, _tbatch(batch))
    loss.backward()
    assert _rel(loss.detach(), jloss) <= TOL
    assert _rel(m["loss"].detach(), jm["loss"]) <= TOL
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    want = _jflat(jg)
    got = {p: t.grad.numpy() for p, t in ckpt.tree_paths(tp)}
    assert set(got) == set(want)
    bad = {p: _rel(got[p], want[p]) for p in want
           if not _rel(got[p], want[p]) <= TOL}
    assert not bad, bad


def test_remat_block_is_bitwise_remat_none():
    """Recomputing each layer in the backward changes no value."""
    cfg = get_smoke_config("qwen3-8b")
    grads = {}
    for remat in ("none", "block"):
        params = _requiring_grad(api.init_params(
            dataclasses.replace(cfg, remat=remat),
            torch.Generator().manual_seed(0)))
        batch = _tbatch(_batch(np.random.default_rng(1), cfg.vocab_size))
        loss, _ = api.loss_fn(dataclasses.replace(cfg, remat=remat), params,
                              batch)
        loss.backward()
        grads[remat] = (loss.detach(), {p: t.grad for p, t in
                                        ckpt.tree_paths(params)})
    assert torch.equal(grads["none"][0], grads["block"][0])
    for p, g in grads["none"][1].items():
        assert torch.equal(g, grads["block"][1][p]), p


def test_remat_block_recomputes_each_layer_in_the_backward(monkeypatch):
    """Under remat "block" each layer's forward runs twice (the forward,
    then the recompute inside the backward), under "none" once; ln_f is
    outside the checkpoint."""
    cfg = get_smoke_config("qwen-7b")
    for remat, calls in (("none", cfg.n_layers), ("block", 2 * cfg.n_layers)):
        seen = []
        real = transformer.block_apply
        monkeypatch.setattr(transformer, "block_apply", lambda *a: (
            seen.append(1), real(*a))[1])
        c = dataclasses.replace(cfg, remat=remat)
        params = _requiring_grad(api.init_params(
            c, torch.Generator().manual_seed(0)))
        loss, _ = api.loss_fn(c, params, _tbatch(_batch(
            np.random.default_rng(2), cfg.vocab_size)))
        loss.backward()
        assert len(seen) == calls, (remat, len(seen))
        monkeypatch.undo()


# -- the train step -------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_three_train_steps_match_the_reference(arch, accum):
    jcfg = jax_smoke_config(arch)
    jp = japi.init_params(dataclasses.replace(jcfg, dtype=jnp.float32),
                          jax.random.PRNGKey(1))
    p0 = _jflat(jp)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(3e-4, 2, 10))
    jstate = jopt.init(jp)
    jstep = jax.jit(jtrainer.make_train_step(jcfg, jopt, accum_steps=accum))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    opt = AdamW(lr=cosine_schedule(3e-4, 2, 10))
    tstate = opt.init(tp)
    step = make_train_step(get_smoke_config(arch), opt, accum_steps=accum)
    rng = np.random.default_rng(0)
    lr_path = 0.0
    for i in range(3):
        batch = _batch(rng, jcfg.vocab_size, b=4)
        jp, jstate, jm = jstep(jp, jstate, _jbatch(batch),
                               jax.random.PRNGKey(i))
        tp, tstate, tm = step(tp, tstate, _tbatch(batch), i)
        assert _rel(tm["loss"], jm["loss"]) <= TOL
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= TOL
        assert _rel(tm["lr"], jm["lr"]) <= TOL
        lr_path += float(jm["lr"])
    want = _jflat({"params": jp, "opt": jstate})
    got = _tflat({"params": tp, "opt": tstate})
    assert set(got) == set(want)
    assert int(got["opt/step"]) == int(want["opt/step"]) == 3
    assert got["opt/step"].dtype == want["opt/step"].dtype == np.int32
    bad = {}
    for path, w in want.items():
        g = got[path]
        if path.startswith("opt/"):
            ok = _rel(g, w) <= TOL
        else:
            err = np.abs(g.astype(np.float64) - w)
            ok = bool((err <= TOL * np.abs(w).max()
                       + ADAM_PATH_TOL * lr_path).all())
            # the params did move: the check is not vacuous
            assert np.abs(w - p0[path[len("params/"):]]).max() > 0, path
        if not ok:
            bad[path] = _rel(g, w)
    assert not bad, bad


def test_adamw_update_matches_the_reference_and_decays_stacked_gamma():
    """One update from given moments: a stacked norm gamma (L, d) is
    decayed, as in the reference, a (d,) leaf is not; clipping on."""
    rng = np.random.default_rng(3)
    shapes = {"blocks": {"gamma": (3, 8), "w": (3, 8, 16)}, "bias": (16,)}

    def tree(fn):
        return {"blocks": {k: fn(s) for k, s in shapes["blocks"].items()},
                "bias": fn(shapes["bias"])}
    p = tree(lambda s: rng.normal(size=s).astype(np.float32))
    g = tree(lambda s: (rng.normal(size=s) * 3).astype(np.float32))
    m = tree(lambda s: (rng.normal(size=s) * 0.1).astype(np.float32))
    v = tree(lambda s: rng.random(s).astype(np.float32))
    for lr in (1e-2, jadamw.cosine_schedule(1e-2, 3, 10)):
        jopt = jadamw.AdamW(lr=lr, weight_decay=0.5)
        jst = jadamw.AdamWState(jnp.int32(4), jax.tree.map(jnp.asarray, m),
                                jax.tree.map(jnp.asarray, v))
        jp, jst2, jmet = jopt.update(jax.tree.map(jnp.asarray, g), jst,
                                     jax.tree.map(jnp.asarray, p))
        topt = AdamW(lr=lr if not callable(lr) else cosine_schedule(
            1e-2, 3, 10), weight_decay=0.5)
        tst = {"step": torch.tensor(4, dtype=torch.int32),
               "m": params_from_numpy(m, "cpu"),
               "v": params_from_numpy(v, "cpu")}
        tp, tst2, tmet = topt.update(params_from_numpy(g, "cpu"), tst,
                                     params_from_numpy(p, "cpu"))
        for path, w in _jflat({"p": jp, "m": jst2.m, "v": jst2.v}).items():
            got = _tflat({"p": tp, "m": tst2["m"], "v": tst2["v"]})[path]
            assert _rel(got, w) <= 1e-6, path
        assert int(tst2["step"]) == int(jst2.step) == 5
        for k in ("grad_norm", "lr"):
            assert _rel(tmet[k], jmet[k]) <= 1e-6, k
    # the decay: with zero gradients and moments only the decay moves a
    # leaf, and only a leaf of ndim >= 2
    zero = tree(lambda s: np.zeros(s, np.float32))
    opt = AdamW(lr=0.1, weight_decay=0.5, grad_clip=None)
    tp = params_from_numpy(p, "cpu")
    st = {"step": torch.tensor(0, dtype=torch.int32),
          "m": params_from_numpy(zero, "cpu"),
          "v": params_from_numpy(zero, "cpu")}
    opt.update(params_from_numpy(zero, "cpu"), st, tp)
    np.testing.assert_allclose(tp["blocks"]["gamma"].numpy(),
                               p["blocks"]["gamma"] * (1 - 0.1 * 0.5),
                               rtol=1e-6)
    assert np.array_equal(tp["bias"].numpy(), p["bias"])


def test_global_norm_and_cosine_schedule_match_the_reference():
    rng = np.random.default_rng(4)
    tree = {"a": rng.normal(size=(5, 7)).astype(np.float32),
            "b": {"c": rng.normal(size=(11,)).astype(np.float32)}}
    assert _rel(global_norm(params_from_numpy(tree, "cpu")),
                jadamw.global_norm(jax.tree.map(jnp.asarray, tree))) <= 1e-6
    for warmup, total in ((20, 100), (0, 10), (5, 5)):
        jlr = jadamw.cosine_schedule(3e-4, warmup, total)
        tlr = cosine_schedule(3e-4, warmup, total)
        for step in (0, 1, warmup, warmup + 1, total // 2, total, total + 7):
            assert _rel(tlr(torch.tensor(step, dtype=torch.int32)),
                        jlr(jnp.int32(step))) <= 1e-6, (warmup, total, step)


def test_grad_compress_int8_grid_error_and_mean():
    """The reference's stochastic rounding draws its noise from
    ``jax.random``; the port's from a ``torch.Generator`` seeded from the
    step, so the draws differ.  Held instead: each value lies on the leaf's
    grid ``absmax / 127``, within one grid step of the gradient, a seed
    gives the same values twice, and the mean over 64 seeds is within 3
    sigma of the gradient (sigma <= step / 2 / sqrt(64) for a rounding
    error uniform on at most one step)."""
    rng = np.random.default_rng(5)
    g = {"w": torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32)),
         "b": {"c": torch.from_numpy(
             (rng.normal(size=(40,)) * 1e-3).astype(np.float32))}}
    outs = [_grad_compress_int8(g, seed) for seed in range(64)]
    for path, x in ckpt.tree_paths(g):
        step = (x.abs().max() + 1e-12) / 127.0
        vals = torch.stack([dict(ckpt.tree_paths(o))[path] for o in outs])
        q = vals / step
        assert torch.allclose(q, torch.round(q), atol=1e-4), path
        assert float((vals - x).abs().max()) <= float(step) * (1 + 1e-5)
        mean_err = (vals.mean(0) - x).abs()
        assert float(mean_err.max()) <= 3 * float(step) / 2 / math.sqrt(64)
    again = _grad_compress_int8(g, 7)
    for path, x in ckpt.tree_paths(outs[7]):
        assert torch.equal(x, dict(ckpt.tree_paths(again))[path])


def test_compressed_train_step_runs_and_moves_the_params():
    cfg = get_smoke_config("qwen-7b")
    opt = AdamW()
    params, state = init_train_state(cfg, opt, torch.Generator().manual_seed(0))
    before = {p: t.clone() for p, t in ckpt.tree_paths(params)}
    step = make_train_step(cfg, opt, compress_grads=True)
    params, state, metrics = step(params, state, _tbatch(_batch(
        np.random.default_rng(6), cfg.vocab_size)), 3)
    assert math.isfinite(float(metrics["loss"]))
    assert all(not torch.equal(before[p], t)
               for p, t in ckpt.tree_paths(params))


def test_train_step_refuses_grad_specs():
    with pytest.raises(NotImplementedError, match="item 7"):
        make_train_step(get_smoke_config("qwen-7b"), AdamW(),
                        grad_specs={"a": None})


def test_cast_tree_casts_floating_leaves_only():
    tree = {"w": torch.ones(2, dtype=torch.float32),
            "i": {"n": torch.ones(2, dtype=torch.int32)}}
    out = cast_tree(tree, torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16
    assert out["i"]["n"].dtype == torch.int32


# -- data ------------------------------------------------------------------------

@pytest.mark.parametrize("seed,vocab,seq,batch", [(0, 256, 16, 4),
                                                  (3, 151936, 64, 8)])
def test_synthetic_tokens_are_bitwise_the_reference(seed, vocab, seq, batch):
    tcfg = DataConfig(vocab, seq, batch, seed=seed)
    jcfg = jpipe.DataConfig(vocab, seq, batch, seed=seed)
    t, j = SyntheticTokens(tcfg), jpipe.SyntheticTokens(jcfg)
    for step in (0, 1, 17):
        got, want = t.batch(step), j.batch(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), (step, k)
        for host in range(2):
            got, want = t.host_slice(step, host, 2), j.host_slice(step,
                                                                  host, 2)
            assert all(np.array_equal(got[k], want[k]) for k in want)


def test_prefetcher_order_and_close():
    pf = Prefetcher(lambda s: {"s": np.array([s])}, start_step=5, depth=2)
    seen = [next(pf) for _ in range(4)]
    assert [s for s, _ in seen] == [5, 6, 7, 8]
    assert all(int(b["s"][0]) == s for s, b in seen)
    pf.close()
    assert not pf._thread.is_alive()


# -- checkpoints -------------------------------------------------------------------

def _train_state_pair(arch="qwen3-8b"):
    """The same ``{"params", "opt"}`` state in both packages (the reference
    with an AdamWState), after one reference step so the moments are
    nonzero."""
    jcfg = jax_smoke_config(arch)
    jopt = jadamw.AdamW()
    jp = japi.init_params(jcfg, jax.random.PRNGKey(2))
    jp, jst, _ = jax.jit(jtrainer.make_train_step(jcfg, jopt))(
        jp, jopt.init(jp), _jbatch(_batch(np.random.default_rng(7),
                                          jcfg.vocab_size)),
        jax.random.PRNGKey(0))
    jstate = {"params": jp, "opt": jst}
    flat = _jflat(jstate)
    tstate = {"params": params_from_numpy(jax.tree.map(np.asarray, jp),
                                          "cpu"),
              "opt": {"step": torch.from_numpy(flat["opt/step"].copy()),
                      "m": params_from_numpy(jax.tree.map(np.asarray, jst.m),
                                             "cpu"),
                      "v": params_from_numpy(jax.tree.map(np.asarray, jst.v),
                                             "cpu")}}
    return jstate, tstate


def test_checkpoints_restore_across_the_two_packages_bitwise(tmp_path):
    jstate, tstate = _train_state_pair()
    want = _jflat(jstate)
    assert set(_tflat(tstate)) == set(want)
    # written by the port, restored by the reference
    ckpt.save(str(tmp_path / "port"), 1, tstate, extra={"data_step": 1})
    got, extra = jckpt.restore(str(tmp_path / "port"), 1, jstate)
    assert extra == {"data_step": 1}
    for path, w in _jflat(got).items():
        assert w.dtype == want[path].dtype and np.array_equal(w, want[path])
    # written by the reference, restored by the port
    jckpt.save(str(tmp_path / "ref"), 1, jstate)
    assert ckpt.latest_step(str(tmp_path / "ref")) == 1
    like = {"params": tstate["params"], "opt": tstate["opt"]}
    got, _ = ckpt.restore(str(tmp_path / "ref"), 1, like)
    for path, t in ckpt.tree_paths(got):
        assert t.dtype == dict(ckpt.tree_paths(tstate))[path].dtype
        assert np.array_equal(t.numpy(), want[path]), path


def test_checkpoint_bf16_leaves_round_trip_bitwise(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = {"params": {"w": torch.randn(3, 5, generator=g).to(
        torch.bfloat16)}, "opt": {"step": torch.tensor(2, dtype=torch.int32)}}
    ckpt.save(str(tmp_path), 2, state)
    got, _ = ckpt.restore(str(tmp_path), 2, state)
    assert torch.equal(got["params"]["w"].view(torch.int16),
                       state["params"]["w"].view(torch.int16))
    assert got["params"]["w"].data_ptr() != state["params"]["w"].data_ptr()
    jgot, _ = jckpt.restore(str(tmp_path), 2, {
        "params": {"w": jnp.zeros((3, 5), jnp.bfloat16)},
        "opt": {"step": jnp.int32(0)}})
    assert np.array_equal(np.asarray(jgot["params"]["w"]).view(np.uint16),
                          state["params"]["w"].view(torch.int16).numpy()
                          .view(np.uint16))


def test_checkpoint_keep_and_latest_step(tmp_path):
    d = str(tmp_path / "ck")
    assert ckpt.latest_step(d) is None
    state = {"x": torch.zeros(())}
    for s in (1, 2, 3, 10, 11):
        ckpt.save(d, s, state, keep=3)
    assert ckpt.latest_step(d) == 11
    assert sorted(tmp_path.joinpath("ck").iterdir()) == [
        tmp_path / "ck" / f"step_{s:09d}" for s in (3, 10, 11)]
    with pytest.raises(ValueError, match="expected"):
        ckpt.restore(d, 11, {"x": torch.zeros((), dtype=torch.int32)})


# -- fault tolerance -----------------------------------------------------------------

class TestFaultTolerance:
    """``tests/test_substrate.py::TestFaultTolerance`` on the port."""

    def test_resume_replays_to_completion(self, tmp_path):
        calls = []

        def step_fn(state, step):
            calls.append(step)
            return {"x": state["x"] + 1}, {"loss": 0.0}

        def init():
            return {"x": torch.zeros(())}
        state, last, done = run_resumable(
            ckpt_dir=str(tmp_path), total_steps=7, init_state=init,
            step_fn=step_fn, ckpt_every=3)
        assert done and last == 7 and float(state["x"]) == 7
        calls.clear()
        state2, last2, done2 = run_resumable(
            ckpt_dir=str(tmp_path), total_steps=9, init_state=init,
            step_fn=step_fn, ckpt_every=3)
        assert done2 and last2 == 9 and float(state2["x"]) == 9
        assert calls[0] == 7                 # resumed, not restarted

    def test_preemption_checkpoints_and_exits(self, tmp_path):
        guard = PreemptionGuard(signals=())
        seen = []

        def step_fn(state, step):
            seen.append(step)
            if step == 2:
                guard.request()
            return {"x": state["x"] + 1}, {}

        state, last, done = run_resumable(
            ckpt_dir=str(tmp_path), total_steps=100,
            init_state=lambda: {"x": torch.zeros(())},
            step_fn=step_fn, ckpt_every=50, guard=guard)
        assert not done and last == 3 and seen == [0, 1, 2]
        assert ckpt.latest_step(str(tmp_path)) == 3

    def test_straggler_watchdog_escalates(self):
        wd = StragglerWatchdog(threshold=2.0, trip_limit=2, warmup_steps=2)
        hits = []
        for _ in range(5):
            wd.observe(1.0, on_escalate=lambda: hits.append(1))
        assert wd.incidents == 0
        wd.observe(5.0, on_escalate=lambda: hits.append(1))
        wd.observe(5.0, on_escalate=lambda: hits.append(1))
        assert wd.incidents == 2 and len(hits) == 1
        wd.observe(1.0, on_escalate=lambda: hits.append(1))
        wd.observe(5.0, on_escalate=lambda: hits.append(1))
        assert len(hits) == 1

    def test_restart_policy_budget(self):
        rp = RestartPolicy(max_restarts=2, window_s=100, base_backoff_s=1)
        assert rp.record_failure(now=0.0) == 1
        assert rp.record_failure(now=1.0) == 2
        assert rp.record_failure(now=2.0) is None
        assert rp.record_failure(now=200.0) is not None


def test_preempted_training_resumes_bitwise(tmp_path):
    """A real train step under ``run_resumable``: preempted after step 3
    and resumed to step 6, its params and optimizer state are bitwise an
    uninterrupted 6-step run's."""
    cfg = get_smoke_config("qwen3-8b")
    opt = AdamW(lr=cosine_schedule(3e-4, 2, 6))
    step = make_train_step(cfg, opt)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 16, 2))

    def init():
        p, s = init_train_state(cfg, opt, torch.Generator().manual_seed(0))
        return {"params": p, "opt": s}

    def step_fn(state, i):
        p, s, m = step(state["params"], state["opt"],
                       _tbatch(data.batch(i)), i)
        return {"params": p, "opt": s}, m

    whole, last, done = run_resumable(ckpt_dir=str(tmp_path / "a"),
                                      total_steps=6, init_state=init,
                                      step_fn=step_fn, ckpt_every=100)
    assert done and last == 6
    guard = PreemptionGuard(signals=())

    def preempting(state, i):
        if i == 2:
            guard.request()
        return step_fn(state, i)
    _, last, done = run_resumable(ckpt_dir=str(tmp_path / "b"),
                                  total_steps=6, init_state=init,
                                  step_fn=preempting, ckpt_every=100,
                                  guard=guard)
    assert not done and last == 3
    resumed, last, done = run_resumable(ckpt_dir=str(tmp_path / "b"),
                                        total_steps=6, init_state=init,
                                        step_fn=step_fn, ckpt_every=100)
    assert done and last == 6
    want = dict(ckpt.tree_paths(whole))
    for path, t in ckpt.tree_paths(resumed):
        assert torch.equal(t, want[path]), path


# -- kernel 7's backward and the RMSNorm backward (plain versions) ------------------

# name: (B, hq, hkv, Sq, Skv, d, causal, window)
ATTN_BWD_CASES = {
    "causal": (2, 4, 2, 96, 96, 32, True, None),
    "window": (1, 4, 2, 150, 150, 32, True, 40),
    "non-causal Sq != Skv": (2, 2, 2, 70, 130, 16, False, None),
    "rep 4": (1, 8, 2, 64, 64, 32, True, None),
    "ragged 300": (1, 2, 1, 300, 300, 16, True, None),
    "chunk ends the context": (1, 4, 2, 40, 200, 32, True, None),
    # 16 query heads over one KV head: the kernel's two dK/dV partials
    # split by the parity of head + query tile
    "rep 16": (1, 16, 1, 80, 80, 16, True, None),
    # past the kernel's 64-key tile and its 128-row dQ block (128 + 72)
    "ragged 200": (1, 2, 1, 200, 200, 16, True, None),
}


def _attn_inputs(case, seed=0):
    b, hq, hkv, sq, skv, d, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
             (b, hq, sq, d))]


def _plain_bwd(q, k, v, do, causal, window):
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash_attention_torch(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    return o, lse, flash_attention_bwd.flash_attention_bwd_torch(
        q, k, v, o, do, lse, causal=causal, window=window)


@pytest.mark.parametrize("name", list(ATTN_BWD_CASES))
def test_attention_backward_matches_jax_vjp(name):
    case = ATTN_BWD_CASES[name]
    causal, window = case[6], case[7]
    q, k, v, do = _attn_inputs(case)
    _, vjp = jax.vjp(lambda q, k, v: jops.attention(
        q, k, v, causal=causal, window=window, impl="xla"), q, k, v)
    want = vjp(jnp.asarray(do))
    _, _, got = _plain_bwd(q, k, v, do, causal, window)
    for g, w, what in zip(got, want, "qkv"):
        assert _rel(g.numpy(), w) <= TOL, (name, what, _rel(g.numpy(), w))


@pytest.mark.parametrize("name", list(ATTN_BWD_CASES))
def test_attention_backward_matches_the_float64_oracle(name):
    case = ATTN_BWD_CASES[name]
    causal, window = case[6], case[7]
    q, k, v, do = _attn_inputs(case, seed=1)
    t64 = [torch.from_numpy(a).double().requires_grad_(True)
           for a in (q, k, v)]
    out = tref.attention_ref(*t64, causal=causal, window=window)
    out.backward(torch.from_numpy(do).double())
    o, lse, got = _plain_bwd(q, k, v, do, causal, window)
    for g, t, what in zip(got, t64, "qkv"):
        assert _rel(g.numpy(), t.grad.numpy()) <= TOL, (name, what)
    # the log-sum-exp the backward reads: ln(sum_j exp(s_j * scale))
    b, hq, hkv, sq, skv, d = case[:6]
    s = torch.einsum("bhqd,bhkd->bhqk", t64[0].detach(),
                     t64[1].detach().repeat_interleave(hq // hkv, 1))
    q_pos = torch.arange(sq)[:, None] + (skv - sq)
    k_pos = torch.arange(skv)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= q_pos - k_pos < window
    want = torch.logsumexp(torch.where(mask, s / math.sqrt(d),
                                       -torch.inf), dim=-1)
    assert _rel(lse.numpy(), want.numpy()) <= TOL


def test_attention_backward_of_a_row_that_sees_no_key():
    """Causal with Sq > Skv: the first Sq - Skv rows see no key.  Their
    output and lse are 0 and +inf, their dq is 0, and they add nothing to
    dk and dv: the other rows' gradients are those of the rows alone."""
    case = (1, 4, 2, 96, 64, 32, True, None)
    q, k, v, do = _attn_inputs(case, seed=2)
    o, lse, (dq, dk, dv) = _plain_bwd(q, k, v, do, True, None)
    dead = 96 - 64
    assert torch.equal(o[:, :, :dead], torch.zeros_like(o[:, :, :dead]))
    assert bool(torch.isinf(lse[:, :, :dead]).all())
    assert torch.equal(dq[:, :, :dead], torch.zeros_like(dq[:, :, :dead]))
    _, _, (dq2, dk2, dv2) = _plain_bwd(q[:, :, dead:], k, v, do[:, :, dead:],
                                       True, None)
    assert _rel(dq[:, :, dead:].numpy(), dq2.numpy()) <= TOL
    assert _rel(dk.numpy(), dk2.numpy()) <= TOL
    assert _rel(dv.numpy(), dv2.numpy()) <= TOL


def test_ops_attention_under_autograd_is_the_plain_pair():
    """On the CPU ``ops.attention`` under grad runs the plain forward with
    its lse and the plain backward; ``impl="ref"`` differentiates the
    oracle; both agree."""
    case = ATTN_BWD_CASES["window"]
    q, k, v, do = _attn_inputs(case, seed=3)
    grads = {}
    for impl in ("auto", "ref"):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out = ops.attention(*ts, causal=True, window=case[7], impl=impl)
        assert out.grad_fn is not None
        out.backward(torch.from_numpy(do))
        grads[impl] = [t.grad for t in ts]
    _, _, want = _plain_bwd(q, k, v, do, True, case[7])
    for g, w in zip(grads["auto"], want):
        assert torch.equal(g, w)
    for g, w in zip(grads["auto"], grads["ref"]):
        assert _rel(g.numpy(), w.numpy()) <= TOL


@pytest.mark.parametrize("shape", [(2, 7, 128), (3, 2, 5, 32), (4, 48)])
def test_rmsnorm_backward_matches_jax_vjp(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    gamma = (1 + 0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    _, vjp = jax.vjp(jlayers.rmsnorm, jnp.asarray(x), jnp.asarray(gamma))
    wdx, wdg = vjp(jnp.asarray(dy))
    dx, dg = rmsnorm_bwd.rmsnorm_bwd_torch(*(torch.from_numpy(a) for a in
                                             (x, gamma, dy)))
    assert dg.dtype == torch.float32
    assert _rel(dx.numpy(), wdx) <= TOL and _rel(dg.numpy(), wdg) <= TOL
    # ops.rmsnorm under autograd: the plain forward, this backward
    xt = torch.from_numpy(x).requires_grad_(True)
    gt = torch.from_numpy(gamma).requires_grad_(True)
    ops.rmsnorm(xt, gt).backward(torch.from_numpy(dy))
    assert torch.equal(xt.grad, dx) and torch.equal(gt.grad, dg)


def test_rmsnorm_backward_plan_and_widths():
    assert rmsnorm_bwd.widths(torch.bfloat16)[-3:] == (2048, 4096, 8192)
    assert 128 in rmsnorm_bwd.widths(torch.bfloat16)
    assert 4096 in rmsnorm_bwd.widths(torch.float32)
    for rows, d, dtype in ((2048, 4096, torch.bfloat16),
                           (2048 * 32, 128, torch.bfloat16),
                           (5, 32, torch.bfloat16), (300, 4096,
                                                     torch.float32)):
        per, blocks = rmsnorm_bwd.plan(rows, d, dtype)
        v = 16 // torch.empty((), dtype=dtype).element_size()
        group = rmsnorm_bwd.THREADS // min(rmsnorm_bwd.THREADS, d // v)
        assert per % group == 0 and blocks == -(-rows // per)
        # one wave (the launch is cooperative): two blocks an SM, one where
        # a thread holds 4 chunks, on the card's SM count
        target = rmsnorm_bwd.target_blocks(d, dtype)
        assert target == (rmsnorm_bwd.SMS if d // v > 2 * rmsnorm_bwd.THREADS
                          else 2 * rmsnorm_bwd.SMS)
        assert blocks <= target and (blocks - 1) * per < rows
        per, blocks = rmsnorm_bwd.plan(rows, d, dtype, sms=114)
        assert per % group == 0 and blocks == -(-rows // per)
        assert blocks <= rmsnorm_bwd.target_blocks(d, dtype, 114)
        # the yardstick's plan: two blocks an SM at every width
        per, blocks = rmsnorm_bwd.plan(rows, d, dtype,
                                       rmsnorm_bwd.SERIAL_TARGET_BLOCKS)
        assert per % group == 0 and blocks == -(-rows // per)
        assert blocks <= 2 * rmsnorm_bwd.SMS and (blocks - 1) * per < rows
    sms = rmsnorm_bwd.SMS
    assert rmsnorm_bwd.target_blocks(8192, torch.bfloat16) == sms
    assert rmsnorm_bwd.target_blocks(4096, torch.bfloat16) == 2 * sms


# -- the training route's rules -----------------------------------------------------

def test_no_grad_builds_no_node_and_keeps_the_serving_output():
    cfg = get_smoke_config("qwen3-8b")
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _tbatch(_batch(np.random.default_rng(8), cfg.vocab_size))
    served, _ = api.forward(cfg, params, batch)
    assert served.grad_fn is None
    # the same call under no_grad with parameters that require grad takes
    # the serving route: bitwise the same
    with torch.no_grad():
        again, _ = api.forward(cfg, _requiring_grad(params), batch)
    assert again.grad_fn is None and torch.equal(served, again)
    # and the ops alone: no node, the plain forward's output
    q, k, v, _ = _attn_inputs(ATTN_BWD_CASES["causal"])
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    out = ops.attention(q, k, v)
    assert out.grad_fn is None and torch.equal(
        out, flash_attention_torch(q, k, v))
    x, g = torch.randn(3, 32), torch.ones(32)
    assert ops.rmsnorm(x, g).grad_fn is None
    # with grad the training route's logits are the serving route's (the
    # CPU's plain versions, summed in the same order)
    logits, _ = api.forward(cfg, params, batch)
    assert logits.grad_fn is not None
    np.testing.assert_allclose(logits.detach().numpy(), served.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-vl-7b",
                                  "xlstm-1.3b", "zamba2-7b",
                                  "whisper-small"])
def test_other_families_refuse_to_train(arch):
    cfg = get_smoke_config(arch)
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _tbatch(_batch(np.random.default_rng(9), cfg.vocab_size))
    with pytest.raises(NotImplementedError, match="item 6a"):
        api.loss_fn(cfg, params, batch)


def test_moe_forward_under_grad_refuses():
    cfg = get_smoke_config("granite-moe-3b-a800m")
    params = _requiring_grad(api.init_params(
        cfg, torch.Generator().manual_seed(0)))
    with pytest.raises(NotImplementedError, match="item 6a"):
        api.forward(cfg, params, _tbatch(_batch(np.random.default_rng(9),
                                                cfg.vocab_size)))


def test_card_refusals_are_checked_before_the_device():
    """What the card's training route refuses raises on CPU tensors too,
    before any launch: kernel 7's backward at float32 and head dims 112 and
    256, the RMSNorm backward (and its training forward) at a width it is
    not instantiated at, a layernorm under grad on the card's dispatch."""
    for dtype, d in ((torch.float32, 128), (torch.bfloat16, 112),
                     (torch.bfloat16, 256)):
        q = torch.zeros(1, 2, 4, d, dtype=dtype)
        with pytest.raises(ValueError, match="head dims"):
            flash_attention_bwd.check_supported(q)
        with pytest.raises(ValueError, match="head dims"):
            flash_attention_bwd.flash_attention_bwd_cuda(
                q, q, q, q, q, torch.zeros(1, 2, 4))
        with pytest.raises(ValueError, match="head dims"):
            flash_attention_bwd.flash_attention_bwd_sync_cuda(
                q, q, q, q, q, torch.zeros(1, 2, 4))
        with pytest.raises(ValueError, match="head dims"):
            ops.attention(q.requires_grad_(True), q, q, impl="cuda")
    for d in (64, 128):
        flash_attention_bwd.check_supported(torch.zeros(1, 1, 1, d,
                                                        dtype=torch.bfloat16))
    x = torch.zeros(4, 2560, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="width 2560"):
        rmsnorm_bwd.rmsnorm_bwd_cuda(x, x[0], x)
    with pytest.raises(ValueError, match="width 2560"):
        rmsnorm_bwd.rmsnorm_bwd_serial_cuda(x, x[0], x)
    with pytest.raises(ValueError, match="width 2560"):
        ops.rmsnorm(x.requires_grad_(True), x[0].detach(), impl="cuda")
    x = torch.zeros(4, 64, requires_grad=True)
    with pytest.raises(NotImplementedError, match="layernorm"):
        ops.layernorm(x, torch.ones(64), torch.zeros(64), impl="cuda")
    for name in ("flash_attention_bwd", "rmsnorm_bwd",
                 "flash_attention_bwd_sync", "rmsnorm_bwd_serial"):
        assert name in _build.KERNEL_SOURCES


def test_launcher_trains_the_smoke_config_on_the_cpu(tmp_path, capsys):
    train_launcher.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "16", "--ckpt-every", "2",
                         "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert "arch=qwen3-8b-smoke" in out and "dtype=float32" in out
    assert ckpt.latest_step(str(tmp_path)) == 2
    # a rerun resumes from the checkpoint of step 2
    train_launcher.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "16", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert [line.split()[1] for line in out.splitlines()
            if line.startswith("step ")] == ["2"]


def test_launcher_refuses_model_parallel_and_a_missing_card(monkeypatch):
    with pytest.raises(SystemExit, match="model-parallel 2"):
        train_launcher.main(["--device", "cpu", "--model-parallel", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        train_launcher.main(["--steps", "1"])
