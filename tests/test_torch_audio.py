"""The audio family (whisper-small) in the port against the JAX reference,
on the CPU.

The smoke config (2 encoder and 2 decoder layers, d 128, 32 frames) and
"dense" weights come from the reference (``quantize_model``), carried over
by ``interop``; the JAX side runs without Pallas kernels
(``use_kernels=False``, the smoke config's default).  Inputs are seeded
numpy arrays.

* Configs: full and smoke, field for field the reference's.
* The sinusoid table: the frequencies within one ulp of the reference's
  (XLA's f32 ``exp`` and PyTorch's differ in the last bit for some), so
  each row within 1e-6 plus what that ulp makes of its angle, ``2 p
  2^-23``; every route's rows bitwise one table's.
* ``encode``, ``cross_kv``, ``cross_attn_apply``, ``forward``, ``prefill``
  and ``request_cache``: logits and every cache leaf within 1e-4
  (``MODEL_TOL``); ``mixed_step`` at W = 8 (idle rows included) and
  ``decode_step`` on the slot cache and the paged pool, likewise (a paged
  pool's null block aside: the reference writes dead rows there, the port
  skips them).
* The port's own mixed step is bitwise its sequential decode, cross leaves
  included (the reference's ``tests/test_mixed.py[whisper-small]`` is red
  and stays so).
* The engine: token streams equal to the JAX engine's and to the port's
  ``reference_decode`` on a slot cache, a paged pool and with speculation,
  slots reused; while serving, every live slot's cross K/V is bitwise its
  own request's; misses within ``compile_budget``, the ``("admit", F)``
  key counted.
* ``quantize_model`` leaves bitwise the reference's; the card's dispatch
  (``ops._resolve`` patched to "cuda") takes cross-attention to kernel 7's
  wrapper; the refusals (frames, durable audio, the launcher).

    PYTHONPATH=src python -m pytest tests/test_torch_audio.py -q
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.compiler import quantize_model as jax_quantize  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.compiler import quantize_model  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api, attention, whisper  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    Engine, Request, reference_decode)

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "whisper-small"
LAYOUTS = {"slot": {}, "paged": dict(kv_layout="paged", kv_block_size=8)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path issues many ops on tiny tensors; under the
    parallel suite intra-op threads wait for each other far longer than the
    work takes, so these tests run the port on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CACHE = {}


def _models(layout="slot"):
    """(jax cfg, jax params, port cfg, port params): the reference's smoke
    weights quantized "dense", the same bits in both packages."""
    if "params" not in _CACHE:
        jcfg = jax_smoke_config(ARCH)
        jparams = jax_quantize(japi.init_params(jcfg, jax.random.PRNGKey(0)),
                               "dense")
        _CACHE["params"] = (jparams, interop.params_from_numpy(
            jax.tree.map(np.asarray, jparams), "cpu"))
    jparams, tparams = _CACHE["params"]
    over = LAYOUTS[layout]
    return (jax_smoke_config(ARCH, **over), jparams,
            get_smoke_config(ARCH, **over), tparams)


def _frames(cfg, n, seed):
    return np.random.default_rng(seed).normal(
        size=(n, cfg.encoder_frames, cfg.d_model)).astype(np.float32)


def _assert_close(got, want, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, **MODEL_TOL, err_msg=what)


def _assert_cache_close(tcache, jcache, paged=False):
    """Every leaf within 1e-4; a paged pool's null block (its last) aside:
    the reference routes dead rows' writes there, the port skips them."""
    assert sorted(tcache) == sorted(jcache)
    for group in tcache:
        for name, leaf in tcache[group].items():
            want = np.asarray(jcache[group][name])
            got = leaf.numpy()
            if paged and group == "self":
                got, want = got[:, :-1], want[:, :-1]
            _assert_close(got, want, f"{group}/{name}")


def _tree_equal(a, b):
    return all(torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
               else _tree_equal(a[k], b[k]) for k in a)


# -- configs and the sinusoid table -------------------------------------------

def test_configs_mirror_reference():
    for full in (True, False):
        want = (jax_config if full else jax_smoke_config)(ARCH)
        got = (get_config if full else get_smoke_config)(ARCH)
        for f in dataclasses.fields(got):
            if f.name == "dtype":
                assert str(got.dtype).split(".")[1] == jnp.dtype(
                    want.dtype).name
            else:
                assert getattr(got, f.name) == getattr(want, f.name), f.name
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.n_encoder_layers, cfg.encoder_frames,
            cfg.rope_type) == ("audio", 12, 1500, "none")
    # every W4A16 width is whole 128-row groups (kernels 1 and 2g)
    assert all(w % 128 == 0 for w in (cfg.d_model, cfg.d_ff,
                                      cfg.n_heads * cfg.head_dim))


@pytest.mark.parametrize("rows,d", [(32, 128), (1500, 768)])
def test_sinusoid_table_matches_reference(rows, d):
    table = whisper.sinusoid_table(rows, d, "cpu")
    assert table.dtype == torch.float32 and table.shape == (rows, d)
    want = np.asarray(jwhisper._sinusoid(jnp.arange(rows)[None], d,
                                         jnp.float32))[0]
    p = np.arange(rows, dtype=np.float64)[:, None]
    err = np.abs(table.numpy().astype(np.float64) - want)
    assert (err <= 1e-6 + 2 * p * 2.0 ** -23).all(), err.max()
    assert float(err[:2].max()) <= 1e-6
    # one function of the position: a shorter table is the longer's head,
    # bitwise; the table is built once per (rows, d, device)
    assert torch.equal(whisper.sinusoid_table(7, d, "cpu"), table[:7])
    assert whisper.sinusoid_table(rows, d, "cpu") is table


def test_sinusoid_frequencies_within_one_ulp_of_reference():
    for d in (64, 128, 768):
        half = d // 2
        jfreq = np.asarray(jnp.exp(
            -jnp.log(10000.0) * jnp.arange(half, dtype=jnp.float32) / half))
        got = torch.exp(-torch.log(torch.tensor(10000.0))
                        * torch.arange(half, dtype=torch.float32)
                        / half).numpy()
        np.testing.assert_array_max_ulp(got, jfreq, maxulp=1)


# -- the model ----------------------------------------------------------------

def test_encoder_and_cross_attention_match_reference():
    jcfg, jparams, tcfg, tparams = _models()
    fr = _frames(jcfg, 2, 0)
    jenc = jwhisper.encode(jcfg, jparams, jnp.asarray(fr))
    tenc = whisper.encode(tcfg, tparams, torch.from_numpy(fr))
    _assert_close(tenc, jenc, "encode")
    x = np.random.default_rng(3).normal(size=(2, 5, jcfg.d_model)).astype(
        np.float32)
    for i in range(jcfg.n_layers):
        jp = jax.tree.map(lambda a: a[i], jparams["dec_blocks"])["cross_attn"]
        tp = layer_params(tparams["dec_blocks"], i)["cross_attn"]
        jkv = jattn.cross_kv(jcfg, jp, jenc)
        tkv = attention.cross_kv(tcfg, tp, tenc)
        for got, want in zip(tkv, jkv):
            _assert_close(got, want, f"cross_kv layer {i}")
        _assert_close(attention.cross_attn_apply(tcfg, tp, torch.from_numpy(x),
                                                 tkv),
                      jattn.cross_attn_apply(jcfg, jp, jnp.asarray(x), jkv),
                      f"cross_attn_apply layer {i}")


def test_forward_prefill_and_request_cache_match_reference():
    jcfg, jparams, tcfg, tparams = _models()
    fr = _frames(jcfg, 2, 1)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "frames": torch.from_numpy(fr)}
    jl, _ = japi.forward(jcfg, jparams, jb)
    tl, taux = api.forward(tcfg, tparams, tb)
    assert tl.shape == (2, 11, jcfg.vocab_size) and float(taux) == 0.0
    _assert_close(tl, jl, "forward")
    jl, jcache = japi.prefill(jcfg, jparams, jb, 32)
    tl, tcache = api.prefill(tcfg, tparams, tb, 32)
    _assert_close(tl, jl, "prefill")
    _assert_cache_close(tcache, jcache)
    jrow = japi.request_cache(jcfg, jparams, {"frames": jb["frames"][:1]}, 32)
    trow = api.request_cache(tcfg, tparams, {"frames": tb["frames"][:1]}, 32,
                             "cpu")
    _assert_cache_close(trow, jrow)
    # the prefill's cross K/V are the request cache's
    assert torch.equal(tcache["cross"]["k"][:, :1], trow["cross"]["k"])
    assert not trow["self"]["k"].any()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_steps_match_reference(layout):
    """From a request cache of two rows' audio: W = 8 mixed steps (idle
    rows included), then a decode step; logits and every leaf within
    1e-4."""
    jcfg, jparams, tcfg, tparams = _models(layout)
    paged = layout == "paged"
    rng = np.random.default_rng(1)
    b, c, max_len = 2, 8, 32
    fr = _frames(jcfg, b, 2)
    jcache = japi.request_cache(jcfg, jparams, {"frames": jnp.asarray(fr)},
                                max_len)
    tcache = api.request_cache(tcfg, tparams,
                               {"frames": torch.from_numpy(fr)}, max_len,
                               "cpu")
    for lengths, q_lens in [([0, 0], [8, 5]), ([8, 5], [3, 8]),
                            ([11, 13], [0, 2])]:
        toks = rng.integers(0, jcfg.vocab_size, (b, c)).astype(np.int32)
        jl, jcache = japi.mixed_step(jcfg, jparams, jcache, jnp.asarray(toks),
                                     jnp.asarray(lengths, jnp.int32),
                                     jnp.asarray(q_lens, jnp.int32))
        tl, tcache = api.mixed_step(tcfg, tparams, tcache, _t(toks), lengths,
                                    q_lens)
        _assert_close(tl, jl, f"mixed {lengths} {q_lens}")
    _assert_cache_close(tcache, jcache, paged)
    toks = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    jl, jcache = japi.decode_step(jcfg, jparams, jcache, jnp.asarray(toks),
                                  jnp.asarray([12, 16], jnp.int32))
    tl, tcache = api.decode_step(tcfg, tparams, tcache, _t(toks), [12, 16])
    _assert_close(tl, jl, "decode")
    _assert_cache_close(tcache, jcache, paged)


def _t(a):
    return torch.from_numpy(np.array(a)).long()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mixed_step_is_bitwise_sequential_decode(layout):
    """A 13-token prompt in 8-token mixed chunks against 13 decode steps,
    from one request cache: logits and every leaf (the cross K/V
    included) bitwise equal; ``all_logits`` at W = 8 gives each position
    the logits of its own decode step."""
    _, _, tcfg, tparams = _models(layout)
    fr = {"frames": torch.from_numpy(_frames(tcfg, 1, 5))}
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab_size, 13)
    seq = api.request_cache(tcfg, tparams, fr, 32, "cpu")
    steps = []
    for t, tok in enumerate(prompt.tolist()):
        want, seq = api.decode_step(tcfg, tparams, seq, _t([[tok]]), [t + 1])
        steps.append(want)
    mix = api.request_cache(tcfg, tparams, fr, 32, "cpu")
    length = 0
    while length < len(prompt):
        ql = min(8, len(prompt) - length)
        chunk = np.zeros(8, np.int64)
        chunk[:ql] = prompt[length:length + ql]
        got, mix = api.mixed_step(tcfg, tparams, mix, _t(chunk[None]),
                                  [length], [ql])
        length += ql
    assert torch.equal(got, want)
    assert _tree_equal(seq, mix)
    ver = api.request_cache(tcfg, tparams, fr, 32, "cpu")
    every, _ = api.mixed_step(tcfg, tparams, ver, _t(prompt[None, :8]), [0],
                              [8], all_logits=True)
    for j in range(8):
        assert torch.equal(every[0, j], steps[j][0]), j


# -- the engine ---------------------------------------------------------------

def _work(cfg, n=5, seed=11):
    """(rid, prompt, max_new, frames): prompts of different lengths, so
    slots free at different ticks and later requests reuse them."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, cfg.vocab_size,
                             int(rng.integers(3, 14))).astype(np.int32),
             int(rng.integers(2, 8)), _frames(cfg, 1, 100 + i)[0])
            for i in range(n)]


@pytest.mark.parametrize("layout,spec_k", [("slot", 0), ("paged", 0),
                                           ("slot", 4)],
                         ids=["slot", "paged", "spec"])
def test_engine_streams_equal_jax_engine_and_oracle(layout, spec_k):
    """Batch 2, five requests, slots reused: the port's streams equal the
    JAX engine's and the port's ``reference_decode`` with each request's
    frames.  Ticked one at a time: every live slot's cross K/V is bitwise
    the request cache of its own request's frames (a reused slot never
    attends the previous occupant's audio).  Misses stay within
    ``compile_budget``, which counts the one ``("admit", F)`` key."""
    jcfg, jparams, tcfg, tparams = _models(layout)
    kw = dict(batch_size=2, max_len=40, chunk_size=6, spec_k=spec_k)
    work = _work(tcfg)
    jengine = JaxEngine(jcfg, jparams, **kw)
    jreqs = [JaxRequest(rid=r, prompt=p, max_new_tokens=m, frames=f)
             for r, p, m, f in work]
    for r in jreqs:
        jengine.submit(r)
    jengine.run()
    engine = Engine(tcfg, tparams, audit_every=1, device="cpu", **kw)
    reqs = [Request(rid=r, prompt=p, max_new_tokens=m, frames=f)
            for r, p, m, f in work]
    rows = {r.rid: api.request_cache(
        tcfg, tparams, {"frames": torch.from_numpy(r.frames[None])}, 40,
        "cpu")["cross"] for r in reqs}
    for r in reqs:
        engine.submit(r)
    owners = set()
    while not all(r.done for r in reqs):
        with warnings.catch_warnings():      # each call stops at one tick
            warnings.simplefilter("ignore", RuntimeWarning)
            engine.run(max_steps=1)
        for i, s in enumerate(engine._slots):
            if s.req is not None:
                owners.add((i, s.req.rid))
                for n in ("k", "v"):
                    assert torch.equal(engine.cache["cross"][n][:, i],
                                       rows[s.req.rid][n][:, 0]), (i, n)
    assert len({i for i, _ in owners}) < len(owners)   # slots were reused
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    for r in reqs:
        assert r.output == reference_decode(
            tcfg, tparams, r.prompt, r.max_new_tokens, max_len=40,
            frames=r.frames, device="cpu"), r.rid
    keys = engine.cache_compiles.keys()
    assert ("admit", tcfg.encoder_frames) in keys
    assert engine.cache_compiles.misses <= engine.compile_budget
    assert engine.compile_budget == (len(engine.chunk_buckets.all_buckets())
                                     + 3)
    if spec_k:
        assert engine.spec_drafted > 0 and engine.spec_ticks > 0
    if engine.paged:
        stats = engine.pool_stats()
        assert stats["free"] == stats["total"] and not stats["leased"]
    assert not engine.prefix_sharing


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_export_and_load_carry_the_cross_leaves(layout):
    """``api.export_cache`` copies every leaf to the host, the cross K/V
    included, and ``api.load_cache_`` writes them back in place, bitwise,
    into the same tensors (a captured graph keeps reading them)."""
    from repro_torch.train.checkpoint import tree_paths
    _, _, tcfg, tparams = _models(layout)
    cache = api.request_cache(tcfg, tparams, {"frames": torch.from_numpy(
        _frames(tcfg, 2, 4))}, 16, "cpu")
    host = api.export_cache(tcfg, cache)
    assert {p for p, _ in tree_paths(host)} == {
        "cross/k", "cross/v", "self/k", "self/v"}
    fresh = api.init_cache(tcfg, 2, 16, "cpu")
    leaves = [leaf for _, leaf in tree_paths(fresh)]
    api.load_cache_(tcfg, fresh, {p: a.numpy() for p, a in tree_paths(host)})
    assert _tree_equal(fresh, cache)
    assert all(a is b for a, (_, b) in zip(leaves, tree_paths(fresh)))


def test_distinct_audio_gives_distinct_cross_rows():
    """Two requests' frames give two different admission rows, and the
    decode logits of one prompt differ between them: a slot that kept the
    previous request's audio would show."""
    _, _, tcfg, tparams = _models()
    a, b = (api.request_cache(tcfg, tparams,
                              {"frames": torch.from_numpy(
                                  _frames(tcfg, 1, s))}, 16, "cpu")
            for s in (1, 2))
    assert not torch.equal(a["cross"]["k"], b["cross"]["k"])
    la, _ = api.decode_step(tcfg, tparams, a, _t([[7]]), [1])
    lb, _ = api.decode_step(tcfg, tparams, b, _t([[7]]), [1])
    assert float((la - lb).abs().max()) > 1e-3


def test_engine_refuses_what_audio_does_not_take(tmp_path):
    """Frames missing or of another shape are refused at ``submit``; an
    audio engine with a ``snapshot_dir`` (snapshots and a journal) at
    construction, before anything is written; a snapshot carrying frames
    at restore (``tests/test_torch_snapshot.py``); the launcher's audio
    workload."""
    _, _, tcfg, tparams = _models()
    engine = Engine(tcfg, tparams, batch_size=2, max_len=32, device="cpu")
    prompt = np.arange(4, dtype=np.int32)
    for frames in (None, np.zeros((tcfg.encoder_frames + 1, tcfg.d_model),
                                  np.float32),
                   np.zeros((2, tcfg.encoder_frames, tcfg.d_model),
                            np.float32),
                   np.zeros((1, tcfg.encoder_frames, tcfg.d_model),
                            np.float32)):
        with pytest.raises(ValueError, match="frames of shape"):
            engine.submit(Request(rid=0, prompt=prompt, frames=frames))
    engine.submit(Request(rid=0, prompt=prompt, max_new_tokens=2,
                          frames=_frames(tcfg, 1, 0)[0]))
    assert len(engine.run()) == 1
    for journal in (True, False):
        with pytest.raises(NotImplementedError, match="later slice"):
            Engine(tcfg, tparams, batch_size=2, max_len=32, device="cpu",
                   snapshot_dir=str(tmp_path / f"s{journal}"),
                   journal=journal)
        assert not (tmp_path / f"s{journal}").exists()
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="later slice"):
        serve.main(["--device", "cpu", "--arch", ARCH])


# -- weights and the card's dispatch ------------------------------------------

def test_quantize_model_leaves_bitwise_reference():
    """The port's ``quantize_model`` on the reference's float weights (via
    ``interop``) gives the reference's packed leaves bitwise: every
    projection, self and cross, and the MLP, int4; the embedding, norms
    and biases 16-bit."""
    jcfg = jax_smoke_config(ARCH, dtype=jnp.bfloat16)
    jfloat = japi.init_params(jcfg, jax.random.PRNGKey(3))
    want = interop.params_from_numpy(
        jax.tree.map(np.asarray, jax_quantize(jfloat, "dense")), "cpu")
    got = quantize_model(interop.params_from_numpy(
        jax.tree.map(np.asarray, jfloat), "cpu"), "dense")

    def walk(g, w, path):
        if isinstance(g, dict):
            assert sorted(g) == sorted(w), path
            for k in g:
                walk(g[k], w[k], f"{path}/{k}")
        elif isinstance(g, QuantizedTensor):
            assert isinstance(w, QuantizedTensor), path
            assert (g.shape, g.group_size) == (w.shape, w.group_size), path
            assert torch.equal(g.packed, w.packed), path
            assert torch.equal(g.scales, w.scales), path
        else:
            assert isinstance(w, torch.Tensor) and torch.equal(g, w), path
    walk(got, want, "")
    for stack, groups in (("enc_blocks", ("attn",)),
                          ("dec_blocks", ("self_attn", "cross_attn"))):
        for g in groups:
            for n in ("wq", "wk", "wv", "wo"):
                assert isinstance(got[stack][g][n], QuantizedTensor)
        assert isinstance(got[stack]["mlp"]["up"], QuantizedTensor)
        assert isinstance(got[stack]["mlp"]["down"], QuantizedTensor)
    assert got["embed"].dtype == torch.bfloat16
    assert got["enc_ln_f"]["gamma"].dtype == torch.bfloat16


def _stub_card(monkeypatch, cfg):
    """``_resolve`` answering "cuda" and every kernel an audio step
    reaches stubbed, recording its name (kernel 7's with its mask)."""
    calls = []

    def record(name, out):
        def fn(*a, **kw):
            calls.append(name)
            return out(*a, **kw)
        return fn

    def flash(q, k, v, causal=True, window=None, scale=None):
        assert window is None
        calls.append("flash_attention" + ("" if causal else "/no-mask")
                     + ("" if k.is_contiguous() and v.is_contiguous()
                        else "/strided"))
        return torch.zeros_like(q)
    monkeypatch.setattr(ops, "_resolve",
                        lambda impl, x: "cuda" if impl == "auto" else impl)
    monkeypatch.setattr(ops, "flash_attention_cuda", flash)
    monkeypatch.setattr(ops, "dense_matmul_cuda", record(
        "dense_matmul",
        lambda x, w, *a, **kw: torch.zeros(*x.shape[:-1], w.shape[1])))
    monkeypatch.setattr(ops, "w4a16_matmul_cuda", record(
        "w4a16_matmul", lambda x, w: torch.zeros(*x.shape[:-1], w.shape[1])))
    monkeypatch.setattr(ops, "ffn_w4a16_cuda", record(
        "ffn", lambda x, *a, **kw: torch.zeros_like(x)))
    monkeypatch.setattr(ops, "mixed_flash_attention_cuda", record(
        "attention", lambda q, *a, **kw: torch.zeros_like(q)))
    monkeypatch.setattr(ops, "kv_write_cuda", record(
        "kv_write", lambda *a, **kw: None))
    monkeypatch.setattr(ops, "add_layernorm_cuda", record(
        "add_layernorm", lambda x, h, g, b, eps, keep: (
            torch.zeros_like(x) if keep else None, torch.zeros_like(x))))
    monkeypatch.setattr(ops, "layernorm_cuda", record(
        "layernorm", lambda x, *a: torch.zeros_like(x)))
    monkeypatch.setattr(ops, "qkv_rope_write_cuda", record(
        "qkv_rope_write", lambda cache, q, k, v, bias, **kw: torch.zeros(
            q.shape[0], kw["n_heads"], q.shape[1], cfg.head_dim)))
    return calls


def test_card_dispatch_takes_cross_attention_to_kernel_7(monkeypatch):
    """On the card's dispatch a decode step runs, per decoder layer, the
    epilogue and kernel 3 for self-attention, kernel 7 without a mask over
    the layer's cross K/V (a contiguous slice of the cache, no copy), the
    FFN and three fused norms (the first takes the sinusoids), then the
    tied head through ``dense_matmul``: no sin, cos, cat or separate
    add.  An admission runs the encoder's kernel 7 without a mask."""
    _, _, cfg, params = _models()
    L, Le = cfg.n_layers, cfg.n_encoder_layers
    cache = api.request_cache(cfg, params, {"frames": torch.from_numpy(
        _frames(cfg, 2, 0))}, 32, "cpu")
    table = whisper.sinusoid_table(32, cfg.d_model, "cpu")
    calls = _stub_card(monkeypatch, cfg)

    def refuse(*a, **kw):
        raise AssertionError("sin, cos or cat ran in a served step")
    for attr in ("cos", "sin", "cat"):
        monkeypatch.setattr(torch, attr, refuse)
    api.decode_step(cfg, params, cache, _t([[3], [4]]), [5, 9])
    assert whisper.sinusoid_table(32, cfg.d_model, "cpu") is table
    want = {"qkv_rope_write": L, "attention": L, "flash_attention/no-mask": L,
            "ffn": L, "add_layernorm": 3 * L + 1, "w4a16_matmul": 6 * L,
            "dense_matmul": 1}
    assert {n: calls.count(n) for n in set(calls)} == want
    calls.clear()
    api.admit_into(cfg, params, cache, {"frames": torch.from_numpy(
        _frames(cfg, 2, 1))})
    # the encoder's K/V are projections' views: the wrapper copies them
    want = {"flash_attention/no-mask/strided": Le, "ffn": Le,
            "add_layernorm": 2 * Le + 1, "w4a16_matmul": 4 * Le + 2 * L}
    assert {n: calls.count(n) for n in set(calls)} == want
