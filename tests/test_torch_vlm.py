"""The vlm family (qwen2-vl-7b) in the port against the JAX reference, on
the CPU.

* Configs: full and smoke, field for field the reference's.
* M-RoPE: ``apply_mrope`` with distinct (3, B, S) ids within 1e-6 of the
  reference's, and with equal ids bitwise the port's ``apply_rope``
  (float32 and bfloat16); ``positions_for``'s (3, B, S) ids.
* The model, ``qwen2-vl-smoke`` in float32 within 1e-4 (``MODEL_TOL``),
  quantized "dense" by the reference with random q/k/v biases and carried
  over by ``interop``: ``api.forward`` with and without ``vision_embeds``;
  ``transformer.forward`` with distinct M-RoPE ids (an image grid, then
  text); ``prefill`` then ``decode_step``; ``mixed_step`` then
  ``decode_step`` on the slot and paged layouts, fp and int8 K/V, with
  every cache leaf; ``mixed_step(all_logits=True)`` bitwise the port's
  sequential ``decode_step``; the engine against the port's
  ``reference_decode`` and the JAX engine, plain, speculating and sharing
  prefixes; ``quantize_model`` "dense" and "strategy2" (at widths that
  sparsify) against the reference's leaves and logits.
* The fused q/k/v epilogue on an M-RoPE config rotates: the card's
  dispatch (``ops._resolve`` patched to "cuda") hands it the config's
  theta, and its plain version equals the unfused ``apply_mrope`` chain.
* Snapshots: the codec round trip, the reference's ``cfg_to_dict`` loading
  into the port, and a vlm engine restored from its snapshot.
* The launcher's smoke run.

    PYTHONPATH=src python -m pytest tests/test_torch_vlm.py -q
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.compiler import quantize_model as jax_quantize  # noqa: E402
from repro.core.quant import QuantizedTensor as JaxQuantized  # noqa: E402
from repro.core.sparsity import SparseQuantizedTensor as JaxSparse  # noqa: E402,E501
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serving import snapshot as jsnap  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.compiler import quantize_model  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.core.sparsity import SparseQuantizedTensor  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api, attention, layers, transformer  # noqa: E402,E501
from repro_torch.serving import snapshot as snaplib  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    Engine, Request, reference_decode)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "qwen2-vl-7b"
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# int8 K/V: a value may sit one quantization step from the reference's
# where a projection rounds across a boundary (tests/test_torch_paged.py)
INT8_MODEL_TOL = dict(rtol=1e-2, atol=1e-2)
PAGED = dict(kv_layout="paged", kv_block_size=8, kv_pool_blocks=24)
LAYOUTS = {"slot": {}, "slot-int8": dict(kv_quant="int8"), "paged": PAGED,
           "paged-int8": dict(PAGED, kv_quant="int8")}
# widths at which strategy2 makes wo, gate, up and down block-sparse (as
# tests/test_torch_quant.py's), head dim 128 with qwen2-vl-7b's sections
SPARSE_OVERRIDES = dict(d_model=1024, n_heads=8, n_kv_heads=2, head_dim=128,
                        d_ff=768, mrope_sections=(16, 24, 24))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path issues many ops on tiny tensors; under the
    parallel suite intra-op threads wait for each other far longer than the
    work takes, so these tests run the port on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _grid_ids(b, n_side, n_text):
    """M-RoPE ids of an ``n_side`` x ``n_side`` image followed by
    ``n_text`` text tokens, as Qwen2-VL lays them out: the image's temporal
    id 0, its height and width ids the patch's row and column; the text
    continues all three streams from the image's largest id + 1."""
    r, c = np.divmod(np.arange(n_side * n_side), n_side)
    img = np.stack([np.zeros_like(r), r, c])
    txt = np.arange(n_text) + n_side
    ids = np.concatenate([img, np.broadcast_to(txt, (3, n_text))], axis=1)
    return np.ascontiguousarray(
        np.broadcast_to(ids[:, None], (3, b, ids.shape[1]))).astype(np.int32)


# -- configs -----------------------------------------------------------------

@pytest.mark.parametrize("full", [True, False])
def test_configs_match_the_reference_field_by_field(full):
    want = (jax_config if full else jax_smoke_config)(ARCH)
    got = (get_config if full else get_smoke_config)(ARCH)
    for f in dataclasses.fields(got):
        if f.name == "dtype":
            assert str(got.dtype).split(".")[1] == jnp.dtype(want.dtype).name
        else:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.family == "vlm" and got.rope_type == "mrope"
    assert sum(got.mrope_sections) == got.head_dim // 2
    if full:
        # every W4A16 width is whole 128-row groups (kernels 1 and 2)
        assert all(w % 128 == 0 for w in (got.d_model, got.d_ff,
                                          got.n_heads * got.head_dim))


# -- M-RoPE ------------------------------------------------------------------

def test_apply_mrope_with_distinct_ids_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 37, 32)).astype(np.float32)
    for pos in (rng.integers(0, 5000, (3, 2, 37)).astype(np.int32),
                _grid_ids(2, 5, 12)):
        got = layers.apply_mrope(_t(x), _t(pos), 1e6, (4, 6, 6))
        want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                                   (4, 6, 6))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(_t(x), _t(pos), 1e6, (4, 6, 4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_mrope_with_equal_ids_is_apply_rope_bitwise(dtype):
    """Text tokens carry t == h == w, the serving steps' case: then M-RoPE
    is the standard rotation bit for bit, so the fused epilogue's standard
    table serves an M-RoPE config."""
    rng = np.random.default_rng(1)
    x = _t(rng.normal(size=(3, 4, 29, 128)).astype(np.float32)).to(dtype)
    pos = _t(rng.integers(0, 8192, (3, 29)).astype(np.int32))
    got = layers.apply_mrope(x, pos[None].expand(3, 3, 29), 1e6, (16, 24, 24))
    assert got.dtype == dtype
    assert torch.equal(got, layers.apply_rope(x, pos, 1e6))


def test_positions_for_gives_three_equal_streams_as_the_reference():
    cfg = get_smoke_config(ARCH)
    got = layers.positions_for(cfg, 3, 5, offset=7)
    want = jlayers.positions_for(jax_smoke_config(ARCH), 3, 5, offset=7)
    assert got.shape == (3, 3, 5)
    assert np.array_equal(got.numpy(), np.asarray(want))


# -- models ------------------------------------------------------------------

def _with_biases(jparams, seed):
    """The reference initialises q/k/v biases to zero; draw them at random
    so every route's bias add is held too."""
    rng = np.random.default_rng(seed)
    attn = dict(jparams["blocks"]["attn"])
    for k in ("bq", "bk", "bv"):
        attn[k] = jnp.asarray(
            0.1 * rng.normal(size=attn[k].shape).astype(np.float32),
            attn[k].dtype)
    return {**jparams, "blocks": {**jparams["blocks"], "attn": attn}}


_CACHE = {}


def _models(strategy="dense", **over):
    key = (strategy, tuple(sorted(over.items())))
    if key not in _CACHE:
        jcfg = jax_smoke_config(ARCH, **over)
        base = _with_biases(japi.init_params(jcfg, jax.random.PRNGKey(0)), 3)
        jparams = jax_quantize(base, strategy)
        tparams = interop.params_from_numpy(
            jax.tree.map(np.asarray, jparams), "cpu")
        _CACHE[key] = (jcfg, jparams, get_smoke_config(ARCH, **over),
                       tparams, base)
    return _CACHE[key][:4]


def _layout(models, layout):
    jcfg, jparams, tcfg, tparams = models
    over = LAYOUTS[layout]
    return (dataclasses.replace(jcfg, **over), jparams,
            dataclasses.replace(tcfg, **over), tparams)


def _assert_cache_close(tcache, jcache):
    """Float leaves (K/V, int8 scales) within 1e-4; int8 values at most
    one step apart."""
    assert sorted(tcache) == sorted(jcache)
    for name, leaf in tcache.items():
        got, want = leaf.numpy(), np.asarray(jcache[name])
        assert got.shape == want.shape, name
        if got.dtype == np.int8:
            assert np.abs(got.astype(np.int32) - want).max() <= 1, name
        else:
            np.testing.assert_allclose(got, want, **MODEL_TOL, err_msg=name)


@pytest.mark.parametrize("with_vision", [False, True])
def test_forward_matches_jax(with_vision):
    """``api.forward``, text only and with 16 patch embeddings before 11
    tokens (the stubbed frontend's output, cast to the model's dtype)."""
    jcfg, jparams, tcfg, tparams = _models()
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    jbatch, tbatch = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks).long()}
    n = 0
    if with_vision:
        n = 16
        vis = rng.normal(size=(2, n, jcfg.d_model)).astype(np.float32)
        jbatch["vision_embeds"] = jnp.asarray(vis)
        tbatch["vision_embeds"] = _t(vis).to(torch.float64)   # cast inside
    jl, _ = japi.forward(jcfg, jparams, jbatch)
    tl, taux = api.forward(tcfg, tparams, tbatch)
    assert tl.shape == (2, n + 11, jcfg.vocab_size) and float(taux) == 0.0
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)


def test_forward_with_distinct_mrope_ids_matches_jax():
    """``transformer.forward`` with (3, B, S) ids that differ by stream (a
    5 x 5 image grid, then text) matches the reference's, and differs from
    the same call at the canonical equal ids."""
    jcfg, jparams, tcfg, tparams = _models()
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    vis = rng.normal(size=(2, 25, jcfg.d_model)).astype(np.float32)
    pos = _grid_ids(2, 5, 9)
    jl, _ = jtransformer.forward(jcfg, jparams, jnp.asarray(toks),
                                 positions=jnp.asarray(pos),
                                 vision_embeds=jnp.asarray(vis))
    tl, _ = transformer.forward(tcfg, tparams, _t(toks).long(),
                                positions=_t(pos), vision_embeds=_t(vis))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    canon, _ = transformer.forward(tcfg, tparams, _t(toks).long(),
                                   vision_embeds=_t(vis))
    assert not torch.allclose(canon, tl, atol=1e-3)


@pytest.mark.parametrize("layout", ["slot", "slot-int8"])
def test_prefill_then_decode_matches_jax(layout):
    """``prefill`` of 8 tokens into a 32-token cache, then one greedy
    ``decode_step`` (as the reference's ``test_prefill_then_decode``):
    logits and every cache leaf."""
    jcfg, jparams, tcfg, tparams = _layout(_models(), layout)
    tol = INT8_MODEL_TOL if tcfg.kv_quant == "int8" else MODEL_TOL
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    jp, jcache = japi.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                              32)
    tp, tcache = api.prefill(tcfg, tparams, {"tokens": _t(toks).long()}, 32)
    assert tp.shape == (2, tcfg.vocab_size)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **tol)
    _assert_cache_close(tcache, jcache)
    nxt = np.asarray(jnp.argmax(jp, axis=-1))[:, None].astype(np.int32)
    assert np.array_equal(nxt[:, 0], tp.argmax(-1).numpy())
    jl, jcache = japi.decode_step(jcfg, jparams, jcache, jnp.asarray(nxt),
                                  jnp.int32(9))
    tl, tcache = api.decode_step(tcfg, tparams, tcache, _t(nxt).long(),
                                 torch.tensor([9, 9], dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    _assert_cache_close(tcache, jcache)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mixed_and_decode_steps_match_jax(layout):
    """Three mixed steps (idle rows among them), then a decode step:
    logits and every cache leaf (paged: the pool under the default table;
    the null block aside, which the reference writes and the port never
    touches)."""
    jcfg, jparams, tcfg, tparams = _layout(_models(), layout)
    tol = INT8_MODEL_TOL if tcfg.kv_quant == "int8" else MODEL_TOL
    rng = np.random.default_rng(7)
    b, c, max_len = 2, 8, 32
    jcache = japi.init_cache(jcfg, b, max_len)
    tcache = api.init_cache(tcfg, b, max_len, "cpu")
    for lengths, q_lens in [([0, 0], [8, 5]), ([8, 5], [3, 8]),
                            ([11, 13], [0, 2])]:
        toks = rng.integers(0, jcfg.vocab_size, (b, c)).astype(np.int32)
        jl, jcache = japi.mixed_step(jcfg, jparams, jcache, jnp.asarray(toks),
                                     jnp.asarray(lengths, jnp.int32),
                                     jnp.asarray(q_lens, jnp.int32))
        tl, tcache = api.mixed_step(tcfg, tparams, tcache, _t(toks).long(),
                                    torch.tensor(lengths, dtype=torch.int32),
                                    torch.tensor(q_lens, dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    toks = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    jl, jcache = japi.decode_step(jcfg, jparams, jcache, jnp.asarray(toks),
                                  jnp.asarray([12, 16], jnp.int32))
    tl, tcache = api.decode_step(tcfg, tparams, tcache, _t(toks).long(),
                                 torch.tensor([12, 16], dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    if tcfg.kv_layout == "paged":       # leave out the null block (last)
        jcache = {k: np.asarray(v)[:, :-1] for k, v in jcache.items()}
        tcache = {k: v[:, :-1] for k, v in tcache.items()}
    _assert_cache_close(tcache, jcache)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mixed_step_equals_sequential_decode_bitwise(layout):
    """Rows at lengths 0, 5 and 13 verify 4 then 8 positions with ragged
    ``q_lens`` (a dead row among them) through ``mixed_step(all_logits=
    True)``: each live position's logits bitwise the port's sequential
    ``decode_step`` there, and every cache leaf bitwise."""
    _, _, tcfg, tparams = _layout(_models(), layout)
    b, max_len = 3, 48
    rng = np.random.default_rng(8)
    lens = np.asarray([0, 5, 13], np.int32)
    cache = api.init_cache(tcfg, b, max_len, "cpu")
    toks = rng.integers(0, tcfg.vocab_size, (b, 16)).astype(np.int32)
    api.mixed_step(tcfg, tparams, cache, _t(toks).long(),
                   torch.zeros(b, dtype=torch.int32), _t(lens))
    seq = {k: v.clone() for k, v in cache.items()}
    for w, q_lens in ((4, [4, 0, 3]), (8, [8, 5, 8])):
        q_lens = np.asarray(q_lens, np.int32)
        toks = rng.integers(0, tcfg.vocab_size, (b, w)).astype(np.int32)
        ml, cache = api.mixed_step(tcfg, tparams, cache, _t(toks).long(),
                                   _t(lens), _t(q_lens), all_logits=True)
        for j in range(w):
            sl, seq = api.decode_step(
                tcfg, tparams, seq, _t(toks[:, j:j + 1]).long(),
                _t(lens + np.minimum(j, q_lens - 1) + 1),
                write_mask=_t(j < q_lens))
            for r in np.flatnonzero(j < q_lens):
                assert torch.equal(ml[r, j], sl[r]), (w, r, j)
        for name in cache:
            assert torch.equal(cache[name], seq[name]), (w, name)
        lens = lens + q_lens


# -- the fused epilogue on M-RoPE ----------------------------------------------

def test_card_dispatch_hands_the_epilogue_the_mrope_theta(monkeypatch):
    """On the card's dispatch (``ops._resolve`` answering "cuda", the
    kernels stubbed by their plain versions) a vlm mixed step and a decode
    step launch the epilogue once a layer with the config's theta (an
    epilogue given None would not rotate at all), the other kernels as
    ``chip_smoke.expected_launches`` counts them; ``forward`` takes kernel
    7 once a layer and no epilogue."""
    import chip_smoke
    from repro_torch.kernels import kv_write as kvw
    from repro_torch.kernels import rmsnorm as rms
    _, _, cfg, params = _models()
    calls, thetas = [], []

    def record(name, fn):
        def stub(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return stub

    def epilogue(cache, q, k, v, bias, **kw):
        calls.append("qkv_rope_write")
        thetas.append(kw["theta"])
        return kvw.qkv_rope_write_torch(cache, q, k, v, bias,
                                        write=ops.kv_write_torch,
                                        norm=rms.rmsnorm_torch, **kw)
    monkeypatch.setattr(ops, "_resolve",
                        lambda impl, x: "cuda" if impl == "auto" else impl)
    for name, attr, fn in (
            ("w4a16_matmul", "w4a16_matmul_cuda", ops.w4a16_matmul_torch),
            ("mixed_flash_attention", "mixed_flash_attention_cuda",
             ops.mixed_attention_torch),
            ("flash_attention", "flash_attention_cuda",
             ops.flash_attention_torch),
            ("add_rmsnorm", "add_rmsnorm_cuda", ops.add_rmsnorm_torch)):
        monkeypatch.setattr(ops, attr, record(name, fn))
    # the FFN: kernel 2's gate/up stage, then kernel 1 for down
    monkeypatch.setattr(ops, "ffn_w4a16_cuda", record(
        "ffn_fused_w4a16", record("w4a16_matmul", ops.ffn_w4a16_torch)))
    monkeypatch.setattr(ops, "qkv_rope_write_cuda", epilogue)
    monkeypatch.setattr(layers, "_rmsnorm", record("rmsnorm",
                                                   rms.rmsnorm_torch))
    b, c = 2, 4
    cache = api.init_cache(cfg, b, 32, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (b, c),
                         generator=torch.Generator().manual_seed(1))
    lengths = torch.tensor([3, 9], dtype=torch.int32)
    for name, step in (
            ("mixed", lambda: api.mixed_step(
                cfg, params, cache, toks, lengths,
                torch.tensor([c, 2], dtype=torch.int32))),
            ("decode", lambda: api.decode_step(cfg, params, cache,
                                               toks[:, :1], lengths + 1))):
        calls.clear()
        thetas.clear()
        step()
        want = chip_smoke.expected_launches(cfg, params, 1)
        got = {k: calls.count(k) for k in set(calls)}
        assert got == want, name
        assert thetas == [cfg.rope_theta] * cfg.n_layers, name
    calls.clear()
    api.forward(cfg, params, {"tokens": toks})
    assert calls.count("flash_attention") == cfg.n_layers
    assert "qkv_rope_write" not in calls


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_epilogue_equals_the_unfused_mrope_chain(layout):
    """One layer's served q/k/v (``attention._qkv_into_cache``, the fused
    epilogue's route) against the unfused chain at the step's (3, B, C)
    ids (``_project_qkv``'s bias add and ``apply_mrope``, ``quantize_kv``,
    the cache write): q and every cache leaf bitwise."""
    _, _, cfg, params = _layout(_models(), layout)
    p = transformer.layer_params(params["blocks"], 1)["attn"]
    b, c, max_len = 3, 8, 32
    rng = np.random.default_rng(9)
    x = _t(rng.normal(size=(b, c, cfg.d_model)).astype(np.float32))
    lengths = torch.tensor([0, 7, 20], dtype=torch.int32)
    q_lens = torch.tensor([8, 3, 0], dtype=torch.int32)
    fused = transformer._layer_cache(api.init_cache(cfg, b, max_len, "cpu"),
                                     0)
    plain = {k: v.clone() for k, v in fused.items()}
    index = attention.mixed_index(cfg, fused, b, lengths, q_lens)
    q = attention._qkv_into_cache(cfg, p, x, fused, index)
    pos = lengths[:, None] + torch.arange(c, dtype=torch.int32)[None]
    ids = layers.rope_ids(cfg, pos)
    assert ids.shape == (3, b, c)
    qp, k, v = attention._project_qkv(cfg, p, x, ids)
    ops.kv_write(plain, attention._new_kv(cfg, k, v), index.starts,
                 index.q_lens, page_table=index.page_table)
    assert torch.equal(q, qp)
    for name in fused:
        assert torch.equal(fused[name], plain[name]), name
    # and the rotation is there: without it q differs
    unrotated = dataclasses.replace(cfg, rope_type="none")
    q0, _, _ = attention._project_qkv(unrotated, p, x, pos)
    assert not torch.allclose(q, q0, atol=1e-3)


# -- the engine ----------------------------------------------------------------

def _workload(vocab, n=6):
    rng = np.random.default_rng(2)
    return [(100 + i,
             rng.integers(0, vocab, int(rng.integers(3, 20))).astype(np.int32),
             int(rng.integers(2, 8)))
            for i in range(n)]


def _serve_both(jcfg, jparams, tcfg, tparams, work, **kw):
    engine = Engine(tcfg, tparams, batch_size=2, max_len=64, chunk_size=16,
                    audit_every=1, device="cpu", **kw)
    for rid, prompt, n in work:
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    done = engine.run()
    assert done.drained and len(done) == len(work)
    jengine = JaxEngine(jcfg, jparams, batch_size=2, max_len=64,
                        chunk_size=16, **kw)
    for rid, prompt, n in work:
        jengine.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=n))
    jstreams = {r.rid: r.output for r in jengine.run()}
    return engine, jengine, {r.rid: r.output for r in done}, jstreams


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_engine_matches_oracle_and_jax_engine(layout):
    jcfg, jparams, tcfg, tparams = _layout(_models(), layout)
    work = _workload(tcfg.vocab_size)
    engine, jengine, streams, jstreams = _serve_both(
        jcfg, jparams, tcfg, tparams, work)
    assert engine.mixed_ticks > 0 and engine.dispatches == engine.steps
    assert engine.cache_compiles.misses <= engine.compile_budget
    for rid, prompt, n in work:
        assert streams[rid] == reference_decode(
            tcfg, tparams, prompt, n, max_len=64, device="cpu"), rid
    assert jstreams == streams
    assert sorted(engine.cache_compiles.keys()) == sorted(
        jengine.cache_compiles.keys())
    if tcfg.kv_layout == "paged":
        pool = engine.pool_stats()
        assert pool["free"] == pool["total"] and not pool["leased"]


def _shared_prefix_work(vocab):
    """Prompts behind one 16-token system prompt, one repeated whole, and
    a tiled pattern the prompt-lookup drafter finds."""
    rng = np.random.default_rng(11)
    system = rng.integers(0, vocab, 16)
    work = []
    for i in range(4):
        user = rng.integers(0, vocab, int(rng.integers(3, 10)))
        work.append((i, np.concatenate([system, user]).astype(np.int32), 6))
    work.append((4, work[1][1].copy(), 6))
    work.append((5, np.tile(rng.integers(0, vocab, 4), 5).astype(np.int32),
                 8))
    return work


@pytest.mark.parametrize("layout", ["paged", "paged-int8"])
def test_speculating_and_sharing_engine_matches_the_jax_engine(layout):
    """``spec_k=4`` with ``prefix_cache=True`` on the paged pool: the
    streams of the JAX engine and of the port's ``reference_decode``,
    with drafts accepted and prefix blocks reused."""
    jcfg, jparams, tcfg, tparams = _layout(_models(), layout)
    work = _shared_prefix_work(tcfg.vocab_size)
    engine, jengine, streams, jstreams = _serve_both(
        jcfg, jparams, tcfg, tparams, work, spec_k=4, prefix_cache=True)
    assert engine.spec_k == 4 and engine.prefix_sharing
    assert jstreams == streams
    for rid, prompt, n in work:
        assert streams[rid] == reference_decode(
            tcfg, tparams, prompt, n, max_len=64, device="cpu"), rid
    assert engine.spec_stats() == jengine.spec_stats()
    assert engine.prefix_stats() == jengine.prefix_stats()
    assert engine.prefix_stats()["hit_tokens"] > 0


# -- weights -------------------------------------------------------------------

def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def test_interop_roundtrip_keeps_every_leaf():
    """The vlm tree (the dense transformer's leaves with q/k/v biases):
    numpy -> port -> numpy keeps every array and int4 leaf bit for bit."""
    jcfg, jparams, _, _ = _models()
    src = jax.tree.map(np.asarray, jparams)
    assert {"bq", "bk", "bv"} <= set(src["blocks"]["attn"])
    back = dict(_leaves(interop.params_to_numpy(
        interop.params_from_numpy(src, "cpu"))))
    n = 0
    for name, leaf in _leaves(src):
        got = back[name]
        if isinstance(leaf, JaxQuantized):
            for attr in ("packed", "scales"):
                a, b = getattr(leaf, attr), getattr(got, attr)
                assert a.dtype == b.dtype and a.shape == b.shape, name
                np.testing.assert_array_equal(a.view(np.uint8),
                                              b.view(np.uint8))
            assert (tuple(leaf.shape), leaf.group_size) == (
                got.shape, got.group_size)
        else:
            assert leaf.dtype == got.dtype and leaf.shape == got.shape, name
            np.testing.assert_array_equal(leaf, got)
        n += 1
    assert n == len(back)


@pytest.mark.parametrize("strategy", ["dense", "strategy2"])
def test_quantize_model_matches_jax(strategy):
    """The port's ``quantize_model`` of the reference's 16-bit vlm weights
    gives the reference's leaves (types, packed ints and scales bitwise;
    strategy2 at widths where wo, gate, up and down sparsify), and the
    logits of a mixed step and a decode step on them within 1e-4."""
    over = SPARSE_OVERRIDES if strategy != "dense" else {}
    jcfg, jparams, tcfg, _ = _models(strategy, **over)
    base = _CACHE[(strategy, tuple(sorted(over.items())))][4]
    tq = quantize_model(interop.params_from_numpy(
        jax.tree.map(np.asarray, base), "cpu"), strategy)
    got = dict(_leaves(tq))
    sparse = 0
    for name, leaf in _leaves(jparams):
        t = got[name]
        if isinstance(leaf, JaxSparse):
            assert isinstance(t, SparseQuantizedTensor), name
            np.testing.assert_array_equal(np.asarray(leaf.block_idx),
                                          t.block_idx.numpy())
            sparse += 1
        elif isinstance(leaf, JaxQuantized):
            assert isinstance(t, QuantizedTensor), name
        else:
            np.testing.assert_array_equal(
                np.asarray(leaf).astype(np.float32), t.float().numpy())
            continue
        np.testing.assert_array_equal(np.asarray(leaf.packed),
                                      t.packed.numpy())
        np.testing.assert_array_equal(
            np.asarray(leaf.scales).astype(np.float32),
            t.scales.float().numpy())
    assert sparse == (4 if strategy == "strategy2" else 0)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    jcache = japi.init_cache(jcfg, 2, 32)
    tcache = api.init_cache(tcfg, 2, 32, "cpu")
    jl, jcache = japi.mixed_step(jcfg, jparams, jcache, jnp.asarray(toks),
                                 jnp.zeros(2, jnp.int32),
                                 jnp.asarray([8, 5], jnp.int32))
    tl, tcache = api.mixed_step(tcfg, tq, tcache, _t(toks).long(),
                                torch.zeros(2, dtype=torch.int32),
                                torch.tensor([8, 5], dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    nxt = toks[:, :1]
    jl, _ = japi.decode_step(jcfg, jparams, jcache, jnp.asarray(nxt),
                             jnp.asarray([9, 6], jnp.int32))
    tl, _ = api.decode_step(tcfg, tq, tcache, _t(nxt).long(),
                            torch.tensor([9, 6], dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)


# -- durability ------------------------------------------------------------------

def test_snapshot_codec_takes_the_vlm_config_of_either_package():
    """The port's ``cfg_to_dict`` round trip keeps the M-RoPE sections (a
    JSON list back to a tuple), and the reference's ``cfg_to_dict`` of the
    same config, its execution knobs included, loads into the port's."""
    import json
    for cfg in (get_smoke_config(ARCH), get_config(ARCH)):
        d = json.loads(json.dumps(snaplib.cfg_to_dict(cfg)))
        assert isinstance(d["mrope_sections"], list)
        assert snaplib.cfg_from_dict(d) == cfg
    for full in (True, False):
        jcfg = (jax_config if full else jax_smoke_config)(ARCH)
        d = json.loads(json.dumps(jsnap.cfg_to_dict(jcfg)))
        assert {"remat", "scan_layers", "use_kernels"} <= set(d)
        assert snaplib.cfg_from_dict(d) == (
            get_config if full else get_smoke_config)(ARCH)
    with pytest.raises(ValueError, match="not the port's"):
        snaplib.cfg_from_dict(dict(snaplib.cfg_to_dict(
            get_smoke_config(ARCH)), vision_tower="vit"))


def test_durable_restore_equals_the_never_killed_engine(tmp_path):
    """A vlm engine stopped after 5 ticks and restored from its snapshot
    and journal finishes every request with the oracle's stream."""
    _, _, tcfg, tparams = _models()
    work = _workload(tcfg.vocab_size, 5)
    engine = Engine(tcfg, tparams, batch_size=2, max_len=64, chunk_size=16,
                    snapshot_dir=str(tmp_path), snapshot_every=2,
                    device="cpu")
    for rid, prompt, n in work:
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    with pytest.warns(RuntimeWarning, match="max_steps=5"):
        out = {r.rid: r.output for r in engine.run(max_steps=5)}
    restored = Engine.restore(str(tmp_path), tparams, device="cpu",
                              compile_cache=engine.cache_compiles)
    assert restored.cfg == tcfg
    out.update({r.rid: r.output for r in restored.restored_terminal})
    res = restored.run()
    assert res.drained
    out.update({r.rid: r.output for r in res})
    assert out == {rid: reference_decode(tcfg, tparams, prompt, n,
                                         max_len=64, device="cpu")
                   for rid, prompt, n in work}


# -- the launcher ------------------------------------------------------------------

def test_launcher_serves_the_vlm_smoke_config_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--max-new-tokens", "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert "arch=qwen2-vl-smoke" in out and "'completed': 3" in out
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--max-new-tokens", "4", "--batch", "2", "--kv-layout",
                "paged", "--kv-pool-blocks", "12", "--spec",
                "--prefix-cache", "--strategy", "strategy2"])
    out = capsys.readouterr().out
    assert "'completed': 3" in out and "strategy=strategy2" in out
    assert "speculation requested" not in out
    assert "prefix cache requested" not in out
