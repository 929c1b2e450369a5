"""The port's paged KV pool and int8 KV cache against the JAX reference.

* Kernel level: the plain paged and int8 versions of the mixed attention
  kernel against ``mixed_flash_attention_pallas`` (interpret mode) and
  ``mixed_attention_blocked`` on scrambled, fragmented pools (the
  ``_scrambled_pool`` of ``tests/test_paged_fuzz.py``), f32 within 1e-5
  (sums taken in another order by another library); the port against
  itself bitwise (paged ≡ slot at ``block_kv = bs``, two scrambles of one
  cache, NaN in the null and unleased blocks changes nothing).
* Model level: ``qwen-7b-smoke`` in f32 with W4A16 and strategy2 weights,
  paged fp, paged int8 and slot int8: ``mixed_step``/``decode_step``
  against the reference's on the same page table.
* Engine: the ``tests/test_paged_engine.py`` workloads through the port's
  paged engine, token streams equal to the JAX paged engine's and to the
  port's ``reference_decode``; allocator guarantees; the launcher.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.compiler import quantize_model as jax_quantize  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.decode_flash import mixed_flash_attention_pallas  # noqa: E402
from repro.kernels.xla_attention import mixed_attention_blocked  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.prefix import BlockAllocator as JaxAllocator  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api, attention  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    Engine, Request, reference_decode)
from repro_torch.serving.prefix import BlockAllocator  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path issues many ops on tiny tensors.  On a loaded
    machine (the suite runs test files in parallel) intra-op threads wait
    for each other far longer than the work takes, so these tests run the
    port on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# int8 K/V: where the two packages' f32 projections fall on either side of
# a rounding boundary, one stored value differs by one step (1/127 of its
# vector's absmax), which moves the logits by up to ~1e-2 at these widths
INT8_MODEL_TOL = dict(rtol=1e-2, atol=1e-2)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- kernel level --------------------------------------------------------------

def _scrambled_table(rng, b, n_pages, extra_blocks=3):
    """A random fragmented, non-identity assignment of every (row, page) to
    a distinct pool block; ``extra_blocks`` stay unassigned.  Returns
    (table, pool rows including the null block)."""
    total = b * n_pages + extra_blocks
    table = rng.permutation(total)[:b * n_pages].reshape(b, n_pages)
    return table.astype(np.int32), total + 1


def _scatter(src, table, rows, bs, fill):
    """Contiguous (b, hkv, S, ...) leaf -> pool (rows, hkv, bs, ...) under
    ``table``; unassigned blocks and the null block hold ``fill``."""
    src = np.asarray(src)
    pool = np.full((rows, src.shape[1], bs) + src.shape[3:], fill, src.dtype)
    for b in range(table.shape[0]):
        for p in range(table.shape[1]):
            pool[table[b, p]] = src[b, :, p * bs:(p + 1) * bs]
    return pool


def _paged(leaves, table, rows, bs, fill):
    """Every leaf of a contiguous cache scattered into its pool."""
    fills = {"k": fill, "v": -fill, "k_scale": 0.5, "v_scale": 0.5}
    if leaves["k"].dtype == np.int8:
        fills.update(k=17, v=-23)
    return {name: _scatter(a, table, rows, bs, fills[name])
            for name, a in leaves.items()}


def _operands(rng, b, hq, hkv, s, d, chunk, quant):
    q = rng.normal(size=(b, hq, chunk or 1, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    sq = chunk or 1
    lengths = rng.integers(sq, s + 1, size=b).astype(np.int32)
    q_lens = (rng.integers(0, sq + 1, size=b).astype(np.int32) if chunk
              else np.ones(b, np.int32))
    leaves = {"k": k, "v": v}
    if quant:
        kq, ks = jattention.quantize_kv(jnp.asarray(k))
        vq, vs = jattention.quantize_kv(jnp.asarray(v))
        leaves = {"k": np.asarray(kq), "v": np.asarray(vq),
                  "k_scale": np.asarray(ks), "v_scale": np.asarray(vs)}
    return q, leaves, lengths, q_lens


def _port_attention(q, leaves, lengths, q_lens, window, **kw):
    scales = {n: _t(leaves[n]) for n in ("k_scale", "v_scale") if n in leaves}
    return ops.mixed_attention(_t(q), _t(leaves["k"]), _t(leaves["v"]),
                               _t(lengths), _t(q_lens), window=window,
                               **scales, **kw)


def _jax_attention(fn, q, leaves, lengths, q_lens, window, **kw):
    scales = {n: jnp.asarray(leaves[n]) for n in ("k_scale", "v_scale")
              if n in leaves}
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(leaves["k"]),
                         jnp.asarray(leaves["v"]), jnp.asarray(lengths),
                         jnp.asarray(q_lens), window=window, **scales, **kw))


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("b,hq,hkv,bs,chunk,window", [
    (1, 4, 4, 8, None, None),        # MHA decode
    (3, 8, 2, 16, None, None),       # GQA decode
    (4, 4, 1, 32, None, None),       # MQA decode
    (2, 8, 2, 32, None, 20),         # decode in a window
    (3, 8, 2, 16, 8, None),          # GQA chunk
    (4, 4, 1, 8, 8, 12),             # MQA chunk in a window
])
def test_paged_plain_matches_reference(b, hq, hkv, bs, chunk, window, quant):
    rng = np.random.default_rng(b * 100 + bs + (chunk or 0))
    s, d = 64, 32
    q, leaves, lengths, q_lens = _operands(rng, b, hq, hkv, s, d, chunk,
                                           quant)
    table, rows = _scrambled_table(rng, b, s // bs)
    pool = _paged(leaves, table, rows, bs, 3.25)
    got = _port_attention(q, pool, lengths, q_lens, window,
                          page_table=_t(table), impl="torch").numpy()
    for fn, kw in ((mixed_flash_attention_pallas, {"interpret": True}),
                   (mixed_attention_blocked, {})):
        want = _jax_attention(fn, q, pool, lengths, q_lens, window,
                              page_table=jnp.asarray(table), **kw)
        np.testing.assert_allclose(got, want, **KERNEL_TOL,
                                   err_msg=fn.__name__)
    np.testing.assert_allclose(
        got, _port_attention(q, pool, lengths, q_lens, window,
                             page_table=_t(table), impl="ref").numpy(),
        **KERNEL_TOL)
    # paging is a layout change: the slot walk pinned to the page size
    # reduces in the same order, bit for bit
    slot = _port_attention(q, leaves, lengths, q_lens, window, block_kv=bs,
                           impl="torch").numpy()
    np.testing.assert_array_equal(got, slot)
    # another scramble of the same logical cache gives the same bits
    table2, rows2 = _scrambled_table(rng, b, s // bs, extra_blocks=5)
    again = _port_attention(q, _paged(leaves, table2, rows2, bs, -1.5),
                            lengths, q_lens, window, page_table=_t(table2),
                            impl="torch").numpy()
    np.testing.assert_array_equal(got, again)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_null_and_unleased_blocks_are_never_read(quant):
    """Pages past a row's live range point at the null block; it and every
    unleased block hold NaN: the output is finite and bitwise the clean
    pool's."""
    rng = np.random.default_rng(3)
    b, hq, hkv, s, d, bs = 3, 8, 2, 64, 32, 8
    q, leaves, _, _ = _operands(rng, b, hq, hkv, s, d, 8, quant)
    lengths = np.asarray([5, 64, 17], np.int32)
    q_lens = np.asarray([3, 8, 1], np.int32)
    table, rows = _scrambled_table(rng, b, s // bs)
    clean = _port_attention(q, _paged(leaves, table, rows, bs, 0.0), lengths,
                            q_lens, None, page_table=_t(table),
                            impl="torch")
    live = -(-lengths // bs)
    table[np.arange(s // bs)[None, :] >= live[:, None]] = rows - 1
    pool = _paged(leaves, table, rows, bs, np.nan)
    leased = set(table[table != rows - 1].tolist())
    for name, leaf in pool.items():
        if leaf.dtype != np.int8:
            unleased = [i for i in range(rows) if i not in leased]
            leaf[unleased] = np.nan
        # the tail of a row's last page past its length: garbage too
        for r in range(b):
            p, off = divmod(int(lengths[r]), bs)
            if off and leaf.dtype != np.int8:
                leaf[table[r, p], :, off:] = np.nan
    got = _port_attention(q, pool, lengths, q_lens, None,
                          page_table=_t(table), impl="torch")
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, clean)


def test_quantize_kv_bitwise_with_reference():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(3, 2, 40, 64)) * rng.uniform(0.01, 30, (3, 2, 40,
                                                                 1)))
    x = x.astype(np.float32)
    x[0, 0, 0] = 0.0                         # all-zero vector: the 1e-10 floor
    x[1, 1, 1, :4] = [127.0, 63.5, -0.5, 1.5]   # exact halves: round to even
    jq, js = jattention.quantize_kv(jnp.asarray(x))
    tq, ts = attention.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.shape == (3, 2, 40, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        attention.dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(jattention.dequantize_kv(jq, js, jnp.float32)))


def test_gather_paged_cache_equals_reference():
    rng = np.random.default_rng(5)
    pool = rng.normal(size=(11, 2, 8, 16)).astype(np.float32)
    table = rng.integers(0, 11, size=(3, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        ops.gather_paged_cache(_t(pool), _t(table)).numpy(),
        np.asarray(jops.gather_paged_cache(jnp.asarray(pool),
                                           jnp.asarray(table))))


def test_paged_helpers_match_reference():
    jcfg = jax_smoke_config("qwen-7b", kv_layout="paged", kv_block_size=8)
    tcfg = get_smoke_config("qwen-7b", kv_layout="paged", kv_block_size=8)
    for max_len in (8, 30, 64):
        assert (attention.paged_geometry(tcfg, max_len)
                == jattention.paged_geometry(jcfg, max_len))
        assert (attention.paged_pool_blocks(tcfg, 3, max_len)
                == jattention.paged_pool_blocks(jcfg, 3, max_len))
        assert (attention.paged_blocks_for(max_len, 8)
                == jattention.paged_blocks_for(max_len, 8))
    np.testing.assert_array_equal(
        attention.default_page_table(3, 13).numpy(),
        np.asarray(jattention.default_page_table(3, 13)))
    for over in ({}, {"kv_quant": "int8"}):
        jc = jattention.init_kv_cache(dataclasses.replace(jcfg, **over), 2, 30)
        tc = attention.init_kv_cache(dataclasses.replace(tcfg, **over), 2, 30,
                                     "cpu")
        assert {k: tuple(v.shape) for k, v in tc.items()} == \
            {k: tuple(v.shape) for k, v in jc.items()}
        assert attention.kv_cache_slot_axes(
            dataclasses.replace(tcfg, **over)) == jattention.kv_cache_slot_axes(
                dataclasses.replace(jcfg, **over))
    with pytest.raises(ValueError, match="kv_block_size"):
        get_smoke_config("qwen-7b", kv_layout="paged", kv_block_size=0)


# -- model level ---------------------------------------------------------------

WEIGHTS = {
    "dense": ({}, "dense"),
    # wo, gate and up block-sparse, down tile_uniform sparse: qwen-7b's
    # strategy2 layout at smoke depth
    "strategy2": (dict(d_model=1024, n_heads=8, n_kv_heads=2, head_dim=128,
                       d_ff=768), "strategy2"),
}
KV = {"paged": dict(kv_layout="paged", kv_block_size=8),
      "paged-int8": dict(kv_layout="paged", kv_block_size=8,
                         kv_quant="int8"),
      "slot-int8": dict(kv_quant="int8")}
_MODELS = {}


def _models(weights):
    if weights not in _MODELS:
        over, strategy = WEIGHTS[weights]
        jcfg = jax_smoke_config("qwen-7b", **over)
        jparams = jax_quantize(japi.init_params(jcfg, jax.random.PRNGKey(0)),
                               strategy)
        tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                            "cpu")
        _MODELS[weights] = (jcfg, jparams, get_smoke_config("qwen-7b", **over),
                            tparams)
    return _MODELS[weights]


def _assert_cache_close(tcache, jcache, paged):
    for name, leaf in tcache.items():
        got, want = leaf.numpy(), np.asarray(jcache[name])
        if paged:     # the reference routes dead writes to the null block
            got, want = got[:, :-1], want[:, :-1]
        if got.dtype == np.int8:
            _assert_int8_close(got, want)
        else:
            np.testing.assert_allclose(got, want, **MODEL_TOL, err_msg=name)


def _assert_int8_close(got, want):
    """At most one step apart, and only where a projection rounds across a
    boundary: a rare event, never a pattern."""
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() < 1e-3, diff.sum()


@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("weights", list(WEIGHTS))
def test_steps_match_reference(weights, kv):
    """mixed_step (three mixed ticks, idle rows included) then decode_step,
    port and reference on the same scrambled page table: logits and pool
    contents within 1e-4 (int8: see ``INT8_MODEL_TOL``)."""
    jcfg, jparams, tcfg, tparams = _models(weights)
    jcfg = dataclasses.replace(jcfg, **KV[kv])
    tcfg = dataclasses.replace(tcfg, **KV[kv])
    paged = tcfg.kv_layout == "paged"
    tol = INT8_MODEL_TOL if tcfg.kv_quant == "int8" else MODEL_TOL
    rng = np.random.default_rng(0)
    b, c, max_len = 2, 8, 32
    jcache = japi.init_cache(jcfg, b, max_len)
    tcache = api.init_cache(tcfg, b, max_len, "cpu")
    table = None
    if paged:
        n_blocks = jcache["k"].shape[1] - 1
        table = rng.permutation(n_blocks).reshape(b, -1).astype(np.int32)
    jkw = {} if table is None else {"page_table": jnp.asarray(table)}
    tkw = {} if table is None else {"page_table": table}
    jmixed = jax.jit(lambda c, t, n, q: japi.mixed_step(jcfg, jparams, c, t,
                                                        n, q, **jkw))
    for lengths, q_lens in [([0, 0], [8, 5]), ([8, 5], [3, 8]),
                            ([11, 13], [0, 2])]:
        toks = rng.integers(0, jcfg.vocab_size, (b, c)).astype(np.int32)
        jl, jcache = jmixed(jcache, jnp.asarray(toks),
                            jnp.asarray(lengths, jnp.int32),
                            jnp.asarray(q_lens, jnp.int32))
        tl, tcache = api.mixed_step(tcfg, tparams, tcache,
                                    torch.from_numpy(toks).long(), lengths,
                                    q_lens, **tkw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    _assert_cache_close(tcache, jcache, paged)
    lengths = np.asarray([12, 16], np.int32)
    toks = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    jl, jcache = japi.decode_step(jcfg, jparams, jcache, jnp.asarray(toks),
                                  jnp.asarray(lengths), **jkw)
    tl, tcache = api.decode_step(tcfg, tparams, tcache,
                                 torch.from_numpy(toks).long(), lengths,
                                 **tkw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    assert np.array_equal(tl.argmax(-1).numpy(), np.asarray(jl).argmax(-1))
    _assert_cache_close(tcache, jcache, paged)


@pytest.mark.parametrize("kv", list(KV))
def test_mixed_step_equals_sequential_decode(kv):
    """Chunked admission reproduces sequential decode in the port.  On the
    card this is bitwise (``chip_smoke.py`` phase 4, 32 layers); on the CPU
    the plain versions' matmuls change shape with the chunk, so logits hold
    within 1e-5, int8 values within one step and the greedy token is
    equal."""
    _, _, tcfg, tparams = _models("dense")
    tcfg = dataclasses.replace(tcfg, **KV[kv])
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab_size, 13)
    seq = api.init_cache(tcfg, 1, 32, "cpu")
    for t, tok in enumerate(prompt):
        sl, seq = api.decode_step(tcfg, tparams, seq,
                                  torch.tensor([[int(tok)]]), [t + 1])
    mix, length = api.init_cache(tcfg, 1, 32, "cpu"), 0
    while length < len(prompt):
        ql = min(8, len(prompt) - length)
        chunk = np.zeros(8, np.int64)
        chunk[:ql] = prompt[length:length + ql]
        ml, mix = api.mixed_step(tcfg, tparams, mix,
                                 torch.from_numpy(chunk[None]), [length],
                                 [ql])
        length += ql
    np.testing.assert_allclose(ml.numpy(), sl.numpy(), rtol=1e-5, atol=1e-5)
    for name in mix:
        got, want = mix[name].numpy(), seq[name].numpy()
        if got.dtype == np.int8:
            _assert_int8_close(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert int(ml.argmax()) == int(sl.argmax())


def test_rolling_window_on_a_paged_pool_matches_reference():
    """A window no shorter than the pool's span makes the paged pool a
    rolling buffer (position mod span): 24 decode steps through a 16-token
    span, port against reference."""
    jcfg, jparams, tcfg, tparams = _models("dense")
    over = dict(kv_layout="paged", kv_block_size=8, window=16)
    jcfg = dataclasses.replace(jcfg, **over)
    tcfg = dataclasses.replace(tcfg, **over)
    jstep = jax.jit(lambda c, t, n: japi.decode_step(jcfg, jparams, c, t, n))
    jcache = japi.init_cache(jcfg, 1, 16)
    tcache = api.init_cache(tcfg, 1, 16, "cpu")
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, 24)
    for n, tok in enumerate(toks.tolist(), start=1):
        jl, jcache = jstep(jcache, jnp.asarray([[tok]], jnp.int32),
                           jnp.asarray([n], jnp.int32))
        tl, tcache = api.decode_step(tcfg, tparams, tcache,
                                     torch.tensor([[tok]]), [n])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    _assert_cache_close(tcache, jcache, paged=True)


# -- engine --------------------------------------------------------------------

_SOAK = dict(d_model=128, d_ff=256, vocab_size=256, kv_layout="paged",
             kv_block_size=8, kv_pool_blocks=12)
_ENGINES = {}


def _soak_models(kv_quant):
    """The soak's model: ``tests/test_paged_engine.py``'s tiny paged config
    at a W4A16-quantizable width."""
    if kv_quant not in _ENGINES:
        jcfg = jax_smoke_config("qwen-7b", kv_quant=kv_quant, **_SOAK)
        jparams = jax_quantize(japi.init_params(jcfg, jax.random.PRNGKey(0)),
                               "dense")
        tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                            "cpu")
        _ENGINES[kv_quant] = (jcfg, jparams, get_smoke_config(
            "qwen-7b", kv_quant=kv_quant, **_SOAK), tparams)
    return _ENGINES[kv_quant]


def _assert_pool_intact(engine):
    stats = engine.pool_stats()
    assert stats["free"] == stats["total"] == engine.pool_blocks
    assert stats["leased"] == 0 and stats["reserved_outstanding"] == 0
    assert sorted(engine.alloc.free) == list(range(engine.pool_blocks))


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_engine_soak_matches_jax_engine_and_oracle(kv_quant):
    """The reference's soak: 14 requests through 5 slots and a 12-block
    pool (smaller than 5 slots x 6 pages), drained in bursts of 3 ticks
    with the pool invariants checked between them and ``audit()`` on every
    tick.  Streams equal the JAX paged engine's and the port's oracle."""
    jcfg, jparams, tcfg, tparams = _soak_models(kv_quant)
    rng = np.random.default_rng(7)
    work = [(i, rng.integers(0, 256, int(rng.integers(3, 21))).astype(
        np.int32), int(rng.integers(2, 7))) for i in range(14)]
    kw = dict(batch_size=5, max_len=48, chunk_size=8)
    jengine = JaxEngine(jcfg, jparams, **kw)
    engine = Engine(tcfg, tparams, audit_every=1, device="cpu", **kw)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=n) for i, p, n in work]
    for (i, p, n), r in zip(work, reqs):
        jengine.submit(JaxRequest(rid=i, prompt=p, max_new_tokens=n))
        engine.submit(r)
    want = {r.rid: r.output for r in jengine.run()}
    while not all(r.done for r in reqs):
        engine.run(max_steps=3)
        stats = engine.pool_stats()
        assert stats["free"] + stats["leased"] == stats["total"]
        assert stats["reserved_outstanding"] <= stats["free"]
        assert engine.steps < 2000, "engine stopped making progress"
    assert engine.admission_stalls > 0, "the pool lost its pressure"
    assert engine.audits == engine.steps
    assert engine.peak_resident_tokens <= engine.pool_blocks * 8
    _assert_pool_intact(engine)
    assert {r.rid: r.output for r in reqs} == want
    for r in reqs:
        assert r.output == reference_decode(tcfg, tparams, r.prompt,
                                            r.max_new_tokens, max_len=48,
                                            device="cpu"), r.rid


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_slot_reuse_readmission(kv_quant):
    """Batch 2, four requests of different lengths: retired rows readmit a
    different-length prompt into recycled blocks under a new page-table
    assignment; every stream equals the oracle's."""
    _, _, tcfg, tparams = _soak_models(kv_quant)
    tcfg = dataclasses.replace(tcfg, kv_pool_blocks=0)
    rng = np.random.default_rng(11)
    reqs = [Request(rid=i, prompt=rng.integers(0, 256, n).astype(np.int32),
                    max_new_tokens=m)
            for i, (n, m) in enumerate([(4, 2), (9, 8), (13, 3), (6, 4)])]
    engine = Engine(tcfg, tparams, batch_size=2, max_len=40, chunk_size=6,
                    audit_every=1, device="cpu")
    for r in reqs:
        engine.submit(r)
    assert len(engine.run()) == 4
    _assert_pool_intact(engine)
    for r in reqs:
        assert r.output == reference_decode(tcfg, tparams, r.prompt,
                                            r.max_new_tokens, max_len=40,
                                            device="cpu"), r.rid


def test_paged_matches_slot_engine_tokens():
    _, _, tcfg, tparams = _soak_models("none")
    cfg_slot = dataclasses.replace(tcfg, kv_layout="slot", kv_pool_blocks=0)
    cfg_paged = dataclasses.replace(tcfg, kv_pool_blocks=0)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, int(rng.integers(3, 15))).astype(np.int32)
               for _ in range(6)]

    def run(cfg):
        engine = Engine(cfg, tparams, batch_size=3, max_len=32, chunk_size=6,
                        device="cpu")
        reqs = [Request(rid=i, prompt=p, max_new_tokens=3 + (i % 3))
                for i, p in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        engine.run()
        return [r.output for r in reqs]

    assert run(cfg_slot) == run(cfg_paged)


@pytest.mark.parametrize("n_blocks,n_homes", [(12, 1), (11, 4)])
def test_block_allocator_matches_reference(n_blocks, n_homes):
    """A random interleaving of leases (any home or a given one), increfs
    and decrefs drives the port's allocator and the reference's: the same
    blocks come out, the same errors are raised, and ``check()`` holds
    after every step."""
    rng = np.random.default_rng(n_homes)
    port, ref = BlockAllocator(n_blocks, n_homes), JaxAllocator(n_blocks,
                                                               n_homes)
    live: list[int] = []
    for _ in range(300):
        op = rng.integers(0, 4)
        if op == 0 or not live:
            home = None if rng.integers(0, 2) else int(rng.integers(0, n_homes))
            outs = []
            for a in (port, ref):
                try:
                    outs.append(a.lease(home))
                except RuntimeError as e:
                    outs.append(str(e))
            assert outs[0] == outs[1]
            if isinstance(outs[0], int):
                live.append(outs[0])
        elif op == 1:
            blk = live[int(rng.integers(0, len(live)))]
            port.incref(blk)
            ref.incref(blk)
            live.append(blk)
        else:
            blk = live.pop(int(rng.integers(0, len(live))))
            assert port.decref(blk) == ref.decref(blk)
        port.check()
        assert (port.free, port.refs) == (ref.free, ref.refs)
        assert port.free_by_home() == ref.free_by_home()
        assert (port.n_free, port.n_live) == (ref.n_free, ref.n_live)
    with pytest.raises(RuntimeError, match="incref of dead"):
        port.incref(port.free[0])
    with pytest.raises(RuntimeError, match="double free"):
        port.decref(port.free[0])
    with pytest.raises(ValueError, match="split evenly"):
        BlockAllocator(12, 5)


def _alloc_engine(**over):
    _, _, tcfg, tparams = _soak_models("none")
    return Engine(dataclasses.replace(tcfg, **over), tparams, batch_size=3,
                  max_len=32, chunk_size=4, device="cpu")


def test_oversized_request_rejected_at_submit():
    engine = _alloc_engine(kv_pool_blocks=2)        # 16-token pool
    with pytest.raises(ValueError, match="KV blocks"):
        engine.submit(Request(rid=0, prompt=np.arange(20, dtype=np.int32),
                              max_new_tokens=8))


def test_double_free_detected():
    engine = _alloc_engine(kv_pool_blocks=0)
    engine._slots[0].req = Request(rid=0, prompt=np.arange(4, dtype=np.int32))
    engine._slot_reserve[0] = 2
    engine._lease_to(0, 9)                          # 2 blocks
    engine._slot_blocks[0].append(engine.alloc.free[0])   # corrupt: alias
    with pytest.raises(RuntimeError, match="double free"):
        engine._free_slot(0)


def test_lease_respects_page_table():
    engine = _alloc_engine(kv_pool_blocks=0)
    engine._slots[0].req = Request(rid=0, prompt=np.arange(4, dtype=np.int32))
    engine._slot_reserve[0] = 3
    engine._lease_to(0, 17)                         # 3 blocks (bs=8)
    owned = engine._slot_blocks[0]
    assert len(owned) == 3 and len(set(owned)) == 3
    np.testing.assert_array_equal(engine._page_table[0, :3], owned)
    assert (engine._page_table[0, 3:] == engine._null_block).all()
    assert (engine._page_table[1:] == engine._null_block).all()
    engine.audit()
    with pytest.raises(RuntimeError, match="past its reservation"):
        engine._lease_to(0, 25)
    engine._free_slot(0)
    assert (engine._page_table[0] == engine._null_block).all()
    _assert_pool_intact(engine)


def test_launcher_serves_a_paged_pool_on_cpu(capsys):
    serve.main(["--device", "cpu", "--kv-layout", "paged",
                "--kv-pool-blocks", "12", "--requests", "4",
                "--max-new-tokens", "3", "--batch", "2", "--max-len", "64"])
    out = capsys.readouterr().out
    assert "'completed': 4" in out and "NOT drained" not in out
    line = next(ln for ln in out.splitlines() if ln.startswith("paged KV:"))
    assert "12 blocks x 16 tokens" in line and "'free': 12" in line
    assert "'total': 12" in line
