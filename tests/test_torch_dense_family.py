"""The rest of the dense family in the port (qwen1.5-4b, qwen3-8b, gemma-2b)
against the JAX reference, on the CPU.

* Configs: full and smoke, field for field the reference's.
* Models, float32 within 1e-4 (``MODEL_TOL``): each smoke config, and
  gemma-2b-smoke at head dim 256 in both packages, quantized "dense" by
  the reference and carried over by ``interop``: ``mixed_step`` (idle rows
  included) then ``decode_step``, logits and every cache leaf; ``forward``
  and ``prefill`` logits and the prefilled cache; the engine's token
  streams equal to the JAX engine's.
* Kernel 3's plain version at head dim 256, all four variants (slot or
  paged, fp or int8 K/V), decode and a chunk, against
  ``mixed_flash_attention_pallas`` in interpret mode; kernel 7's plain
  version at head dim 256 against ``flash_attention_pallas`` in interpret
  mode, float32 within the kernels' 1e-5 (``KERNEL_TOL``).
* The q/k/v epilogue with ``qk_norm`` (qwen3's per-head RMSNorm of q and k
  between the bias and RoPE): its plain version bitwise the unfused chain
  (``layers.rmsnorm``, ``apply_rope``, ``quantize_kv``, ``kv_write``) in
  float32 and bfloat16, and within 1e-5 of the reference's
  ``_project_qkv`` tail and cache writers (int8 values within one step,
  scales 1e-6 relative).  A numpy model of the epilogue kernel's sum of
  squares (lanes holding pairs (i, i + hd/2), one butterfly a slot, the
  slots' sums in order) against the rmsnorm kernel's (thread i element i,
  one butterfly a warp, the warps in order): bitwise at every head dim the
  kernel takes the norm at.
* The card's dispatch, with the device resolution patched to "cuda": a
  qwen3 step puts the q/k norm inside the epilogue (no ``rmsnorm`` beyond
  layer 0's), a gemma step runs the tied head through ``dense_matmul``.
* The launcher with ``--arch`` for each config; the CUDA wrappers refusing
  float32 at head dim 256 in kernel 3, float32 at 112 and an uninstantiated
  head dim in kernels 3 and 7, on CPU tensors.

    PYTHONPATH=src python -m pytest tests/test_torch_dense_family.py -q
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
from repro.kernels.decode_flash import mixed_flash_attention_pallas  # noqa: E402,E501
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import kv_write as kvw  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_flash import (  # noqa: E402
    mixed_attention_torch, mixed_flash_attention_cuda)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BLOCK_KV, BLOCK_Q, flash_attention_cuda, flash_attention_torch)
from repro_torch.models import api, attention, layers  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("qwen1.5-4b", "qwen3-8b", "gemma-2b")
# (arch, overrides in both packages): the smoke configs, and gemma's at its
# published head dim
MODELS = {"qwen1.5-4b": ("qwen1.5-4b", {}), "qwen3-8b": ("qwen3-8b", {}),
          "gemma-2b": ("gemma-2b", {}),
          "gemma-2b-hd256": ("gemma-2b", {"head_dim": 256})}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path issues many ops on tiny tensors; under the
    parallel suite intra-op threads wait for each other far longer than the
    work takes, so these tests run the port on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# -- configs -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_mirror_reference(arch):
    for full in (True, False):
        want = (jax_config if full else jax_smoke_config)(arch)
        got = (get_config if full else get_smoke_config)(arch)
        for f in dataclasses.fields(got):
            if f.name == "dtype":
                assert str(got.dtype).split(".")[1] == jnp.dtype(
                    want.dtype).name, arch
            else:
                assert getattr(got, f.name) == getattr(want, f.name), (
                    arch, f.name)
    cfg = get_config(arch)
    assert cfg.family == "dense" and cfg.head_dim in (128, 256)
    # every W4A16 width is whole 128-row groups (kernels 1 and 2)
    assert all(w % 128 == 0 for w in (cfg.d_model, cfg.d_ff,
                                      cfg.n_heads * cfg.head_dim))


# -- models ------------------------------------------------------------------

_CACHE = {}


def _models(name):
    if name not in _CACHE:
        arch, over = MODELS[name]
        jcfg = jax_smoke_config(arch, **over)
        jparams = jax_quantize(japi.init_params(jcfg, jax.random.PRNGKey(0)),
                               "dense")
        tparams = interop.params_from_numpy(
            jax.tree.map(np.asarray, jparams), "cpu")
        _CACHE[name] = (jcfg, jparams, get_smoke_config(arch, **over),
                        tparams)
    return _CACHE[name]


def _assert_cache_close(tcache, jcache):
    assert sorted(tcache) == sorted(jcache)
    for name, leaf in tcache.items():
        got, want = leaf.numpy(), np.asarray(jcache[name])
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, **MODEL_TOL, err_msg=name)


@pytest.mark.parametrize("name", list(MODELS))
def test_steps_match_reference(name):
    """mixed_step (idle rows included), then decode_step: logits and every
    cache leaf within 1e-4 of the reference's."""
    jcfg, jparams, tcfg, tparams = _models(name)
    rng = np.random.default_rng(1)
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
                                    lengths, q_lens)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    _assert_cache_close(tcache, jcache)
    toks = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    jl, jcache = japi.decode_step(jcfg, jparams, jcache, jnp.asarray(toks),
                                  jnp.asarray([12, 16], jnp.int32))
    tl, tcache = api.decode_step(tcfg, tparams, tcache, _t(toks).long(),
                                 [12, 16])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    _assert_cache_close(tcache, jcache)


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_and_prefill_match_reference(name):
    jcfg, jparams, tcfg, tparams = _models(name)
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 19)).astype(np.int32)
    jl, _ = japi.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    tl, taux = api.forward(tcfg, tparams, {"tokens": _t(toks).long()})
    assert tl.shape == (2, 19, jcfg.vocab_size) and float(taux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    jp, jcache = japi.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                              32)
    tp, tcache = api.prefill(tcfg, tparams, {"tokens": _t(toks).long()}, 32)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **MODEL_TOL)
    _assert_cache_close(tcache, jcache)


def _work(vocab, n=6):
    rng = np.random.default_rng(2)
    return [(i, rng.integers(0, vocab, int(rng.integers(3, 20))).astype(
        np.int32), int(rng.integers(2, 8))) for i in range(n)]


@pytest.mark.parametrize("name", list(MODELS))
def test_engine_streams_equal_jax_engine(name):
    jcfg, jparams, tcfg, tparams = _models(name)
    jengine = JaxEngine(jcfg, jparams, batch_size=2, max_len=64,
                        chunk_size=16)
    engine = Engine(tcfg, tparams, batch_size=2, max_len=64, chunk_size=16,
                    device="cpu")
    for rid, prompt, n in _work(jcfg.vocab_size):
        jengine.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=n))
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    want = {r.rid: r.output for r in jengine.run()}
    done = engine.run()
    assert {r.rid: r.output for r in done} == want


# -- kernels 3 and 7 at head dim 256 ------------------------------------------

def _scrambled_pool(rng, leaf, bs, extra=3, fill=2.5):
    """A (b, hkv, S, ...) leaf scattered into a pool of ``bs``-token pages
    under a scrambled table (``extra`` spare blocks, the null block last,
    both holding ``fill``)."""
    b, hkv, s = leaf.shape[:3]
    n_pages = s // bs
    total = b * n_pages + extra
    table = rng.permutation(total)[:b * n_pages].reshape(b, n_pages)
    pool = np.full((total + 1, hkv, bs) + leaf.shape[3:],
                   17 if leaf.dtype == np.int8 else fill, leaf.dtype)
    for r in range(b):
        for p in range(n_pages):
            pool[table[r, p]] = leaf[r, :, p * bs:(p + 1) * bs]
    return pool, table.astype(np.int32)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
@pytest.mark.parametrize("chunk", [None, 8], ids=["decode", "chunk"])
def test_kernel3_plain_at_head_dim_256_matches_pallas(paged, quant, chunk):
    """gemma's shape cut to size: MQA (hq 4 over one KV head), d 256,
    16-token pages; the plain version against the reference's Pallas kernel
    in interpret mode, and paged bitwise the slot walk at the page size."""
    rng = np.random.default_rng(10 * paged + quant + (chunk or 0))
    b, hq, hkv, s, d, bs = 3, 4, 1, 64, 256, 16
    sq = chunk or 1
    q = _normal(rng, b, hq, sq, d)
    k, v = _normal(rng, b, hkv, s, d), _normal(rng, b, hkv, s, d)
    lengths = np.array([sq + 3, s, sq + 40], np.int32)
    q_lens = (np.array([sq, 0, sq // 2], np.int32) if chunk
              else np.ones(b, np.int32))
    leaves = {"k": k, "v": v}
    if quant:
        (kq, ks), (vq, vs) = (jattn.quantize_kv(jnp.asarray(t))
                              for t in (k, v))
        leaves = {"k": np.asarray(kq), "v": np.asarray(vq),
                  "k_scale": np.asarray(ks), "v_scale": np.asarray(vs)}
    table = None
    if paged:
        pools = {}
        for n, a in leaves.items():
            pools[n], table = _scrambled_pool(np.random.default_rng(3), a,
                                              bs)
        cache = pools
    else:
        cache = leaves
    scales = {n: cache[n] for n in ("k_scale", "v_scale") if n in cache}
    kw = {"page_table": table} if paged else {}
    want = mixed_flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(cache["k"]), jnp.asarray(cache["v"]),
        jnp.asarray(lengths), jnp.asarray(q_lens), interpret=True,
        **{n: jnp.asarray(a) for n, a in {**scales, **kw}.items()})
    got = mixed_attention_torch(
        _t(q), _t(cache["k"]), _t(cache["v"]), _t(lengths), _t(q_lens),
        **{n: _t(a) for n, a in {**scales, **kw}.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    if paged:
        slot = mixed_attention_torch(
            _t(q), _t(leaves["k"]), _t(leaves["v"]), _t(lengths),
            _t(q_lens), block_kv=bs,
            **{n: _t(leaves[n]) for n in scales})
        assert torch.equal(got, slot)


@pytest.mark.parametrize("mode", ["causal", "window", "non-causal"])
def test_kernel7_plain_at_head_dim_256_matches_pallas(mode):
    """The TPU kernel's tiles in interpret mode (16 x 32 here), the plain
    version at those tiles and at the CUDA kernel's (64 x 64), and the
    dense oracle, at d 256 with gemma's MQA."""
    causal, window = {"causal": (True, None), "window": (True, 24),
                      "non-causal": (False, None)}[mode]
    rng = np.random.default_rng(len(mode))
    q, k, v = (_normal(rng, 1, 4, 64, 256), _normal(rng, 1, 1, 64, 256),
               _normal(rng, 1, 1, 64, 256))
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=16, block_kv=32, interpret=True))
    for bq, bk in ((16, 32), (BLOCK_Q, BLOCK_KV)):
        got = flash_attention_torch(_t(q), _t(k), _t(v), causal=causal,
                                    window=window, block_q=bq, block_kv=bk)
        np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)
    ref = ops.attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                        impl="ref")
    np.testing.assert_allclose(ref.numpy(), want, **KERNEL_TOL)


def test_cuda_wrappers_refuse_head_dims_their_kernels_lack():
    """Checked before the device: float32 at 256 in kernel 3 (its
    CUDA-core kernel's tiles would need 266 KB of shared memory), float32
    at 112 in kernels 3 and 7 (their CUDA-core kernels split d by 32 and
    16 lanes' chunks of 4), and a head dim no kernel is instantiated at
    (starcoder2-7b-smoke's 36); bf16 at 112 (rows staged 128 wide) and 256
    pass the head-dim check and then meet the device's."""
    one = torch.ones(2, dtype=torch.int32)
    for dtype, d, match in ((torch.float32, 256, "266 KB"),
                            (torch.float32, 112, "head_dim 112"),
                            (torch.bfloat16, 36, "head_dim 36"),
                            (torch.bfloat16, 112, "CUDA tensors"),
                            (torch.bfloat16, 256, "CUDA tensors")):
        q = torch.zeros(2, 4, 1, d, dtype=dtype)
        kv = torch.zeros(2, 1, 16, d, dtype=dtype)
        with pytest.raises(ValueError, match=match):
            mixed_flash_attention_cuda(q, kv, kv, one, one)
    for dtype, d, match in ((torch.float32, 112, "head_dim 112"),
                            (torch.bfloat16, 36, "head_dim 36"),
                            (torch.bfloat16, 112, "CUDA tensors"),
                            (torch.bfloat16, 256, "CUDA tensors")):
        q = torch.zeros(1, 4, 8, d, dtype=dtype)
        kv = torch.zeros(1, 1, 8, d, dtype=dtype)
        with pytest.raises(ValueError, match=match):
            flash_attention_cuda(q, kv, kv)


# -- the epilogue with qk_norm -------------------------------------------------

B, HQ, HKV, HD, SPAN, BS, THETA = 3, 4, 2, 64, 32, 8, 1e6


def _qk_case(seed, chunk, paged, quant):
    """Raw projections, q/k norm gammas (no biases, as qwen3), a random
    cache and a step's index tensors: a chunk with a dead row and a ragged
    row, or a decode step with a masked row and one at the span's end."""
    rng = np.random.default_rng(seed)
    q = _normal(rng, B, chunk, HQ * HD) * 2
    k, v = _normal(rng, B, chunk, HKV * HD), _normal(rng, B, chunk, HKV * HD)
    norms = (1 + 0.2 * _normal(rng, HD), 1 + 0.2 * _normal(rng, HD))
    if chunk == 1:
        rope_base = np.array([5, SPAN - 1, 11], np.int32)
        q_lens = np.array([1, 1, 0], np.int32)
    else:
        q_lens = np.array([chunk, 0, chunk // 2], np.int32)
        rope_base = np.array([rng.integers(0, SPAN - ql + 1)
                              for ql in q_lens], np.int32)
    n_pages = SPAN // BS
    lead = (B * n_pages + 3, HKV, BS) if paged else (B, HKV, SPAN)
    if quant:
        cache = {"k": rng.integers(-127, 128, (*lead, HD), dtype=np.int8),
                 "v": rng.integers(-127, 128, (*lead, HD), dtype=np.int8),
                 "k_scale": _normal(rng, *lead, 1),
                 "v_scale": _normal(rng, *lead, 1)}
    else:
        cache = {"k": _normal(rng, *lead, HD), "v": _normal(rng, *lead, HD)}
    table = (rng.permutation(B * n_pages + 2)[:B * n_pages].reshape(
        B, n_pages).astype(np.int32) if paged else None)
    return dict(q=q, k=k, v=v, norms=norms, rope_base=rope_base,
                starts=rope_base, q_lens=q_lens, cache=cache, table=table)


def _qk_torch(case, dtype):
    def t(a):
        x = _t(a)
        return x.to(dtype) if x.dtype == torch.float32 else x
    cache = {n: _t(a) for n, a in case["cache"].items()}
    if cache["k"].dtype == torch.float32:
        cache = {n: a.to(dtype) for n, a in cache.items()}
    kw = dict(n_heads=HQ, theta=THETA, rope_base=_t(case["rope_base"]),
              starts=_t(case["starts"]), q_lens=_t(case["q_lens"]),
              page_table=None if case["table"] is None else _t(case["table"]),
              q_norm=t(case["norms"][0]), k_norm=t(case["norms"][1]))
    return cache, t(case["q"]), t(case["k"]), t(case["v"]), kw


def _unfused_chain(quant, cache, q, k, v, kw):
    """``_project_qkv``'s chain after the projections, as the serving steps
    ran it for a ``qk_norm`` config before the epilogue took the norm:
    the (b, h, s, d) transposes, ``layers.rmsnorm`` on q and k,
    ``apply_rope``, ``quantize_kv`` and ``kv_write``."""
    b, c, _ = q.shape
    q, k, v = (t.reshape(b, c, h, HD).transpose(1, 2)
               for t, h in ((q, HQ), (k, HKV), (v, HKV)))
    q = layers.rmsnorm(q, kw["q_norm"])
    k = layers.rmsnorm(k, kw["k_norm"])
    pos = kw["rope_base"][:, None] + torch.arange(c, dtype=torch.int32)
    q = layers.apply_rope(q, pos, THETA)
    k = layers.apply_rope(k, pos, THETA)
    if quant:
        (kq, ks), (vq, vs) = attention.quantize_kv(k), attention.quantize_kv(v)
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k, "v": v}
    ops.kv_write(cache, new, kw["starts"], kw["q_lens"],
                 page_table=kw["page_table"])
    return q.contiguous()


QK_CASES = [(paged, quant, chunk) for paged in (False, True)
            for quant in (False, True) for chunk in (1, 8)]
QK_IDS = [f"{'paged' if p else 'slot'}-{'int8' if q else 'fp'}-C{c}"
          for p, q, c in QK_CASES]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paged,quant,chunk", QK_CASES, ids=QK_IDS)
def test_qk_norm_epilogue_plain_is_the_unfused_chain(paged, quant, chunk,
                                                     dtype):
    case = _qk_case(chunk + 10 * paged + 20 * quant, chunk, paged, quant)
    cache, q, k, v, kw = _qk_torch(case, dtype)
    want_cache = {n: a.clone() for n, a in cache.items()}
    want_q = _unfused_chain(quant, want_cache, q, k, v, kw)
    got_q = ops.qkv_rope_write(cache, q, k, v, (None, None, None), **kw)
    assert got_q.dtype == want_q.dtype and torch.equal(got_q, want_q)
    for n in cache:
        assert torch.equal(cache[n], want_cache[n]), n


def _jax_qk_epilogue(case, quant):
    """The reference's ``_project_qkv`` tail (transposes, ``layers.rmsnorm``
    on q and k, ``apply_rope``), ``quantize_kv`` and its cache writers."""
    j = jnp.asarray
    b, c, _ = case["q"].shape

    def heads(x, h):
        return j(x).reshape(b, c, h, HD).transpose(0, 2, 1, 3)
    q, k, v = heads(case["q"], HQ), heads(case["k"], HKV), heads(case["v"],
                                                                 HKV)
    q = jlayers.rmsnorm(q, j(case["norms"][0]))
    k = jlayers.rmsnorm(k, j(case["norms"][1]))
    pos = j(case["rope_base"])[:, None] + jnp.arange(c, dtype=jnp.int32)
    q = jlayers.apply_rope(q, pos, THETA)
    k = jlayers.apply_rope(k, pos, THETA)
    if quant:
        (kq, ks), (vq, vs) = jattn.quantize_kv(k), jattn.quantize_kv(v)
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k, "v": v}
    out = {}
    starts, q_lens = j(case["starts"]), j(case["q_lens"])
    for n, t in new.items():
        leaf = j(case["cache"][n])
        if case["table"] is None:
            out[n] = jattn._chunk_write(leaf, t, starts, q_lens)
        elif c == 1:
            out[n] = jattn._paged_token_write(leaf, t[:, :, 0],
                                              j(case["table"]), starts,
                                              q_lens > 0)
        else:
            out[n] = jattn._paged_chunk_write(leaf, t, j(case["table"]),
                                              starts, q_lens)
    return np.asarray(q), {n: np.asarray(t) for n, t in out.items()}


@pytest.mark.parametrize("paged,quant,chunk", QK_CASES, ids=QK_IDS)
def test_qk_norm_epilogue_plain_matches_reference(paged, quant, chunk):
    """Float32: q at every live position and the K/V leaves within 1e-5 of
    the reference's; int8 values within one step, scales 1e-6 relative.
    Paged: the reference routes dead positions to the null block, which
    the port never writes; every other block is compared."""
    case = _qk_case(chunk + 10 * paged + 20 * quant, chunk, paged, quant)
    cache, q, k, v, kw = _qk_torch(case, torch.float32)
    got_q = ops.qkv_rope_write(cache, q, k, v, (None, None, None), **kw)
    want_q, want = _jax_qk_epilogue(case, quant)
    for r, n in enumerate(case["q_lens"]):
        np.testing.assert_allclose(got_q.numpy()[r, :, :n],
                                   want_q[r, :, :n], rtol=1e-5, atol=1e-5)
    keep = slice(None, -1) if paged else slice(None)
    for n, t in cache.items():
        got, ref = t.numpy()[keep], want[n][keep]
        if t.dtype == torch.int8:
            assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1, n
        elif n.endswith("scale"):
            np.testing.assert_allclose(got, ref, rtol=1e-6, err_msg=n)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                       err_msg=n)


def _butterfly(lanes):
    """``warp_sum`` of ``common.cuh`` on 32 f32 lanes: xor partners at
    16, 8, 4, 2, 1; every lane ends with lane 0's value."""
    v = lanes.astype(np.float32).copy()
    for m in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ m]).astype(np.float32)
    return v[0]


def _rmsnorm_kernel_sum(row):
    """``csrc/rmsnorm.cu`` on a row of at most 256 values: thread i squares
    element i (one product), each warp of 32 threads butterflies, the 8
    warp sums are added from zero in warp order."""
    sq = np.zeros(256, np.float32)
    sq[:len(row)] = row * row
    total = np.float32(0)
    for w in range(8):
        total = np.float32(total + _butterfly(sq[32 * w:32 * w + 32]))
    return total


def _epilogue_kernel_sum(row):
    """``head_sum_squares`` of ``csrc/kv_write.cu``: lane l holds lo[p] =
    element l + 32 p and hi[p] = element hd/2 + l + 32 p; at hd / 2 >= 32
    each slot is squared and butterflied alone and the sums added lo[0],
    lo[1], ..., hi[0], ...; at hd <= 32 lanes below hd/2 square their
    lo[0], the next hd/2 lanes hi[0] of lane l - hd/2, one butterfly."""
    half = len(row) // 2
    lo = np.zeros((4, 32), np.float32)
    hi = np.zeros((4, 32), np.float32)
    for p in range(4):
        for lane in range(32):
            i = lane + 32 * p
            if i < half:
                lo[p, lane], hi[p, lane] = row[i], row[i + half]
    total = np.float32(0)
    if half >= 32:
        for slots in (lo, hi):
            for p in range(4):
                if 32 * p < half:
                    total = np.float32(
                        total + _butterfly(slots[p] * slots[p]))
    else:
        lanes = np.arange(32)
        h = (hi[0] * hi[0])[(lanes - half) & 31]
        v = np.where(lanes < half, lo[0] * lo[0],
                     np.where(lanes < 2 * half, h, 0)).astype(np.float32)
        total = np.float32(total + _butterfly(v))
    return total


@pytest.mark.parametrize("hd", [8, 32, 64, 128, 256])
def test_epilogue_sums_a_head_in_the_rmsnorm_kernels_order(hd):
    """The q/k norm's sum of squares in the epilogue kernel's lane layout
    is bitwise the rmsnorm kernel's at every head dim it takes (a model of
    the two kernels' orders in numpy f32; the kernels themselves are held
    bitwise on the card)."""
    assert kvw.qk_norm_head_dim_ok(hd)
    rng = np.random.default_rng(hd)
    for _ in range(50):
        row = (rng.normal(size=hd) * rng.choice([1e-3, 1.0, 30.0])).astype(
            np.float32)
        assert _epilogue_kernel_sum(row) == _rmsnorm_kernel_sum(row)
    assert not any(kvw.qk_norm_head_dim_ok(h) for h in (36, 48, 96, 112))


# -- the card's dispatch ---------------------------------------------------------

def _stub_card(monkeypatch, cfg):
    """``_resolve`` answering "cuda" and every kernel a serving step reaches
    stubbed; returns (the names the stubs record, the epilogue's
    keyword arguments)."""
    calls, epilogue_kw = [], []

    def record(name, out):
        def fn(*a, **kw):
            calls.append(name)
            return out(*a, **kw)
        return fn

    def epilogue(cache, q, k, v, bias, **kw):
        epilogue_kw.append(kw)
        return torch.zeros(q.shape[0], kw["n_heads"], q.shape[1],
                           cfg.head_dim)
    monkeypatch.setattr(ops, "_resolve",
                        lambda impl, x: "cuda" if impl == "auto" else impl)
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
    monkeypatch.setattr(ops, "add_rmsnorm_cuda", record(
        "add_rmsnorm", lambda x, h, g, eps, keep: (
            torch.zeros_like(x) if keep else None, torch.zeros_like(x))))
    monkeypatch.setattr(ops, "qkv_rope_write_cuda", record(
        "qkv_rope_write", epilogue))
    monkeypatch.setattr(layers, "_rmsnorm", record(
        "rmsnorm", lambda x, g, eps: torch.zeros_like(x)))
    return calls, epilogue_kw


@pytest.mark.parametrize("name", list(MODELS))
def test_card_dispatch_fuses_the_qk_norm_and_ties_the_head(name,
                                                           monkeypatch):
    """A mixed and a decode step on the card's dispatch: ``rmsnorm`` once
    (layer 0's ``ln_attn``) and ``add_rmsnorm`` 2L, the epilogue L times
    with the layer's q/k norm gammas exactly where the config has them, no
    ``kv_write``, no RoPE (``torch.cos`` / ``sin`` / ``cat`` raise); the
    projections W4A16, the head ``dense_matmul`` where it is tied."""
    _, _, cfg, params = _models(name)

    def refuse(*a, **kw):
        raise AssertionError("RoPE or a concatenation ran outside the "
                             "epilogue")
    calls, epilogue_kw = _stub_card(monkeypatch, cfg)
    for attr in ("cos", "sin", "cat"):
        monkeypatch.setattr(torch, attr, refuse)
    b, c, L = 2, 8, cfg.n_layers
    cache = api.init_cache(cfg, b, 32, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (b, c),
                           generator=torch.Generator().manual_seed(1))
    lengths = torch.tensor([3, 9], dtype=torch.int32)
    q_lens = torch.tensor([5, 8], dtype=torch.int32)
    head = ({"dense_matmul": 1} if cfg.tie_embeddings
            else {"w4a16_matmul": 4 * L + 1})
    for step in ("mixed", "decode"):
        calls.clear()
        epilogue_kw.clear()
        if step == "mixed":
            api.mixed_step(cfg, params, cache, tokens, lengths, q_lens)
        else:
            api.decode_step(cfg, params, cache, tokens[:, :1], lengths + 1)
        want = {"rmsnorm": 1, "add_rmsnorm": 2 * L, "qkv_rope_write": L,
                "attention": L, "ffn": L, "w4a16_matmul": 4 * L, **head}
        assert {n: calls.count(n) for n in set(calls)} == want, step
        for i, kw in enumerate(epilogue_kw):
            for g in ("q_norm", "k_norm"):
                if cfg.qk_norm:
                    assert torch.equal(kw[g], params["blocks"]["attn"][g][i])
                else:
                    assert kw[g] is None


# -- the launcher ------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_each_config_on_cpu(capsys, arch):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--arch", arch, "--strategy", "dense",
                "--requests", "2", "--max-new-tokens", "2", "--batch", "2"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out and "strategy=dense" in out
    assert "'completed': 2" in out
