"""The fused glue of the port's serving steps, on the CPU.

* ``ops.add_rmsnorm`` and ``ops.add_layernorm`` (the residual add fused
  into the norm after it): their plain versions against the reference's
  ``x + h`` then ``repro.models.layers.rmsnorm`` / ``layernorm``, and
  bitwise the port's former composition; ``layers.add_norm`` takes them
  on both norms.
* ``ops.qkv_rope_write`` (the q/k/v epilogue: bias, RoPE, int8 quantizing,
  the cache write and q's layout): its plain version against the
  reference's ``_project_qkv`` tail, ``quantize_kv`` and its cache writers
  (``repro/models/attention.py:38-55``, ``:215-220``, ``:139``, ``:153``,
  ``:269``), slot and paged, fp and int8, and bitwise the port's former
  chain.
* The RoPE table the epilogue's kernel reads: rows bitwise ``apply_rope``'s
  cos / sin, sized from host integers (the cache's logical span).
* On the card's dispatch (``ops._resolve`` answering "cuda") a mixed and a
  decode step reach the fused kernels, ``2L`` ``add_rmsnorm`` and one
  ``rmsnorm`` (on starcoder2-7b ``add_layernorm`` and ``layernorm``) and
  ``L`` epilogues a step, and run no ``torch.cos``, ``torch.sin``,
  ``torch.cat`` and no residual or bias add; a rolling window's decode,
  whose positions run past that table, keeps the unfused chain.
  ``forward``, ``prefill`` and the chunked prefill put every residual add
  into a norm's launch on both norms (RoPE and the q/k/v bias stay apart
  there), and their logits and caches stay within 1e-4 of the
  reference's.

Tolerances: float32 values through two libraries' cos / sin / rsqrt,
1e-5 relative; int8 values may differ by one step where a value rounds
across a boundary in the other library (the bound ``tests/
test_torch_paged.py`` keeps), scales 1e-6 relative."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import kv_write as kvw  # noqa: E402
from repro_torch.kernels import layernorm as ln  # noqa: E402
from repro_torch.kernels import ops, rope  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.models import api, attention, layers  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

F32_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    return t.contiguous().view(torch.uint8)


def _equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        _bits(a), _bits(b))


def _normal(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


# -- add_rmsnorm --------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1, 64), (4, 128), (7, 200), (3, 4096)])
def test_add_rmsnorm_plain_matches_reference(rows, d, dtype):
    """``(s, n)``: s bitwise ``x + h``, n bitwise the port's former
    ``rmsnorm(x + h)`` and, in float32, within 1e-5 of the reference's."""
    rng = np.random.default_rng(rows * d)
    x, h = _normal(rng, rows, d), _normal(rng, rows, d)
    g = 1 + 0.1 * _normal(rng, d)
    tx, th, tg = (torch.from_numpy(a).to(dtype) for a in (x, h, g))
    s, n = ops.add_rmsnorm(tx, th, tg)
    assert _equal(s, tx + th)
    assert _equal(n, layers.rmsnorm(tx + th, tg))
    none, n2 = ops.add_rmsnorm(tx, th, tg, keep_sum=False)
    assert none is None and _equal(n2, n)
    if dtype == torch.float32:
        want = np.asarray(jlayers.rmsnorm(jnp.asarray(x) + jnp.asarray(h),
                                          jnp.asarray(g)))
        np.testing.assert_allclose(n.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL)


# -- add_layernorm ------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1, 64), (4, 144), (7, 200), (3, 4608)])
def test_add_layernorm_plain_matches_reference(rows, d, dtype):
    """``(s, n)``: s bitwise ``x + h``, n bitwise the port's former
    ``layernorm(x + h)`` and, in float32, within 1e-5 of the reference's
    (rows of mean 1 and spread 3, so the two passes matter)."""
    rng = np.random.default_rng(rows * d + 1)
    x, h = 3 * _normal(rng, rows, d) + 1, _normal(rng, rows, d)
    g, b = 1 + 0.1 * _normal(rng, d), 0.1 * _normal(rng, d)
    tx, th, tg, tb = (torch.from_numpy(a).to(dtype) for a in (x, h, g, b))
    s, n = ops.add_layernorm(tx, th, tg, tb)
    assert _equal(s, tx + th)
    assert _equal(n, layers.layernorm(tx + th, tg, tb))
    none, n2 = ops.add_layernorm(tx, th, tg, tb, keep_sum=False)
    assert none is None and _equal(n2, n)
    if dtype == torch.float32:
        want = np.asarray(jlayers.layernorm(
            jnp.asarray(x) + jnp.asarray(h), jnp.asarray(g), jnp.asarray(b)))
        np.testing.assert_allclose(n.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL)


@pytest.mark.parametrize("arch", ["qwen-7b", "starcoder2-7b"])
def test_add_norm_takes_the_fused_op_on_both_norms(arch):
    """``layers.add_norm`` is ``(x + h, norm(x + h))`` bitwise on RMSNorm
    and LayerNorm configs, the sum None unless kept."""
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(3)
    x, h = (torch.from_numpy(_normal(rng, 2, 3, cfg.d_model))
            for _ in range(2))
    p = {"gamma": torch.from_numpy(1 + _normal(rng, cfg.d_model))}
    if cfg.norm == "layernorm":
        p["beta"] = torch.from_numpy(_normal(rng, cfg.d_model))
    want = layers.apply_norm(cfg, p, x + h)
    s, n = layers.add_norm(cfg, p, x, h)
    assert _equal(s, x + h) and _equal(n, want)
    none, n = layers.add_norm(cfg, p, x, h, keep_sum=False)
    assert none is None and _equal(n, want)


# -- the q/k/v epilogue -------------------------------------------------------

B, C, HQ, HKV, HD = 3, 6, 4, 2, 8
SPAN, BS, N_PAGES = 24, 4, 6
THETA = 10000.0


def _epilogue_case(seed, chunk, paged, quant):
    """Raw projections, biases, a random cache (so a stray write shows),
    and the step's index tensors: a mixed chunk with a dead row and ragged
    rows, or (``chunk`` 1) a decode step with a masked row and one row at
    the span's last position."""
    rng = np.random.default_rng(seed)
    q = _normal(rng, B, chunk, HQ * HD)
    k, v = _normal(rng, B, chunk, HKV * HD), _normal(rng, B, chunk, HKV * HD)
    bias = tuple(_normal(rng, h * HD) for h in (HQ, HKV, HKV))
    if chunk == 1:
        rope_base = np.array([5, SPAN - 1, 11], np.int32)
        starts = rope_base
        q_lens = np.array([1, 1, 0], np.int32)
    else:
        q_lens = np.array([chunk, 0, chunk // 2], np.int32)
        starts = np.array([rng.integers(0, SPAN - ql + 1) for ql in q_lens],
                          np.int32)
        rope_base = starts
    lead = (B * N_PAGES + 3, HKV, BS) if paged else (B, HKV, SPAN)
    if quant:
        cache = {"k": rng.integers(-127, 128, (*lead, HD), dtype=np.int8),
                 "v": rng.integers(-127, 128, (*lead, HD), dtype=np.int8),
                 "k_scale": _normal(rng, *lead, 1),
                 "v_scale": _normal(rng, *lead, 1)}
    else:
        cache = {"k": _normal(rng, *lead, HD), "v": _normal(rng, *lead, HD)}
    table = None
    if paged:
        table = rng.permutation(B * N_PAGES + 2)[:B * N_PAGES].reshape(
            B, N_PAGES).astype(np.int32)
    return dict(q=q, k=k, v=v, bias=bias, rope_base=rope_base,
                starts=starts, q_lens=q_lens, cache=cache, table=table)


def _torch_args(case, dtype=torch.float32):
    def t(a):
        if a is None:
            return None
        x = torch.from_numpy(np.array(a))
        return x.to(dtype) if x.dtype == torch.float32 and x.dim() and \
            dtype != torch.float32 else x
    cache = {n: torch.from_numpy(a.copy()) for n, a in case["cache"].items()}
    if dtype != torch.float32 and cache["k"].dtype == torch.float32:
        cache = {n: a.to(dtype) for n, a in cache.items()}
    return (cache, t(case["q"]), t(case["k"]), t(case["v"]),
            tuple(t(b) for b in case["bias"]),
            dict(n_heads=HQ, theta=THETA, rope_base=t(case["rope_base"]),
                 starts=t(case["starts"]),
                 q_lens=t(case["q_lens"]), page_table=t(case["table"])))


def _former_chain(cfg_kv_quant, cache, q, k, v, bias, kw):
    """The serving steps' chain before the epilogue, as the attention
    module ran it: ``linear``'s bias adds, the (b, h, s, d) transposes,
    ``apply_rope``, ``_new_kv``'s quantizing, ``kv_write``, and
    ``q.contiguous()``."""
    b, c, _ = q.shape
    q = (q + bias[0].to(q.dtype)).reshape(b, c, HQ, HD).transpose(1, 2)
    k = (k + bias[1].to(k.dtype)).reshape(b, c, HKV, HD).transpose(1, 2)
    v = (v + bias[2].to(v.dtype)).reshape(b, c, HKV, HD).transpose(1, 2)
    pos = kw["rope_base"][:, None] + torch.arange(c, dtype=torch.int32)
    q = layers.apply_rope(q, pos, THETA)
    k = layers.apply_rope(k, pos, THETA)
    if cfg_kv_quant:
        (kq, ks), (vq, vs) = attention.quantize_kv(k), attention.quantize_kv(v)
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k, "v": v}
    ops.kv_write(cache, new, kw["starts"], kw["q_lens"],
                 page_table=kw["page_table"])
    return q.contiguous()


CASES = [(paged, quant, chunk) for paged in (False, True)
         for quant in (False, True) for chunk in (1, C)]
IDS = [f"{'paged' if p else 'slot'}-{'int8' if q else 'fp'}-C{c}"
       for p, q, c in CASES]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paged,quant,chunk", CASES, ids=IDS)
def test_epilogue_plain_is_the_former_chain(paged, quant, chunk, dtype):
    case = _epilogue_case(chunk + 10 * paged + 20 * quant, chunk, paged,
                          quant)
    cache, q, k, v, bias, kw = _torch_args(case, dtype)
    want_cache = {n: t.clone() for n, t in cache.items()}
    want_q = _former_chain(quant, want_cache, q, k, v, bias, kw)
    got_q = ops.qkv_rope_write(cache, q, k, v, bias, **kw)
    assert _equal(got_q, want_q)
    for n in cache:
        assert _equal(cache[n], want_cache[n]), n


def _jax_epilogue(case, quant):
    """The reference's chain on the same numpy inputs: ``linear``'s bias
    add and ``_project_qkv``'s transposes, ``apply_rope``, ``quantize_kv``
    and its writers (the chunk writers; a paged decode's token writer)."""
    j = jnp.asarray
    b, c, _ = case["q"].shape

    def heads(x, bias, h):
        return (j(x) + j(bias)).reshape(b, c, h, HD).transpose(0, 2, 1, 3)
    q = heads(case["q"], case["bias"][0], HQ)
    k = heads(case["k"], case["bias"][1], HKV)
    v = heads(case["v"], case["bias"][2], HKV)
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


@pytest.mark.parametrize("paged,quant,chunk", CASES, ids=IDS)
def test_epilogue_plain_matches_reference(paged, quant, chunk):
    """Float32: q and the K/V leaves within 1e-5 of the reference's; int8
    values within one step, scales within 1e-6.  Paged: the reference
    routes dead positions to the null block, which the port never writes;
    every other block is compared."""
    case = _epilogue_case(chunk + 10 * paged + 20 * quant, chunk, paged,
                          quant)
    cache, q, k, v, bias, kw = _torch_args(case)
    got_q = ops.qkv_rope_write(cache, q, k, v, bias, **kw)
    want_q, want = _jax_epilogue(case, quant)
    np.testing.assert_allclose(got_q.numpy(), want_q, rtol=F32_TOL,
                               atol=F32_TOL)
    keep = slice(None, -1) if paged else slice(None)
    for n, t in cache.items():
        got, ref = t.numpy()[keep], want[n][keep]
        if t.dtype == torch.int8:
            assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1, n
        elif n.endswith("scale"):
            np.testing.assert_allclose(got, ref, rtol=1e-6, err_msg=n)
        else:
            np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL,
                                       err_msg=n)


def test_epilogue_without_rope_or_bias():
    """``theta`` None (``rope_type="none"``) and no biases: the chain is
    the transposes, the quantizing and the write."""
    case = _epilogue_case(7, C, False, True)
    cache, q, k, v, _, kw = _torch_args(case)
    kw["theta"] = None
    want_cache = {n: t.clone() for n, t in cache.items()}
    got_q = ops.qkv_rope_write(cache, q, k, v, (None, None, None), **kw)
    heads = [t.reshape(B, C, h, HD).transpose(1, 2)
             for t, h in ((q, HQ), (k, HKV), (v, HKV))]
    (kq, ks), (vq, vs) = (attention.quantize_kv(t) for t in heads[1:])
    kvw.kv_write_torch(want_cache, {"k": kq, "v": vq, "k_scale": ks,
                                    "v_scale": vs},
                       kw["starts"], kw["q_lens"])
    assert _equal(got_q, heads[0].contiguous())
    for n in cache:
        assert _equal(cache[n], want_cache[n]), n


# -- the RoPE table -----------------------------------------------------------

@pytest.mark.parametrize("hd,theta,rows", [(8, 1e4, 30), (36, 1e5, 41),
                                           (128, 1e4, 513)])
def test_rope_table_rows_are_apply_ropes_cos_sin(hd, theta, rows):
    """Row p of the table is bitwise the cos / sin ``apply_rope`` computes
    for position p (the same operations on the same positions); the table
    is kept per (hd, theta, rows, device)."""
    cos, sin = rope.rope_table(hd, theta, rows, "cpu")
    assert cos.shape == sin.shape == (rows, hd // 2)
    assert cos.dtype == sin.dtype == torch.float32
    pos = torch.arange(rows, dtype=torch.int32)[None]
    angles = rope.rope_angles(pos, hd, theta)
    assert _equal(cos, torch.cos(angles)[0, 0])
    assert _equal(sin, torch.sin(angles)[0, 0])
    assert rope.rope_table(hd, theta, rows, "cpu")[0] is cos
    # apply_rope on a unit vector reads cos and sin back
    x = torch.zeros(1, 1, rows, hd)
    x[..., : hd // 2] = 1.0
    out = rope.apply_rope(x, pos, theta)
    assert _equal(out[0, 0, :, : hd // 2], cos)
    assert _equal(out[0, 0, :, hd // 2:], sin)


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_the_table_covers_the_span_from_host_integers(layout):
    """The epilogue's RoPE table has a Python int of rows, the cache's
    logical span (one table for every step of an engine), and a step that
    keeps ``starts + q_lens <= span`` has every live RoPE position below
    it; only a rolling window's decode runs past it, and says so."""
    over = dict(kv_layout="paged", kv_block_size=8) if layout == "paged" \
        else {}
    cfg = get_smoke_config("qwen-7b", **over)
    cache = api.init_cache(cfg, 3, 40, "cpu")
    layer = {n: t[0] for n, t in cache.items()}
    lengths = torch.tensor([1, 5, 9], dtype=torch.int32)
    mixed = attention.mixed_index(cfg, layer, 3, lengths, lengths)
    decode = attention.decode_index(cfg, layer, 3, lengths)
    rows = kvw.rope_rows(layer["k"], mixed.page_table)
    assert type(rows) is int and rows == 40
    assert _equal(decode.rope_base, lengths - 1)
    assert _equal(decode.starts, lengths - 1)
    assert _equal(mixed.rope_base, mixed.starts)
    assert _equal(mixed.attn_len, lengths + lengths)
    assert not mixed.rolling and not decode.rolling
    windowed = dataclasses.replace(cfg, window=40)
    assert attention.decode_index(windowed, layer, 3, lengths).rolling
    assert not attention.decode_index(dataclasses.replace(cfg, window=39),
                                      layer, 3, lengths).rolling


# -- the card's dispatch ------------------------------------------------------

# name: (arch, overrides of its smoke config)
FAMILIES = {"slot": ("qwen-7b", {}),
            "paged-int8": ("qwen-7b", dict(kv_layout="paged",
                                           kv_block_size=8, kv_quant="int8")),
            "starcoder2": ("starcoder2-7b", {})}


def _family(name):
    arch, over = FAMILIES[name]
    return get_smoke_config(arch, **over)


def _norms(cfg, alone=1, fused=None):
    """The norm launches of a walk over ``cfg``'s layers: ``alone`` norms
    alone and ``fused`` (default 2L) with the residual add before them."""
    fused = 2 * cfg.n_layers if fused is None else fused
    if cfg.norm == "layernorm":
        return {"layernorm": alone, "add_layernorm": fused}
    return {"rmsnorm": alone, "add_rmsnorm": fused}


def _stub_card(monkeypatch, cfg, kv_write):
    """``_resolve`` answering "cuda" and every kernel a serving step reaches
    stubbed; returns the list each stub appends its name to.  ``kv_write``
    is what the old write-only kernel's stub does."""
    calls = []

    def record(name, out):
        def fn(*a, **kw):
            calls.append(name)
            return out(*a, **kw)
        return fn

    def cols(x, w, *a, **kw):
        return torch.zeros(*x.shape[:-1], w.shape[1], dtype=x.dtype)
    monkeypatch.setattr(ops, "_resolve",
                        lambda impl, x: "cuda" if impl == "auto" else impl)
    monkeypatch.setattr(ops, "dense_matmul_cuda",
                        record("dense_matmul", cols))
    monkeypatch.setattr(ops, "ffn_w4a16_cuda", record(
        "ffn", lambda x, *a, **kw: torch.zeros_like(x)))
    monkeypatch.setattr(ops, "mixed_flash_attention_cuda", record(
        "attention", lambda q, *a, **kw: torch.zeros_like(q)))
    monkeypatch.setattr(ops, "kv_write_cuda", record("kv_write", kv_write))
    monkeypatch.setattr(ops, "add_rmsnorm_cuda", record(
        "add_rmsnorm", lambda x, h, g, eps, keep: (
            torch.zeros_like(x) if keep else None, torch.zeros_like(x))))
    monkeypatch.setattr(ops, "qkv_rope_write_cuda", record(
        "qkv_rope_write", lambda cache, q, k, v, bias, **kw: torch.zeros(
            q.shape[0], kw["n_heads"], q.shape[1], cfg.head_dim)))
    monkeypatch.setattr(layers, "_rmsnorm", record(
        "rmsnorm", lambda x, g, eps: torch.zeros_like(x)))
    monkeypatch.setattr(ops, "add_layernorm_cuda", record(
        "add_layernorm", lambda x, h, g, b, eps, keep: (
            torch.zeros_like(x) if keep else None, torch.zeros_like(x))))
    monkeypatch.setattr(ops, "layernorm_cuda", record(
        "layernorm", lambda x, g, b, eps: torch.zeros_like(x)))
    monkeypatch.setattr(ops, "flash_attention_cuda", record(
        "flash_attention", lambda q, *a, **kw: torch.zeros_like(q)))
    return calls


def _count(calls):
    return {k: calls.count(k) for k in set(calls)}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_card_dispatch_reaches_the_fused_kernels(name, monkeypatch):
    """With ``_resolve`` answering "cuda" (every kernel stubbed), a mixed
    and a decode step launch ``add_rmsnorm`` 2L times and ``rmsnorm`` once
    (LayerNorm: ``add_layernorm`` and ``layernorm``), the epilogue L times,
    and ``kv_write`` never; ``torch.cos``, ``torch.sin``, ``torch.cat`` and
    a tensor add of an activation (a residual or a bias add) raise if
    anything calls them."""
    cfg = _family(name)
    params = api.init_params(cfg, torch.Generator().manual_seed(0))

    def refuse(*a, **kw):
        raise AssertionError("RoPE, a concatenation or an activation add "
                             "ran outside the fused kernels")
    real_add = torch.Tensor.__add__

    def add(self, other):
        if isinstance(other, torch.Tensor) and self.dim() >= 3 and \
                other.dim() >= 1 and self.is_floating_point():
            refuse()
        return real_add(self, other)
    calls = _stub_card(monkeypatch, cfg, refuse)
    for attr in ("cos", "sin", "cat"):
        monkeypatch.setattr(torch, attr, refuse)
    monkeypatch.setattr(torch.Tensor, "__add__", add)
    b, c = 3, 8
    cache = api.init_cache(cfg, b, 32, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (b, c),
                           generator=torch.Generator().manual_seed(1))
    lengths = torch.tensor([3, 0, 9], dtype=torch.int32)
    q_lens = torch.tensor([5, 0, 8], dtype=torch.int32)
    L = cfg.n_layers
    for step in ("mixed", "decode"):
        calls.clear()
        if step == "mixed":
            logits, _ = api.mixed_step(cfg, params, cache, tokens, lengths,
                                       q_lens)
        else:
            logits, _ = api.decode_step(cfg, params, cache, tokens[:, :1],
                                        lengths + 1, write_mask=q_lens > 0)
        assert logits.shape == (b, cfg.vocab_size)
        assert _count(calls) == {**_norms(cfg), "qkv_rope_write": L,
                                 "attention": L, "ffn": L,
                                 "dense_matmul": 4 * L + 1}, (
            step, _count(calls))


@pytest.mark.parametrize("window,rolling", [(16, True), (15, False)])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_rolling_window_decode_keeps_the_unfused_chain(name, window, rolling,
                                                       monkeypatch):
    """On the card's dispatch, a decode step over a rolling window (a
    window no shorter than the 16-token span, positions past the span)
    projects, ropes and writes through the former chain (``kv_write`` L
    times, the epilogue never), as its positions lie outside the
    epilogue's table; a window shorter than the span keeps the epilogue.
    The residual adds stay fused either way."""
    cfg = dataclasses.replace(_family(name), window=window)
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    calls = _stub_card(monkeypatch, cfg, lambda *a, **kw: None)
    cache = api.init_cache(cfg, 2, 16, "cpu")
    tokens = torch.tensor([[3], [4]])
    lengths = torch.tensor([24, 9] if rolling else [16, 9], dtype=torch.int32)
    logits, _ = api.decode_step(cfg, params, cache, tokens, lengths)
    assert logits.shape == (2, cfg.vocab_size)
    L = cfg.n_layers
    write = {"kv_write": L} if rolling else {"qkv_rope_write": L}
    assert _count(calls) == {**_norms(cfg), "attention": L, "ffn": L,
                             "dense_matmul": 4 * L + 1, **write}


def _refuse_residual_adds(monkeypatch):
    """``Tensor.__add__`` of two activations of one shape (a residual add)
    raises; a bias add, RoPE's sums (4-D) and index arithmetic pass."""
    real_add = torch.Tensor.__add__

    def add(self, other):
        if isinstance(other, torch.Tensor) and self.dim() == 3 and \
                other.shape == self.shape and self.is_floating_point():
            raise AssertionError("a residual add ran outside the norms")
        return real_add(self, other)
    monkeypatch.setattr(torch.Tensor, "__add__", add)


@pytest.mark.parametrize("route", ["forward", "prefill", "prefill-chunked"])
@pytest.mark.parametrize("arch", ["qwen-7b", "starcoder2-7b"])
def test_full_sequence_routes_fuse_the_residual_adds(arch, route,
                                                     monkeypatch):
    """On the card's dispatch ``forward`` and ``prefill`` launch the fused
    add + norm 2L times and the norm alone once a call, and run no
    residual add of their own; the chunked prefill (two 8-token chunks)
    does so a chunk, the last chunk's ``x + m`` into ``ln_f`` only once.
    Each layer launches the flash kernel and the FFN once; a prefill
    writes its cache with ``kv_write`` once a layer, the chunked route by
    slices."""
    cfg = get_smoke_config(arch)
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    calls = _stub_card(monkeypatch, cfg, lambda *a, **kw: None)
    _refuse_residual_adds(monkeypatch)
    monkeypatch.setattr(transformer, "PREFILL_CHUNK", 8)
    L, b = cfg.n_layers, 2
    s = 16 if route == "prefill-chunked" else 8
    tokens = torch.randint(0, cfg.vocab_size, (b, s),
                           generator=torch.Generator().manual_seed(1))
    if route == "forward":
        logits, _ = api.forward(cfg, params, {"tokens": tokens})
        assert logits.shape == (b, s, cfg.vocab_size)
    else:
        logits, _ = api.prefill(cfg, params, {"tokens": tokens}, 24)
        assert logits.shape == (b, cfg.vocab_size)
    chunks = s // 8 if route == "prefill-chunked" else 1
    want = {**_norms(cfg, chunks, 2 * L * chunks - chunks + 1),
            "flash_attention": L * chunks, "ffn": L * chunks,
            "dense_matmul": 4 * L * chunks + 1}
    if route == "prefill":
        want["kv_write"] = L
    assert _count(calls) == want


@pytest.mark.parametrize("arch", ["qwen-7b", "starcoder2-7b"])
def test_full_sequence_routes_match_reference(arch):
    """Float32 smoke weights carried from the reference: ``forward``'s
    logits, ``prefill``'s last logits and every cache leaf within 1e-4 of
    the reference's, and ``forward``'s last position within 1e-5 of
    ``prefill``'s (bitwise on the card)."""
    jcfg = jax_smoke_config(arch)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch)
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             (2, 13)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    jl, _ = japi.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    tl, aux = api.forward(cfg, params, {"tokens": tt})
    assert float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    jp, jcache = japi.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                              16)
    tp, tcache = api.prefill(cfg, params, {"tokens": tt}, 16)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tp.numpy(), tl[:, -1].numpy(), rtol=1e-5,
                               atol=1e-5)
    assert sorted(tcache) == sorted(jcache)
    for n, leaf in tcache.items():
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jcache[n]),
                                   rtol=1e-4, atol=1e-4, err_msg=n)


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.ones(2, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rms.add_rmsnorm_cuda(x, x, torch.ones(8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ln.add_layernorm_cuda(x, x, torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ln.layernorm_cuda(x, torch.ones(8), torch.zeros(8))
    case = _epilogue_case(0, C, False, False)
    cache, q, k, v, bias, kw = _torch_args(case)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kvw.qkv_rope_write_cuda(cache, q, k, v, bias, **kw)
