"""The port's hybrid family (Zamba2: Mamba2 layers and weight-shared
attention blocks, zamba2-7b) against the JAX reference.

* Configs field by field; the compiler packs ``in_proj`` / ``out_proj``
  and the shared blocks' projections bitwise as the reference does, and
  interop keeps the nested stacks and int4 leaves.
* The Mamba2 step: ``ssm.mamba_decode`` (the ``mamba_cell_gated`` plain
  version: the ``mamba_cell`` plain version, then ``rmsnorm_gated``)
  against the reference's ``mamba_decode`` from a lived-in state, output,
  conv window and state, in float32 and bfloat16; ``mamba_cell_gated``
  bitwise that chain, inactive rows included, and its CUDA wrapper's
  refusals before the device; ``rmsnorm_gated`` bitwise its chain;
  ``_ssd_chunked`` and ``mamba_apply`` against JAX and ``_ssd_chunked``
  against the step-by-step recurrence.
* Model level on ``zamba2-smoke`` (5 layers: 2 segments of 2 and a tail of
  1, d 128, head dim 32, state 16, float32, weights from the reference
  through numpy), unquantized and "dense" W4A16, slot and paged K/V:
  ``forward``, ``decode_step``, ``mixed_step`` and ``prefill`` (every cache
  leaf included) within 1e-4; the cache layout and slot axes; mixed ≡
  sequential bitwise; masked rows untouched; a reused slot reset; the
  engine against its oracle and the JAX engine on both layouts; the
  serving gates' fallbacks; a durable restore; the launcher.
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
from repro.core.compiler import quantized_bytes as jax_bytes  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.compiler import (  # noqa: E402
    quantize_model, quantized_bytes)
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.kernels import mamba_cell, ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api, layers, ssm, zamba  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    Engine, Request, reference_decode)

ARCH = "zamba2-7b"
F32_TOL = 1e-5           # float32 algebra in another library's order
MODEL_TOL = 1e-4         # logits and caches through 5 layers in float32
# bfloat16: one rounding of the conv, of silu and of y may land a step
# apart where the two libraries' f32 values straddle a boundary
BF16_TOL = 2e-2
# the chunked SSD against the recurrence, float32 over 256 steps
CHUNK_TOL = 1e-4
PAGED = dict(kv_layout="paged", kv_block_size=8, kv_pool_blocks=20)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path issues many ops on tiny tensors; under the
    parallel suite intra-op threads wait for each other far longer than
    the work takes, so these tests run the port on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(
        dtype)


def _np(t) -> np.ndarray:
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t,
                      np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _close_tree(got, want, tol):
    assert sorted(got) == sorted(k for k in want if want[k] is not None)
    for k in got:
        if isinstance(got[k], dict):
            _close_tree(got[k], want[k], tol)
        else:
            assert tuple(got[k].shape) == tuple(np.shape(want[k])), k
            _close(got[k], want[k], tol)


def _leaves(tree):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k])
        else:
            yield tree[k]


def _to_torch_tree(tree):
    return jax.tree.map(lambda a: _t(np.asarray(a)), tree)


# -- configs, compiler, interop --------------------------------------------------

@pytest.mark.parametrize("getter", ["full", "smoke"])
def test_configs_match_the_reference_field_by_field(getter):
    tcfg = (get_config if getter == "full" else get_smoke_config)(ARCH)
    jcfg = (jax_config if getter == "full" else jax_smoke_config)(ARCH)
    for f in dataclasses.fields(tcfg):
        want = getattr(jcfg, f.name)
        got = getattr(tcfg, f.name)
        if f.name == "dtype":
            assert str(got).split(".")[1] == jnp.dtype(want).name
        else:
            assert got == want, f.name
    assert (tcfg.d_inner, tcfg.ssm_heads) == (jcfg.d_inner, jcfg.ssm_heads)
    if getter == "full":
        assert (tcfg.d_inner, tcfg.ssm_heads, tcfg.head_dim) == (7168, 112,
                                                                  112)
        assert zamba._segmentation(tcfg) == (6, 13, 3)
    else:
        assert zamba._segmentation(tcfg) == (2, 2, 1)


def test_init_params_layout_matches_jax():
    tcfg = get_smoke_config(ARCH)
    p = api.init_params(tcfg, torch.Generator().manual_seed(0))
    jp = japi.init_params(jax_smoke_config(ARCH), jax.random.PRNGKey(0))
    assert (jax.tree.map(lambda a: tuple(a.shape), p)
            == jax.tree.map(lambda a: tuple(a.shape), jp))
    assert p["mamba_main"]["mamba"]["A_log"].dtype == torch.float32
    assert p["mamba_main"]["mamba"]["conv_w"].dtype == tcfg.dtype


def _quantized_paths(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _quantized_paths(v, path + (k,))
        elif isinstance(v, QuantizedTensor):
            yield path + (k,)


def test_quantize_model_packs_the_reference_leaves_bitwise():
    """The port's compiler on the hybrid tree (the ``(seg, blk, in, out)``
    Mamba stacks and the ``(2, in, out)`` shared blocks) packs exactly the
    reference's leaves, ``packed`` and ``scales`` bitwise, with equal
    ``quantized_bytes``; the conv taps, A_log, D, dt_bias and the norms
    stay in their dtype."""
    jcfg = jax_smoke_config(ARCH)
    jraw = japi.init_params(jcfg, jax.random.PRNGKey(0))
    jq = jax_quantize(jraw, "dense")
    tq = quantize_model(interop.params_from_numpy(
        jax.tree.map(np.asarray, jraw), "cpu"), "dense")
    want = interop.params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")

    def cmp(got, ref, path):
        if isinstance(ref, dict):
            assert sorted(got) == sorted(ref), path
            for k in ref:
                cmp(got[k], ref[k], path + (k,))
        elif isinstance(ref, QuantizedTensor):
            assert isinstance(got, QuantizedTensor), path
            assert got.shape == ref.shape
            assert torch.equal(got.packed, ref.packed), path
            assert torch.equal(got.scales, ref.scales), path
        else:
            assert isinstance(got, torch.Tensor), path
            assert torch.equal(got, ref), path
    cmp(tq, want, ())
    packed = {p[-1] for p in _quantized_paths(tq)}
    assert packed == {"in_proj", "out_proj", "wq", "wk", "wv", "wo", "gate",
                      "up", "down", "lm_head"}
    assert tq["mamba_main"]["mamba"]["in_proj"].packed.shape[:2] == (2, 2)
    assert quantized_bytes(tq) == jax_bytes(jq)


def test_interop_roundtrip_keeps_nested_stacks_and_int4_leaves():
    jq = jax_quantize(japi.init_params(jax_smoke_config(ARCH),
                                       jax.random.PRNGKey(0)), "dense")
    src = jax.tree.map(np.asarray, jq)
    back = interop.params_to_numpy(interop.params_from_numpy(src, "cpu"))

    def walk(a, b, path):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            for k in a:
                walk(a[k], b[k], path + (k,))
        elif hasattr(a, "packed"):
            for attr in ("packed", "scales"):
                x, y = getattr(a, attr), getattr(b, attr)
                assert x.dtype == y.dtype and x.shape == y.shape, path
                np.testing.assert_array_equal(x.view(np.uint8),
                                              y.view(np.uint8))
            assert tuple(a.shape) == tuple(b.shape), path
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(a, b)
    walk(src, back, ())
    assert back["mamba_main"]["mamba"]["in_proj"].packed.shape[:2] == (2, 2)


# -- the Mamba2 step and its kernels' plain versions ------------------------------

def _lived_in_cache(jcfg, b, seed):
    rng = np.random.default_rng(seed)
    c = jssm.mamba_cache_init(jcfg, b)
    return {"conv": jnp.asarray(rng.normal(0, 1, c["conv"].shape)
                                .astype(np.float32)).astype(jcfg.dtype),
            "state": jnp.asarray(rng.normal(0, 0.5, c["state"].shape)
                                 .astype(np.float32))}


def _block_params(jcfg, seed):
    """One Mamba2 block's weights with A_log, D, dt_bias and the conv bias
    drawn at random (the init's constants would hide a wrong axis)."""
    rng = np.random.default_rng(seed)
    p = jssm.mamba_init(jax.random.PRNGKey(seed), jcfg)
    h, conv_dim = jcfg.ssm_heads, jcfg.d_inner + 2 * jcfg.ssm_state
    p["A_log"] = jnp.asarray(rng.normal(0, 0.5, h).astype(np.float32))
    p["D"] = jnp.asarray(rng.normal(1, 0.3, h).astype(np.float32))
    p["dt_bias"] = jnp.asarray(rng.normal(0, 0.5, h).astype(np.float32))
    p["conv_b"] = jnp.asarray(rng.normal(0, 0.1, conv_dim).astype(
        np.float32)).astype(jcfg.dtype)
    p["norm"] = jnp.asarray(rng.normal(1, 0.2, jcfg.d_inner).astype(
        np.float32)).astype(jcfg.dtype)
    return p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_jax(dtype, monkeypatch):
    """``ssm.mamba_decode`` (in_proj, ``ops.mamba_cell_gated``'s plain
    version: the cell, then the gated norm, out_proj) from a lived-in
    window and state against the reference's ``mamba_decode``: output,
    window and state; the step calls the fused op once."""
    calls = []
    fused = ops.mamba_cell_gated
    monkeypatch.setattr(ops, "mamba_cell_gated",
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    jcfg = jax_smoke_config(ARCH, dtype=getattr(jnp, dtype))
    tcfg = get_smoke_config(ARCH, dtype=getattr(torch, dtype))
    tol = F32_TOL * 10 if dtype == "float32" else BF16_TOL
    jp = _block_params(jcfg, 3)
    jc = _lived_in_cache(jcfg, 3, 4)
    x = np.random.default_rng(5).normal(0, 1, (3, 1, tcfg.d_model)).astype(
        np.float32)
    want, wc = jssm.mamba_decode(jcfg, jp, jnp.asarray(x).astype(jcfg.dtype),
                                 jc)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tc = interop.params_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    got, gc = ssm.mamba_decode(tcfg, tp, _t(x, tcfg.dtype), tc)
    assert calls == [1]
    assert got.dtype == tcfg.dtype and gc["conv"].dtype == tcfg.dtype
    _close(got, want, tol)
    _close(gc["conv"], wc["conv"], tol)     # its last tap: in_proj's
    _close(gc["state"], wc["state"], tol)


def _cell_inputs(tcfg, b, seed):
    rng = np.random.default_rng(seed)
    di, n, h, k = (tcfg.d_inner, tcfg.ssm_state, tcfg.ssm_heads,
                   tcfg.ssm_conv)
    conv_dim = di + 2 * n
    f = tcfg.dtype
    return dict(
        proj=_t(rng.normal(0, 1, (b, di + conv_dim + h)), f),
        window=_t(rng.normal(0, 1, (b, k - 1, conv_dim)), f),
        conv_w=_t(rng.normal(0, 0.3, (k, conv_dim)), f),
        conv_b=_t(rng.normal(0, 0.1, conv_dim), f),
        A_log=_t(rng.normal(0, 0.5, h)), D=_t(rng.normal(1, 0.3, h)),
        dt_bias=_t(rng.normal(0, 0.5, h)),
        state=_t(rng.normal(0, 0.5, (b, h, n, tcfg.ssm_head_dim))))


def _run_cell(tcfg, inp, active=None):
    inp = {k: v.clone() for k, v in inp.items()}
    y = ops.mamba_cell(inp["proj"], inp["window"], inp["conv_w"],
                       inp["conv_b"], inp["A_log"], inp["D"], inp["dt_bias"],
                       inp["state"], n_state=tcfg.ssm_state,
                       head_dim=tcfg.ssm_head_dim, active=active)
    return y, inp["window"], inp["state"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_cell_plain_is_the_reference_algebra(dtype):
    """The cell's plain version against the reference's algebra written
    out in numpy float64 (conv, silu, softplus, decay, state, readout):
    y, the shifted window and the state."""
    tcfg = get_smoke_config(ARCH, dtype=getattr(torch, dtype))
    inp = _cell_inputs(tcfg, 3, 7)
    y, win, st = _run_cell(tcfg, inp)
    di, n, h, p = (tcfg.d_inner, tcfg.ssm_state, tcfg.ssm_heads,
                   tcfg.ssm_head_dim)
    a = {k: v.double().numpy() for k, v in inp.items()}
    xbc_new = a["proj"][:, di:2 * di + 2 * n]
    window = np.concatenate([a["window"], xbc_new[:, None]], axis=1)
    conv = (window * a["conv_w"][None]).sum(1) + a["conv_b"]
    xbc = conv / (1 + np.exp(-conv))
    xs = xbc[:, :di].reshape(3, h, p)
    bm, cm = xbc[:, di:di + n], xbc[:, di + n:]
    dt = np.log1p(np.exp(a["proj"][:, 2 * di + 2 * n:] + a["dt_bias"]))
    decay = np.exp(dt * -np.exp(a["A_log"]))
    state = (a["state"] * decay[..., None, None]
             + np.einsum("bh,bn,bhp->bhnp", dt, bm, xs))
    want = np.einsum("bn,bhnp->bhp", cm, state) + a["D"][None, :, None] * xs
    tol = F32_TOL * 10 if dtype == "float32" else BF16_TOL
    _close(y, want.reshape(3, di), tol)
    _close(win, window[:, 1:], 0 if dtype == "float32" else BF16_TOL)
    _close(st, state, tol)


def test_mamba_cell_inactive_rows_keep_window_and_state():
    """Rows outside ``active`` keep their window and state bitwise; their
    y is still computed; the active rows equal a call without a mask."""
    tcfg = get_smoke_config(ARCH)
    inp = _cell_inputs(tcfg, 3, 8)
    active = torch.tensor([True, False, True])
    y, win, st = _run_cell(tcfg, inp, active)
    y_all, win_all, st_all = _run_cell(tcfg, inp)
    assert torch.equal(win[1], inp["window"][1])
    assert torch.equal(st[1], inp["state"][1])
    for r in (0, 2):
        assert torch.equal(win[r], win_all[r])
        assert torch.equal(st[r], st_all[r])
    assert torch.equal(y, y_all)


def test_mamba_cell_cuda_wrapper_refuses_before_the_device():
    tcfg = get_smoke_config(ARCH)
    inp = _cell_inputs(tcfg, 2, 9)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mamba_cell.mamba_cell_cuda(
            *inp.values(), n_state=tcfg.ssm_state,
            head_dim=tcfg.ssm_head_dim)
    assert mamba_cell.cell_shape_ok(64, 64) and mamba_cell.cell_shape_ok(
        16, 32)
    assert not mamba_cell.cell_shape_ok(64, 48)      # 12 groups of 4
    assert not mamba_cell.cell_shape_ok(64, 2048)


def _run_gated(tcfg, inp, gamma, active=None, impl="auto"):
    inp = {k: v.clone() for k, v in inp.items()}
    out = ops.mamba_cell_gated(
        inp["proj"], inp["window"], inp["conv_w"], inp["conv_b"],
        inp["A_log"], inp["D"], inp["dt_bias"], inp["state"], gamma,
        n_state=tcfg.ssm_state, head_dim=tcfg.ssm_head_dim, active=active,
        impl=impl)
    return out, inp["window"], inp["state"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_mamba_cell_gated_plain_is_the_cell_then_the_gated_norm(dtype, masked,
                                                                impl):
    """``ops.mamba_cell_gated`` on the CPU (and its ``"ref"``) is bitwise
    ``mamba_cell`` followed by ``rmsnorm_gated`` on z = the in_proj row's
    first d_inner columns: the gated row, the shifted window and the
    state; an inactive row keeps its window and state."""
    tdt = getattr(torch, dtype)
    tcfg = get_smoke_config(ARCH, dtype=tdt)
    inp = _cell_inputs(tcfg, 3, 11)
    gamma = _t(np.random.default_rng(12).normal(1, 0.2, tcfg.d_inner), tdt)
    active = torch.tensor([True, False, True]) if masked else None
    got, win, st = _run_gated(tcfg, inp, gamma, active, impl)
    y, win_c, st_c = _run_cell(tcfg, inp, active)
    want = ops.rmsnorm_gated(y, gamma, inp["proj"][:, :tcfg.d_inner])
    assert got.dtype == tdt and got.shape == (3, tcfg.d_inner)
    assert torch.equal(got, want)
    assert torch.equal(win, win_c) and torch.equal(st, st_c)
    if masked:
        assert torch.equal(win[1], inp["window"][1])
        assert torch.equal(st[1], inp["state"][1])


def test_mamba_cell_gated_cuda_wrapper_refuses_before_the_device():
    """The fused kernel's widths: the state pass's, a row of whole 16-byte
    groups whose y, gate and gamma the last block stages in 46 KB, and at
    most 47 KB of shared memory (the state tile, B, C, x and y's partials,
    or those three rows); refused widths raise on CPU tensors already, CPU
    tensors of good widths raise for the device."""
    tcfg = get_smoke_config(ARCH, dtype=torch.bfloat16)
    inp = _cell_inputs(tcfg, 2, 13)
    gamma = torch.ones(tcfg.d_inner, dtype=torch.bfloat16)
    kw = dict(n_state=tcfg.ssm_state, head_dim=tcfg.ssm_head_dim)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mamba_cell.mamba_cell_gated_cuda(*inp.values(), gamma, **kw)
    # 3 heads of 4: a 24-byte bf16 row, which the norm's loads cannot take
    h, p, n, k = 3, 4, 5, 4
    conv_dim = h * p + 2 * n
    bf = torch.bfloat16
    ragged = dict(proj=torch.zeros(2, h * p + conv_dim + h, dtype=bf),
                  window=torch.zeros(2, k - 1, conv_dim, dtype=bf),
                  conv_w=torch.zeros(k, conv_dim, dtype=bf),
                  conv_b=torch.zeros(conv_dim, dtype=bf),
                  A_log=torch.zeros(h), D=torch.zeros(h),
                  dt_bias=torch.zeros(h), state=torch.zeros(2, h, n, p))
    with pytest.raises(ValueError, match="16-byte groups"):
        mamba_cell.mamba_cell_gated_cuda(*ragged.values(),
                                         torch.ones(h * p, dtype=bf),
                                         n_state=n, head_dim=p)
    # zamba2-7b's widths in f32: y, the gate and gamma take 84 KB
    f32 = dict(proj=torch.zeros(1, 2 * 7168 + 2 * 64 + 112),
               window=torch.zeros(1, 3, 7168 + 128),
               conv_w=torch.zeros(4, 7168 + 128),
               conv_b=torch.zeros(7168 + 128),
               A_log=torch.zeros(112), D=torch.zeros(112),
               dt_bias=torch.zeros(112), state=torch.zeros(1, 112, 64, 64))
    with pytest.raises(ValueError, match="row of y, the gate and gamma"):
        mamba_cell.mamba_cell_gated_cuda(*f32.values(), torch.ones(7168),
                                         n_state=64, head_dim=64)
    ok = mamba_cell.gated_shape_ok
    assert ok(112, 64, 64, 2) and not ok(112, 64, 64, 4)  # zamba2-7b
    assert ok(tcfg.ssm_heads, tcfg.ssm_state, tcfg.ssm_head_dim, 2)
    assert ok(tcfg.ssm_heads, tcfg.ssm_state, tcfg.ssm_head_dim, 4)
    assert not ok(3, 5, 4, 2)
    assert not ok(8, 128, 128, 4)                        # a 64 KB tile
    assert not ok(112, 64, 48, 2)                        # 12 groups of 4
    # zamba2-7b: bf16 stages y, the gate and gamma (3 x 14 KB)
    assert mamba_cell.gated_smem_bytes(112, 64, 64, 2) == 3 * 7168 * 2
    assert mamba_cell.gated_smem_bytes(8, 16, 32, 4) == 4 * (
        16 * 32 + 2 * 16 + 32 + 16 * 32)                 # the state pass's


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_gated_plain_is_the_chain_bitwise(dtype):
    """``ops.rmsnorm_gated`` on the CPU is ``rmsnorm(y) * F.silu(z)``
    bitwise, z a strided view of an in_proj row as in ``mamba_decode``;
    against the reference's ``rmsnorm(y) * silu(z)`` within tolerance."""
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(10)
    y = _t(rng.normal(0, 1, (4, 256)), tdt)
    proj = _t(rng.normal(0, 2, (4, 600)), tdt)
    z = proj[:, :256]
    g = _t(rng.normal(1, 0.2, 256), tdt)
    got = ops.rmsnorm_gated(y, g, z)
    want = layers.rmsnorm(y, g) * torch.nn.functional.silu(z)
    assert got.dtype == tdt and torch.equal(got, want)
    jdt = getattr(jnp, dtype)
    ref = jlayers.rmsnorm(jnp.asarray(_np(y)).astype(jdt),
                          jnp.asarray(_np(g)).astype(jdt)) * jax.nn.silu(
        jnp.asarray(_np(z)).astype(jdt))
    _close(got, ref, F32_TOL if dtype == "float32" else BF16_TOL)


def _ssd_inputs(b, L, h, p, n, seed):
    rng = np.random.default_rng(seed)
    xs = rng.normal(0, 1, (b, L, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(-1, 0.5, (b, L, h)))).astype(np.float32)
    a = -np.exp(rng.normal(0, 0.3, h)).astype(np.float32)
    bm = rng.normal(0, 1, (b, L, n)).astype(np.float32)
    cm = rng.normal(0, 1, (b, L, n)).astype(np.float32)
    return xs, dt, a, bm, cm


@pytest.mark.parametrize("L,chunk", [(64, 128), (256, 128), (96, 32)])
def test_ssd_chunked_matches_jax_and_the_recurrence(L, chunk):
    xs, dt, a, bm, cm = _ssd_inputs(2, L, 3, 8, 4, L)
    got = ssm._ssd_chunked(*(_t(v) for v in (xs, dt, a, bm, cm)),
                           chunk=chunk)
    want = jssm._ssd_chunked(*(jnp.asarray(v) for v in (xs, dt, a, bm, cm)),
                             chunk=chunk)
    _close(got, want, F32_TOL * 10)
    # the recurrence, step by step in float64
    h = np.zeros((2, 3, 4, 8))
    ys = []
    for t in range(L):
        h = (h * np.exp(dt[:, t] * a)[..., None, None]
             + np.einsum("bh,bn,bhp->bhnp", dt[:, t], bm[:, t], xs[:, t]))
        ys.append(np.einsum("bn,bhnp->bhp", cm[:, t], h))
    _close(got, np.stack(ys, 1), CHUNK_TOL)


def test_ssd_chunked_refuses_a_ragged_length_as_the_reference_asserts():
    xs, dt, a, bm, cm = _ssd_inputs(1, 200, 2, 4, 4, 1)
    with pytest.raises(ValueError, match="multiple"):
        ssm._ssd_chunked(*(_t(v) for v in (xs, dt, a, bm, cm)))
    with pytest.raises(AssertionError):
        jssm._ssd_chunked(*(jnp.asarray(v) for v in (xs, dt, a, bm, cm)))


def test_mamba_apply_matches_jax():
    jcfg = jax_smoke_config(ARCH)
    tcfg = get_smoke_config(ARCH)
    jp = _block_params(jcfg, 11)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(12).normal(0, 1, (2, 128, tcfg.d_model)).astype(
        np.float32)
    _close(ssm.mamba_apply(tcfg, tp, _t(x)),
           jssm.mamba_apply(jcfg, jp, jnp.asarray(x)), F32_TOL * 10)


# -- model level ---------------------------------------------------------------------

@pytest.fixture(scope="module", params=["none", "dense"])
def model(request):
    """(JAX cfg, JAX params, port cfg, port params) for one strategy."""
    jcfg = jax_smoke_config(ARCH)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0))
    if request.param != "none":
        jparams = jax_quantize(jparams, request.param)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    return jcfg, jparams, get_smoke_config(ARCH), tparams


def _layouts(jcfg, tcfg, layout):
    if layout == "paged":
        return (jcfg and dataclasses.replace(jcfg, **PAGED),
                dataclasses.replace(tcfg, **PAGED))
    return jcfg, tcfg


def _kv_blocks(tree, layout):
    """``tree`` with a paged pool's null block (the last, where the
    reference routes a masked row's writes and the port writes nothing)
    left out of ``kv``."""
    if layout != "paged":
        return tree
    return {**tree, "kv": {k: v[:, :-1] for k, v in tree["kv"].items()}}


def _lived_in(jcfg, b, max_len, seed):
    """A reference cache with random Mamba windows and states (its K/V
    comes from the steps)."""
    rng = np.random.default_rng(seed)
    c = japi.init_cache(jcfg, b, max_len)
    for grp in ("mamba_main", "mamba_tail"):
        c[grp] = {k: jnp.asarray(rng.normal(0, 0.5, v.shape).astype(
            np.float32)).astype(v.dtype) for k, v in c[grp].items()}
    return c


def test_cache_layout_and_gates_match_jax():
    for layout in ("slot", "paged"):
        jcfg, tcfg = _layouts(jax_smoke_config(ARCH),
                              get_smoke_config(ARCH), layout)
        jc = japi.init_cache(jcfg, 3, 16)
        tc = api.init_cache(tcfg, 3, 16, "cpu")
        _close_tree(tc, jax.tree.map(np.asarray, jc), 0)
        assert api.cache_slot_axes(tcfg) == {
            k: v for k, v in japi.cache_slot_axes(jcfg).items()
            if v is not None}
        for gate in ("has_paged_kv", "needs_admission_insert",
                     "supports_speculation", "supports_prefix_cache"):
            assert getattr(api, gate)(tcfg) == getattr(japi, gate)(jcfg)
        assert api.has_paged_kv(tcfg) == (layout == "paged")
        assert api.needs_admission_insert(tcfg)
        assert not api.supports_speculation(tcfg)
        assert not api.supports_prefix_cache(tcfg)


def test_forward_matches_jax(model):
    """``api.forward`` at L = 64 against the reference's XLA path."""
    jcfg, jparams, tcfg, tparams = model
    toks = np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 64))
    want, _ = japi.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    got, aux = api.forward(tcfg, tparams, {"tokens": torch.tensor(toks)})
    assert got.shape == (2, 64, tcfg.vocab_size) and float(aux) == 0.0
    _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_decode_and_mixed_steps_match_jax(model, layout):
    """Three rows from lived-in Mamba states: three ``decode_step``s, then
    a C = 8 ``mixed_step`` with q_lens (8, 3, 0): logits and every cache
    leaf (K/V, windows, states; paged: the null block aside)."""
    jcfg, jparams, tcfg, tparams = model
    jcfg, tcfg = _layouts(jcfg, tcfg, layout)
    rng = np.random.default_rng(7)
    jc = _lived_in(jcfg, 3, 32, seed=8)
    tc = _to_torch_tree(jc)
    lengths = np.array([1, 1, 1], np.int32)
    for i in range(3):
        tok = rng.integers(0, tcfg.vocab_size, (3, 1))
        want, jc = japi.decode_step(jcfg, jparams, jc, jnp.asarray(tok),
                                    jnp.asarray(lengths))
        got, tc = api.decode_step(tcfg, tparams, tc, torch.tensor(tok),
                                  torch.tensor(lengths))
        _close(got, want, MODEL_TOL)
        _close_tree(_kv_blocks(tc, layout),
                    _kv_blocks(jax.tree.map(np.asarray, jc), layout),
                    MODEL_TOL)
        lengths = lengths + 1
    chunk = rng.integers(0, tcfg.vocab_size, (3, 8))
    q_lens = np.array([8, 3, 0], np.int32)
    want, jc = japi.mixed_step(jcfg, jparams, jc, jnp.asarray(chunk),
                               jnp.asarray(lengths - 1), jnp.asarray(q_lens))
    got, tc = api.mixed_step(tcfg, tparams, tc, torch.tensor(chunk),
                             torch.tensor(lengths - 1), torch.tensor(q_lens))
    _close(got, want, MODEL_TOL)
    assert not got[2].any()
    _close_tree(_kv_blocks(tc, layout),
                _kv_blocks(jax.tree.map(np.asarray, jc), layout), MODEL_TOL)


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_prefill_matches_jax_and_forward(model, layout):
    """``api.prefill`` (the bulk scan: the true post-prompt state and K/V)
    against the reference's, and its logits against ``forward``'s last
    position (the chunked SSD against the recurrence)."""
    jcfg, jparams, tcfg, tparams = model
    jcfg, tcfg = _layouts(jcfg, tcfg, layout)
    toks = np.random.default_rng(9).integers(0, tcfg.vocab_size, (2, 20))
    want, jc = japi.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, 32)
    got, tc = api.prefill(tcfg, tparams, {"tokens": torch.tensor(toks)}, 32)
    _close(got, want, MODEL_TOL)
    _close_tree(_kv_blocks(tc, layout),
                _kv_blocks(jax.tree.map(np.asarray, jc), layout), MODEL_TOL)
    full, _ = api.forward(tcfg, tparams, {"tokens": torch.tensor(toks)})
    _close(got, full[:, -1], MODEL_TOL)


def test_forms_part_with_depth_in_bf16_in_both_packages():
    """Why ``chip_smoke.py`` records forward against prefill in bf16 on
    zamba2-7b: at 12 layers (zamba2-smoke widths, two shared-block sites) the
    chunked SSD and the recurrent steps agree within 1e-4 of the largest
    logit in float32, in the reference and in the port, while in bf16 both
    packages' forms part by more than 1e-2 (the conv taps summed one at a
    time in bf16 against in f32, the state by chunks against step by
    step, carried down the residual stream)."""
    over = dict(n_layers=12, shared_attn_every=6)
    toks = np.random.default_rng(6).integers(0, 256, (1, 128))
    gaps = {}
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jcfg = jax_smoke_config(ARCH, dtype=jdt, **over)
        jp = jax_quantize(japi.init_params(jcfg, jax.random.PRNGKey(0)),
                          "dense")
        full, _ = japi.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
        last, _ = japi.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, 128)
        tcfg = get_smoke_config(ARCH, dtype=tdt, **over)
        tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        tfull, _ = api.forward(tcfg, tp, {"tokens": torch.tensor(toks)})
        tlast, _ = api.prefill(tcfg, tp, {"tokens": torch.tensor(toks)}, 128)
        for pkg, a, b in (("jax", full[:, -1], last),
                          ("port", tfull[:, -1], tlast)):
            a, b = _np(a), _np(b)
            gaps[pkg, tdt] = float(np.abs(a - b).max() / np.abs(b).max())
    for pkg in ("jax", "port"):
        assert gaps[pkg, torch.float32] < 1e-4, gaps
        assert gaps[pkg, torch.bfloat16] > 1e-2, gaps


def _seq_feed(cfg, params, cache, toks):
    logits = None
    for t, tok in enumerate(toks):
        logits, cache = api.decode_step(cfg, params, cache,
                                        torch.tensor([[int(tok)]]), [t + 1])
    return logits, cache


def _chunk_feed(cfg, params, cache, toks, c):
    logits, length = None, 0
    while length < len(toks):
        ql = min(c, len(toks) - length)
        chunk = np.zeros(c, np.int64)
        chunk[:ql] = toks[length:length + ql]
        logits, cache = api.mixed_step(cfg, params, cache,
                                       torch.tensor(chunk[None]), [length],
                                       [ql])
        length += ql
    return logits, cache


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_mixed_step_equals_sequential_decode_bitwise(model, layout):
    """The port's counterpart of ``tests/test_mixed.py:155`` for
    zamba2-7b: 13 tokens in C = 8 chunks equal 13 decode steps, bitwise, on
    logits and every cache leaf; C = 1 leaves an idle row untouched."""
    _, _, tcfg, tparams = model
    _, tcfg = _layouts(None, tcfg, layout)
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab_size, 13)
    sl, scache = _seq_feed(tcfg, tparams,
                           api.init_cache(tcfg, 1, 32, "cpu"), prompt)
    ml, mcache = _chunk_feed(tcfg, tparams,
                             api.init_cache(tcfg, 1, 32, "cpu"), prompt, 8)
    assert torch.equal(sl, ml)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(scache),
                                                 _leaves(mcache)))
    before = [t.clone() for t in _leaves(mcache)]
    lg, mcache = api.mixed_step(tcfg, tparams, mcache, torch.tensor([[5]]),
                                [13], [0])
    assert not lg.any()
    assert all(torch.equal(a, b) for a, b in zip(_leaves(mcache), before))


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_masked_row_keeps_state_window_and_kv(model, layout):
    """A decode step with row 1 masked leaves its windows, states and K/V
    (slot: its rows; paged: every pool leaf but the other rows' new
    positions) untouched; the live rows equal an unmasked step's."""
    _, _, tcfg, tparams = model
    _, tcfg = _layouts(None, tcfg, layout)
    rng = np.random.default_rng(13)
    cache = api.init_cache(tcfg, 3, 32, "cpu")
    api.mixed_step(tcfg, tparams, cache,
                   torch.tensor(rng.integers(0, tcfg.vocab_size, (3, 8))),
                   [0, 0, 0], [8, 5, 7])
    lengths = torch.tensor([9, 6, 8], dtype=torch.int32)
    tok = torch.tensor(rng.integers(0, tcfg.vocab_size, (3, 1)))
    masked = jax.tree.map(lambda t: t.clone(), cache)
    free = jax.tree.map(lambda t: t.clone(), cache)
    before = jax.tree.map(lambda t: t.clone(), cache)
    mask = torch.tensor([True, False, True])
    lm, masked = api.decode_step(tcfg, tparams, masked, tok, lengths,
                                 write_mask=mask)
    lf, free = api.decode_step(tcfg, tparams, free, tok, lengths)
    assert torch.equal(lm[0], lf[0]) and torch.equal(lm[2], lf[2])
    axes = api.cache_slot_axes(tcfg)
    for grp in ("mamba_main", "mamba_tail"):
        for k, ax in axes[grp].items():
            assert torch.equal(masked[grp][k].select(ax, 1),
                               before[grp][k].select(ax, 1))
            assert not torch.equal(masked[grp][k].select(ax, 0),
                                   before[grp][k].select(ax, 0))
    if layout == "slot":
        for k in masked["kv"]:
            assert torch.equal(masked["kv"][k][:, 1], before["kv"][k][:, 1])
    else:
        # row 1 writes nothing: the masked pool differs from the one
        # before only where the unmasked step's rows 0 and 2 wrote
        for k in masked["kv"]:
            changed = masked["kv"][k] != before["kv"][k]
            both = free["kv"][k] != before["kv"][k]
            assert bool((changed <= both).all())


def test_true_recurrent_prefill(model):
    """The port's counterpart of ``tests/test_mixed.py:173`` for
    zamba2-7b: the post-prompt state depends on the whole prompt, and so do
    the continuations."""
    _, _, tcfg, tparams = model
    rng = np.random.default_rng(1)
    p1 = rng.integers(0, tcfg.vocab_size, 12)
    p2 = rng.integers(0, tcfg.vocab_size, 12)
    p2[-1] = p1[-1]
    fresh = api.init_cache(tcfg, 1, 32, "cpu")
    _, c1 = _chunk_feed(tcfg, tparams, api.init_cache(tcfg, 1, 32, "cpu"),
                        p1, 8)
    _, c2 = _chunk_feed(tcfg, tparams, api.init_cache(tcfg, 1, 32, "cpu"),
                        p2, 8)
    assert any(not torch.equal(a, b) for a, b in zip(
        _leaves(c1["mamba_main"]), _leaves(fresh["mamba_main"])))
    assert any(not torch.equal(a, b) for a, b in zip(
        _leaves(c1["mamba_main"]), _leaves(c2["mamba_main"])))
    o1 = reference_decode(tcfg, tparams, p1, 4, max_len=32, device="cpu")
    o2 = reference_decode(tcfg, tparams, p2, 4, max_len=32, device="cpu")
    assert o1 != o2


def test_insert_and_evict_slot_reset_the_mamba_rows():
    tcfg = get_smoke_config(ARCH)
    cache = api.init_cache(tcfg, 3, 32, "cpu")
    orig = [t.clone() for t in _leaves(cache)]
    row = api.init_cache(tcfg, 1, 32, "cpu")
    for t in _leaves(row):
        t.fill_(1.0)
    api.insert_request(tcfg, cache, row, 1)
    axes = list(_leaves(api.cache_slot_axes(tcfg)))
    for t, o, ax in zip(_leaves(cache), orig, axes):
        assert bool((t.select(ax, 1) == 1).all())
        assert torch.equal(t.select(ax, 0), o.select(ax, 0))
    api.evict_slot(tcfg, cache, 1, 32)
    assert all(torch.equal(t, o) for t, o in zip(_leaves(cache), orig))


# -- the engine ----------------------------------------------------------------------

def _workload(vocab):
    rng = np.random.default_rng(2)
    return [(100 + i,
             rng.integers(0, vocab, int(rng.integers(3, 20))).astype(np.int32),
             int(rng.integers(2, 8)))
            for i in range(8)]


@pytest.fixture(scope="module")
def dense_model():
    jcfg = jax_smoke_config(ARCH)
    jparams = jax_quantize(japi.init_params(jcfg, jax.random.PRNGKey(0)),
                           "dense")
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    return jcfg, jparams, get_smoke_config(ARCH), tparams


def test_card_dispatch_takes_the_fused_step_once_a_layer(dense_model,
                                                         monkeypatch):
    """On the card's dispatch (``ops._resolve`` answering "cuda", the
    kernels stubbed), a decode step and a W = 4 mixed step (its columns
    stepped one at a time) launch ``mamba_cell_gated`` once a Mamba2 layer
    a step and neither of the two kernels it replaced, as
    ``chip_smoke.expected_launches_hybrid`` counts them; ``forward`` gates
    its rows with ``rmsnorm_gated`` once a layer."""
    import chip_smoke
    from repro_torch.kernels import mamba_cell as mc
    from repro_torch.kernels import rmsnorm as rms
    _, _, cfg, params = dense_model
    calls = []

    def record(name, fn):
        def stub(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return stub

    def zeros_q(q, *a, **kw):
        return torch.zeros_like(q)
    monkeypatch.setattr(ops, "_resolve",
                        lambda impl, x: "cuda" if impl == "auto" else impl)
    monkeypatch.setattr(ops, "w4a16_matmul_cuda", record(
        "w4a16_matmul", lambda x, w: torch.zeros(*x.shape[:-1], w.shape[1])))
    monkeypatch.setattr(ops, "ffn_w4a16_cuda", record(
        "ffn", lambda x, *a, **kw: torch.zeros_like(x)))
    monkeypatch.setattr(ops, "mixed_flash_attention_cuda",
                        record("attention", zeros_q))
    monkeypatch.setattr(ops, "flash_attention_cuda",
                        record("flash_attention", zeros_q))
    monkeypatch.setattr(ops, "add_rmsnorm_cuda", record(
        "add_rmsnorm", lambda x, h, g, eps, keep: (
            torch.zeros_like(x) if keep else None, torch.zeros_like(x))))
    monkeypatch.setattr(ops, "qkv_rope_write_cuda", record(
        "qkv_rope_write", lambda cache, q, k, v, bias, **kw: torch.zeros(
            q.shape[0], kw["n_heads"], q.shape[1], cfg.head_dim)))
    monkeypatch.setattr(layers, "_rmsnorm", record(
        "rmsnorm", lambda x, g, eps: torch.zeros_like(x)))
    monkeypatch.setattr(ops, "mamba_cell_gated_cuda", record(
        "mamba_cell_gated", mc.mamba_cell_gated_torch))
    monkeypatch.setattr(ops, "mamba_cell_cuda", record(
        "mamba_cell", mc.mamba_cell_torch))
    monkeypatch.setattr(ops, "rmsnorm_gated_cuda", record(
        "rmsnorm_gated", rms.rmsnorm_gated_torch))
    b, c, L = 2, 4, cfg.n_layers
    cache = api.init_cache(cfg, b, 32, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (b, c),
                           generator=torch.Generator().manual_seed(1))
    lengths = torch.tensor([3, 9], dtype=torch.int32)
    mamba = ("mamba_cell_gated", "mamba_cell", "rmsnorm_gated")
    for steps in (1, c):
        calls.clear()
        if steps == 1:
            api.decode_step(cfg, params, cache, tokens[:, :1], lengths + 1)
        else:
            api.mixed_step(cfg, params, cache, tokens, lengths,
                           torch.tensor([c, 2], dtype=torch.int32))
        want = chip_smoke.expected_launches_hybrid(cfg, params, steps)
        assert {k: calls.count(k) for k in mamba} == {
            k: want.get(k, 0) for k in mamba} == {
            "mamba_cell_gated": L * steps, "mamba_cell": 0,
            "rmsnorm_gated": 0}
    calls.clear()
    api.forward(cfg, params, {"tokens": tokens})
    want = chip_smoke.expected_launches_hybrid(cfg, params, 1,
                                               full_sequence=True)
    assert {k: calls.count(k) for k in mamba} == {
        k: want.get(k, 0) for k in mamba} == {
        "mamba_cell_gated": 0, "mamba_cell": 0, "rmsnorm_gated": L}


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_engine_matches_oracle_and_jax_engine(dense_model, layout):
    jcfg, jparams, tcfg, tparams = dense_model
    jcfg, tcfg = _layouts(jcfg, tcfg, layout)
    work = _workload(tcfg.vocab_size)
    engine = Engine(tcfg, tparams, batch_size=2, max_len=64, chunk_size=16,
                    audit_every=1, device="cpu")
    for rid, prompt, n in work:
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    done = engine.run()
    assert done.drained and len(done) == 8 and engine.mixed_ticks > 0
    assert engine.dispatches == engine.steps
    assert engine.cache_compiles.misses <= engine.compile_budget
    streams = {r.rid: r.output for r in done}
    for rid, prompt, n in work:
        assert streams[rid] == reference_decode(
            tcfg, tparams, prompt, n, max_len=64, device="cpu"), rid
    jengine = JaxEngine(jcfg, jparams, batch_size=2, max_len=64,
                        chunk_size=16)
    for rid, prompt, n in work:
        jengine.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=n))
    assert {r.rid: r.output for r in jengine.run()} == streams
    assert sorted(engine.cache_compiles.keys()) == sorted(
        jengine.cache_compiles.keys())
    if layout == "paged":
        pool = engine.pool_stats()
        assert pool["free"] == pool["total"] and not pool["leased"]


def test_reused_slot_is_reset_at_admission(dense_model):
    """One slot, two requests in turn: the second starts from a pristine
    Mamba state (the admission reset), so its stream is the oracle's."""
    _, _, tcfg, tparams = dense_model
    rng = np.random.default_rng(3)
    a, b = (rng.integers(0, tcfg.vocab_size, 9).astype(np.int32)
            for _ in range(2))
    engine = Engine(tcfg, tparams, batch_size=1, max_len=32, chunk_size=8,
                    device="cpu")
    engine.submit(Request(rid=0, prompt=a, max_new_tokens=4))
    engine.run()
    fresh = api.init_cache(tcfg, 1, 32, "cpu")
    assert any(not torch.equal(x, y) for x, y in zip(
        _leaves(engine.cache["mamba_main"]), _leaves(fresh["mamba_main"])))
    second = Request(rid=1, prompt=b, max_new_tokens=6)
    engine.submit(second)
    engine.run()
    assert second.output == reference_decode(tcfg, tparams, b, 6, max_len=32,
                                             device="cpu")


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_speculation_and_prefix_sharing_fall_back(dense_model, layout):
    """A recurrent state cannot rewind or be shared: ``spec_k`` and
    ``prefix_cache`` fall back to plain decode, as the reference's gates
    say, with the plain engine's streams."""
    jcfg, jparams, tcfg, tparams = dense_model
    jcfg, tcfg = _layouts(jcfg, tcfg, layout)
    work = _workload(tcfg.vocab_size)[:4]
    engine = Engine(tcfg, tparams, batch_size=2, max_len=64, chunk_size=16,
                    spec_k=4, prefix_cache=True, device="cpu")
    jengine = JaxEngine(jcfg, jparams, batch_size=2, max_len=64,
                        chunk_size=16, spec_k=4, prefix_cache=True)
    assert engine.spec_k == 0 and not engine.spec_supported
    assert engine.spec_k == jengine.spec_k
    assert not engine.prefix_sharing
    assert engine.prefix_sharing == jengine.prefix_sharing
    for rid, prompt, n in work:
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    streams = {r.rid: r.output for r in engine.run()}
    for rid, prompt, n in work:
        assert streams[rid] == reference_decode(
            tcfg, tparams, prompt, n, max_len=64, device="cpu"), rid


def test_durable_restore_equals_the_never_killed_engine(dense_model,
                                                        tmp_path):
    """The snapshot code is generic over cache leaves: a hybrid engine
    stopped after 5 ticks and restored from its snapshot and journal
    finishes every request with the oracle's stream."""
    _, _, tcfg, tparams = dense_model
    work = _workload(tcfg.vocab_size)[:5]
    engine = Engine(tcfg, tparams, batch_size=2, max_len=64, chunk_size=16,
                    snapshot_dir=str(tmp_path), snapshot_every=2,
                    device="cpu")
    for rid, prompt, n in work:
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    with pytest.warns(RuntimeWarning, match="max_steps=5"):
        out = {r.rid: r.output for r in engine.run(max_steps=5)}
    restored = Engine.restore(str(tmp_path), tparams, device="cpu",
                              compile_cache=engine.cache_compiles)
    out.update({r.rid: r.output for r in restored.restored_terminal})
    res = restored.run()
    assert res.drained
    out.update({r.rid: r.output for r in res})
    assert out == {rid: reference_decode(tcfg, tparams, prompt, n,
                                         max_len=64, device="cpu")
                   for rid, prompt, n in work}


def test_launcher_serves_zamba_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--max-new-tokens", "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert "arch=zamba2-smoke" in out and "'completed': 3" in out
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                "--max-new-tokens", "2", "--batch", "2", "--kv-layout",
                "paged", "--kv-pool-blocks", "12", "--spec",
                "--prefix-cache"])
    out = capsys.readouterr().out
    assert "'completed': 2" in out
    assert "speculation requested but family 'hybrid'" in out
    assert "prefix cache requested but family 'hybrid'" in out
    with pytest.raises(SystemExit, match="strategy none or dense"):
        serve.main(["--arch", ARCH, "--device", "cpu", "--strategy",
                    "strategy2"])
