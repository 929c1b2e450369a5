"""The port's xLSTM family (``ssm``, xlstm-1.3b) against the JAX reference.

* Kernel 8: ``slstm_scan_torch`` (the plain version of
  ``csrc/slstm_scan.cu``) against ``slstm_scan_pallas`` in interpret mode
  and the ``lax.scan`` of ``_slstm_step`` at the reference's own test
  shapes, within its tolerance (2e-4); a 300-step sequence the reference's
  kernel refuses; a carried state composing bitwise; one step from a state
  against ``_slstm_step``; the ``active`` mask.
* The mLSTM's parallel and chunked forms against JAX in float32 (1e-5).
* Model level on ``xlstm-1.3b-smoke`` (float32, weights from the reference
  through numpy), unquantized and "dense" W4A16: ``mlstm_decode``,
  ``slstm_decode``, ``forward`` (the reference with and without its
  kernels), ``decode_step``, ``mixed_step``, ``prefill`` and the cache
  layout within 1e-4; mixed ≡ sequential bitwise; the engine against its
  oracle and the JAX engine, with a reused slot; the compiler, interop and
  the launcher.
"""

import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core.compiler import quantize_model as jax_quantize  # noqa: E402
from repro.core.compiler import quantized_bytes as jax_bytes  # noqa: E402
from repro.kernels.slstm_scan import slstm_scan_pallas  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.models import xlstm_stack as jstack  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.compiler import (  # noqa: E402
    quantize_model, quantized_bytes)
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.kernels import mlstm_cell, ops, slstm_scan  # noqa: E402
from repro_torch.kernels.slstm_scan import fresh_state  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api, xlstm, xlstm_stack  # noqa: E402
from repro_torch.models.xlstm import MLSTM_CHUNK  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    Engine, Request, reference_decode)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SCAN_TOL = 2e-4          # the reference's own kernel tolerance
F32_TOL = 1e-5           # float32 algebra in another library's order
# the reference's own tolerance between its chunked and quadratic mLSTM
# forms (tests/test_archs.py:149): past a few hundred keys the readout sums
# terms far larger than its result, so the summation order shows
CHUNK_TOL = 2e-4
MODEL_TOL = 1e-4         # logits and state through 4 blocks in float32
ARCH = "xlstm-1.3b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path issues many ops on tiny tensors; under the
    parallel suite intra-op threads wait for each other far longer than
    the work takes, so these tests run the port on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# -- kernel 8: the sLSTM scan -------------------------------------------------

def _scan_inputs(b, L, h, dh, seed=None):
    rng = np.random.default_rng(b * L if seed is None else seed)
    gx = rng.normal(0, 1, (b, L, h, 4 * dh)).astype(np.float32)
    r = rng.normal(0, 0.05, (h, dh, 4 * dh)).astype(np.float32)
    bias = rng.normal(0, 0.1, (h, 4 * dh)).astype(np.float32)
    return gx, r, bias


def _jax_scan(gx, r, bias, state=None):
    """The reference's oracle: ``_slstm_step`` under ``lax.scan``."""
    b, _, h, g4 = gx.shape
    p = {"r_gates": jnp.asarray(r), "b_gates": jnp.asarray(bias)}

    def body(st, g):
        new = jx._slstm_step(p, st, g)
        return new, new[2]
    if state is None:
        state = tuple(jnp.zeros((b, h, g4 // 4), jnp.float32)
                      for _ in range(3)) + (
            jnp.full((b, h, g4 // 4), -1e30, jnp.float32),)
    _, hs = jax.lax.scan(body, state, jnp.moveaxis(jnp.asarray(gx), 1, 0))
    return np.asarray(jnp.moveaxis(hs, 0, 1))


@pytest.mark.parametrize("b,L,h,dh,chunk", [
    (2, 64, 4, 32, 16),
    (1, 96, 2, 64, 32),
    (3, 128, 1, 128, 128),
])
def test_slstm_scan_plain_matches_pallas_and_scan(b, L, h, dh, chunk):
    gx, r, bias = _scan_inputs(b, L, h, dh)
    want = _jax_scan(gx, r, bias)
    pallas = np.asarray(slstm_scan_pallas(jnp.asarray(gx), jnp.asarray(r),
                                          jnp.asarray(bias),
                                          time_chunk=chunk))
    got = ops.slstm_scan(_t(gx), _t(r), _t(bias))
    assert got.shape == (b, L, h, dh) and got.dtype == torch.float32
    _close(got, pallas, SCAN_TOL)
    _close(got, want, SCAN_TOL)
    _close(ops.slstm_scan(_t(gx), _t(r), _t(bias), impl="ref"), want,
           SCAN_TOL)


def test_slstm_scan_ragged_length_the_reference_refuses():
    """L = 300 is no multiple of the reference's 256-step time chunk: its
    kernel raises, the port's scan (no time chunk) takes it."""
    gx, r, bias = _scan_inputs(2, 300, 2, 32)
    with pytest.raises(ValueError, match="not a multiple of time_chunk"):
        slstm_scan_pallas(jnp.asarray(gx), jnp.asarray(r), jnp.asarray(bias))
    _close(ops.slstm_scan(_t(gx), _t(r), _t(bias)),
           _jax_scan(gx, r, bias), SCAN_TOL)


def test_slstm_scan_state_composes_bitwise():
    """L = a, then L = b from the carried state, equals L = a + b."""
    gx, r, bias = _scan_inputs(2, 40, 2, 32, seed=5)
    whole = ops.slstm_scan(_t(gx), _t(r), _t(bias))
    state = fresh_state(2, 2, 32, "cpu")
    first = ops.slstm_scan(_t(gx[:, :17]), _t(r), _t(bias), state)
    second = ops.slstm_scan(_t(gx[:, 17:]), _t(r), _t(bias), state)
    assert torch.equal(torch.cat([first, second], dim=1), whole)
    assert torch.equal(state[2], whole[:, -1])      # h is the last output


def test_slstm_scan_one_step_from_a_state_equals_the_reference_step():
    rng = np.random.default_rng(11)
    b, h, dh = 3, 2, 32
    gx, r, bias = _scan_inputs(b, 1, h, dh, seed=12)
    st = [rng.normal(0, 1, (b, h, dh)).astype(np.float32) for _ in range(3)]
    st[1] = np.abs(st[1]) + 0.5                     # n > 0
    st.append(rng.normal(0, 1, (b, h, dh)).astype(np.float32))
    want = jx._slstm_step({"r_gates": jnp.asarray(r),
                           "b_gates": jnp.asarray(bias)},
                          tuple(jnp.asarray(s) for s in st),
                          jnp.asarray(gx[:, 0]))
    state = tuple(_t(s) for s in st)
    hs = ops.slstm_scan(_t(gx), _t(r), _t(bias), state)
    _close(hs[:, 0], want[2], F32_TOL)
    for got, w in zip(state, want):
        _close(got, w, F32_TOL)


def test_slstm_scan_active_mask_keeps_masked_rows_state():
    gx, r, bias = _scan_inputs(3, 4, 2, 16, seed=3)
    state = fresh_state(3, 2, 16, "cpu")
    before = [s.clone() for s in state]
    active = torch.tensor([True, False, True])
    hs = ops.slstm_scan(_t(gx), _t(r), _t(bias), state, active=active)
    alone = ops.slstm_scan(_t(gx[1:2]), _t(r), _t(bias))
    _close(hs[1], alone[0], F32_TOL)             # outputs still computed
    for s, s0 in zip(state, before):
        assert torch.equal(s[1], s0[1]) and not torch.equal(s[0], s0[0])


# -- the kernels' geometry: chosen by shape alone ------------------------------

def test_kernel_choice_depends_on_heads_width_and_dtype_only():
    """``scan_plan`` and ``cell_plan`` take (heads, dh, dtype) and nothing
    else, so no batch size, sequence length or tensor can move a row to
    another kernel; the choice does not follow the head count either."""
    assert list(inspect.signature(slstm_scan.scan_plan).parameters) == [
        "heads", "dh", "r_dtype"]
    assert list(inspect.signature(mlstm_cell.cell_plan).parameters) == [
        "heads", "dh", "dtype"]
    for dh in (32, 64, 96, 512, 544, 1000):
        for dtype in (torch.bfloat16, torch.float32):
            plans = {slstm_scan.scan_plan(h, dh, dtype) for h in (1, 4, 16)}
            assert len(plans) == 1
            cells = {mlstm_cell.cell_plan(h, dh, dtype) for h in (1, 4, 16)}
            assert len(cells) == 1
    served = slstm_scan.scan_plan(4, 512, torch.bfloat16)   # xlstm-1.3b
    assert served.kernel == "cluster" and served.cluster == 16


@pytest.mark.parametrize("dh", [1, 31, 32, 64, 96, 256, 480, 512, 544, 640,
                                1000, 1024])
@pytest.mark.parametrize("r_dtype", [torch.bfloat16, torch.float32])
def test_scan_plan_fits_what_it_asks_for(dh, r_dtype):
    """The cluster kernel: bf16 R, dh a multiple of 32, at most 16 CTAs a
    cluster; its shared memory holds the CTA's R slice (dh x 128 bf16) and
    two h buffers of ``CLUSTER_ROWS`` rows, within a block's limit.  Every
    other shape runs the CUDA-core kernel, one thread a unit."""
    plan = slstm_scan.scan_plan(4, dh, r_dtype)
    if r_dtype == torch.bfloat16 and dh % 32 == 0 and dh <= 512:
        assert plan.kernel == "cluster"
        assert plan.cluster == dh // slstm_scan.CLUSTER_UNITS
        assert 1 <= plan.cluster <= slstm_scan.MAX_CLUSTER == 16
        assert plan.threads == 4 * slstm_scan.CLUSTER_UNITS
        r_slice = dh * plan.threads * 2
        h_bufs = 2 * slstm_scan.CLUSTER_ROWS * dh * 4
        assert plan.smem_bytes == r_slice + h_bufs
        assert plan.smem_bytes <= slstm_scan.SMEM_PER_BLOCK
    else:
        assert plan.kernel == "cuda_core"
        assert plan.cluster == 1 and plan.threads == dh <= 1024
        assert plan.smem_bytes == dh * 4 <= 48 * 1024


def test_cluster_r_layout_is_a_conflict_free_permutation():
    """The cluster kernel's R slot (``r_slot`` in csrc/slstm_scan.cu,
    mirrored here): a permutation of a d-block's 128 columns; 8 lanes
    reading 8 consecutive columns, and 8 lanes writing column cc of
    segments s = 0..7 or 8..15 while copying, each hit 8 different
    16-byte bank groups."""
    def r_slot(c):
        return (c & ~7) | ((c & 7) ^ ((c >> 3) & 7))
    assert sorted(r_slot(c) for c in range(128)) == list(range(128))
    for base in range(0, 128, 8):
        assert len({r_slot(base + i) % 8 for i in range(8)}) == 8
    for cc in range(8):
        for half in (0, 8):
            assert len({r_slot(8 * s + cc) % 8
                        for s in range(half, half + 8)}) == 8


@pytest.mark.parametrize("dh", [1, 3, 96, 98, 512, 600, 1024, 4096])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cell_plan_fits_what_it_asks_for(dh, dtype):
    """4 CTAs a cluster (a portable size), one per quarter of C's rows;
    1024-column tiles; 16-byte rows exactly when dh % 4 == 0; q and
    k / sqrt(dh) plus the static sums stay under 48 KB, so no opt-in."""
    plan = mlstm_cell.cell_plan(4, dh, dtype)
    assert plan.cluster == mlstm_cell.CELL_QUARTERS == 4
    assert plan.grid_x == -(-dh // mlstm_cell.CELL_TILE) * 4
    assert plan.threads * mlstm_cell.CELL_COLS == mlstm_cell.CELL_TILE
    assert plan.vec == (dh % 4 == 0)
    assert plan.smem_bytes == 2 * dh * 4 + mlstm_cell.STATIC_SMEM
    assert plan.smem_bytes <= 48 * 1024


@pytest.mark.parametrize("call", [
    lambda: slstm_scan.scan_plan(4, 0, torch.bfloat16),
    lambda: slstm_scan.scan_plan(4, 1025, torch.bfloat16),
    lambda: slstm_scan.scan_plan(0, 512, torch.bfloat16),
    lambda: slstm_scan.scan_plan(4, 512, torch.float16),
    lambda: mlstm_cell.cell_plan(4, 0, torch.bfloat16),
    lambda: mlstm_cell.cell_plan(4, 4097, torch.float32),
    lambda: mlstm_cell.cell_plan(0, 64, torch.float32),
    lambda: mlstm_cell.cell_plan(4, 64, torch.float16),
])
def test_plans_refuse_shapes_no_kernel_takes(call):
    """A shape neither kernel takes raises; it is never changed to fit."""
    with pytest.raises((ValueError, TypeError)):
        call()


# -- the mLSTM's sequence forms ---------------------------------------------

def _qkv_gates(b, h, L, dh, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(0, 1, (b, h, L, dh)).astype(np.float32)
               for _ in range(3))
    ig = rng.normal(0, 1, (b, h, L)).astype(np.float32)
    fg = rng.normal(2, 1, (b, h, L)).astype(np.float32)
    return q, k, v, ig, fg


@pytest.mark.parametrize("L,chunk", [(64, None), (300, 256), (100, 32)])
def test_mlstm_sequence_forms_match_jax(L, chunk):
    ins = _qkv_gates(2, 2, L, 16, seed=L)
    jins = [jnp.asarray(a) for a in ins]
    tins = [_t(a) for a in ins]
    if chunk is None:
        _close(xlstm._mlstm_parallel(*tins), jx._mlstm_parallel(*jins),
               F32_TOL)
    else:
        want = jx._mlstm_chunked(*jins, chunk=chunk)
        tol = F32_TOL if L <= MLSTM_CHUNK else CHUNK_TOL
        _close(xlstm._mlstm_chunked(*tins, chunk=chunk), want, tol)
        # the chunked form is the quadratic form in O(L * chunk) memory
        _close(xlstm._mlstm_chunked(*tins, chunk=chunk),
               xlstm._mlstm_parallel(*tins), CHUNK_TOL)


# -- model level --------------------------------------------------------------

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


def _jax_cache_to_torch(cache):
    return jax.tree.map(lambda a: _t(np.asarray(a)), cache)


def _close_tree(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in got:
        if isinstance(got[k], dict):
            _close_tree(got[k], want[k], tol)
        else:
            assert tuple(got[k].shape) == tuple(np.shape(want[k])), k
            _close(got[k], want[k], tol)


def _random_state(jcache, seed):
    """A lived-in state: C, n, c, h random, n positive, m finite."""
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a)
        return jnp.asarray(rng.normal(0, 0.5, a.shape).astype(np.float32))
    out = jax.tree.map(fill, jcache)
    for grp in out.values():
        grp["n"] = jnp.abs(grp["n"]) + 0.5
    return out


def test_block_decode_steps_match_jax(model):
    """``mlstm_decode`` and ``slstm_decode`` of one block from a lived-in
    state: outputs and every state leaf."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (3, 1, tcfg.d_model)).astype(np.float32)
    jc = _random_state(jstack.init_cache(jcfg, 3, 16), seed=5)
    for kind, jdec, tdec in (("mlstm_main", jx.mlstm_decode,
                              xlstm.mlstm_decode),
                             ("slstm", jx.slstm_decode, xlstm.slstm_decode)):
        idx = (0, 0) if kind == "mlstm_main" else (0,)

        def pick(tree, i=idx):
            for j in i:
                tree = jax.tree.map(lambda a, j=j: a[j], tree)
            return tree
        jp = jax.tree.map(lambda a: a, pick(jparams[kind]),
                          is_leaf=lambda a: hasattr(a, "packed"))
        want_y, want_c = jdec(jcfg, jp, jnp.asarray(x), pick(jc[kind]))
        tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        tc = _jax_cache_to_torch(pick(jc[kind]))
        got_y, got_c = tdec(tcfg, tp, _t(x), tc)
        _close(got_y, want_y, MODEL_TOL)
        _close_tree(got_c, want_c, MODEL_TOL)


def test_cache_layout_matches_jax(model):
    jcfg, _, tcfg, _ = model
    jc = jstack.init_cache(jcfg, 3, 16)
    tc = api.init_cache(tcfg, 3, 16, "cpu")
    _close_tree(tc, jax.tree.map(np.asarray, jc), 0)
    assert api.cache_slot_axes(tcfg) == japi.cache_slot_axes(jcfg)
    assert not api.has_paged_kv(dataclasses.replace(tcfg, kv_layout="paged"))
    assert api.needs_admission_insert(tcfg)
    assert not api.supports_speculation(tcfg)
    assert not api.supports_prefix_cache(tcfg)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_matches_jax(model, use_kernels):
    """``api.forward`` at L = 64 against the reference's XLA path and its
    Pallas path (interpret mode: kernel 8, and kernel 1 on quantized
    weights)."""
    jcfg, jparams, tcfg, tparams = model
    toks = np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 64))
    want, _ = japi.forward(dataclasses.replace(jcfg, use_kernels=use_kernels),
                           jparams, {"tokens": jnp.asarray(toks)})
    got, aux = api.forward(tcfg, tparams, {"tokens": torch.tensor(toks)})
    assert got.shape == (2, 64, tcfg.vocab_size) and float(aux) == 0.0
    _close(got, want, MODEL_TOL)


def test_decode_and_mixed_steps_match_jax(model):
    """Three rows from a lived-in state: ``decode_step``, then a C = 8
    ``mixed_step`` with q_lens (8, 3, 0): logits and every state leaf."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(7)
    jc = _random_state(jstack.init_cache(jcfg, 3, 32), seed=8)
    tc = _jax_cache_to_torch(jc)
    tok = rng.integers(0, tcfg.vocab_size, (3, 1))
    lengths = np.array([4, 9, 2], np.int32)
    want, jc = japi.decode_step(jcfg, jparams, jc, jnp.asarray(tok),
                                jnp.asarray(lengths))
    got, tc = api.decode_step(tcfg, tparams, tc, torch.tensor(tok),
                              torch.tensor(lengths))
    _close(got, want, MODEL_TOL)
    _close_tree(tc, jax.tree.map(np.asarray, jc), MODEL_TOL)
    chunk = rng.integers(0, tcfg.vocab_size, (3, 8))
    q_lens = np.array([8, 3, 0], np.int32)
    want, jc = japi.mixed_step(jcfg, jparams, jc, jnp.asarray(chunk),
                               jnp.asarray(lengths + 1), jnp.asarray(q_lens))
    idle = {k: {n: t.select(api.cache_slot_axes(tcfg)[k][n], 2).clone()
                for n, t in grp.items()} for k, grp in tc.items()}
    got, tc = api.mixed_step(tcfg, tparams, tc, torch.tensor(chunk),
                             torch.tensor(lengths + 1), torch.tensor(q_lens))
    _close(got, want, MODEL_TOL)
    assert not got[2].any()                      # the idle row's logits
    _close_tree(tc, jax.tree.map(np.asarray, jc), MODEL_TOL)
    for k, grp in tc.items():                    # the idle row, untouched
        for n, t in grp.items():
            assert torch.equal(t.select(api.cache_slot_axes(tcfg)[k][n], 2),
                               idle[k][n])


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


def _leaves(tree):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k])
        else:
            yield tree[k]


def test_mixed_step_equals_sequential_decode_bitwise(model):
    """The port's counterpart of ``tests/test_mixed.py:155`` for xlstm:
    13 tokens in C = 8 chunks equal 13 decode steps, bitwise, on logits and
    every state leaf; C = 1 leaves an idle row untouched."""
    _, _, tcfg, tparams = model
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab_size, 13)
    row = api.request_cache(tcfg, tparams, {}, 32, "cpu")
    sl, scache = _seq_feed(tcfg, tparams, row, prompt)
    ml, mcache = _chunk_feed(tcfg, tparams,
                             api.request_cache(tcfg, tparams, {}, 32, "cpu"),
                             prompt, 8)
    assert torch.equal(sl, ml)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(scache),
                                                 _leaves(mcache)))
    before = [t.clone() for t in _leaves(mcache)]
    lg, mcache = api.mixed_step(tcfg, tparams, mcache, torch.tensor([[5]]),
                                [13], [0])
    assert not lg.any()
    assert all(torch.equal(a, b) for a, b in zip(_leaves(mcache), before))


def test_true_recurrent_prefill(model):
    """The port's counterpart of ``tests/test_mixed.py:173``: the
    post-prompt state depends on the whole prompt, and so do the
    continuations."""
    _, _, tcfg, tparams = model
    rng = np.random.default_rng(1)
    p1 = rng.integers(0, tcfg.vocab_size, 12)
    p2 = rng.integers(0, tcfg.vocab_size, 12)
    p2[-1] = p1[-1]
    fresh = api.request_cache(tcfg, tparams, {}, 32, "cpu")
    _, c1 = _chunk_feed(tcfg, tparams,
                        api.request_cache(tcfg, tparams, {}, 32, "cpu"), p1, 8)
    _, c2 = _chunk_feed(tcfg, tparams,
                        api.request_cache(tcfg, tparams, {}, 32, "cpu"), p2, 8)
    assert any(not torch.equal(a, b) for a, b in zip(_leaves(c1),
                                                     _leaves(fresh)))
    assert any(not torch.equal(a, b) for a, b in zip(_leaves(c1),
                                                     _leaves(c2)))
    o1 = reference_decode(tcfg, tparams, p1, 4, max_len=32, device="cpu")
    o2 = reference_decode(tcfg, tparams, p2, 4, max_len=32, device="cpu")
    assert o1 != o2


def test_prefill_matches_jax_and_forward(model):
    """``api.prefill`` (the bulk scan: true post-prompt state) against
    JAX's, and its logits against ``forward``'s last position."""
    jcfg, jparams, tcfg, tparams = model
    toks = np.random.default_rng(9).integers(0, tcfg.vocab_size, (2, 20))
    want, jc = japi.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, 32)
    got, tc = api.prefill(tcfg, tparams, {"tokens": torch.tensor(toks)}, 32)
    _close(got, want, MODEL_TOL)
    _close_tree(tc, jax.tree.map(np.asarray, jc), MODEL_TOL)
    full, _ = api.forward(tcfg, tparams, {"tokens": torch.tensor(toks)})
    _close(got, full[:, -1], MODEL_TOL)


def test_forms_part_with_depth_in_bf16_in_both_packages():
    """Why ``chip_smoke.py`` holds forward against prefill in float32: at
    16 blocks (d_model 256) the sequence forms and the recurrent steps
    agree within 1e-3 of the largest logit in float32, in the reference and
    in the port, while in bf16 both packages' forms part by more than 5e-2
    (each block divides by max(|q.n|, e^-m), amplifying the previous
    block's rounding)."""
    over = dict(n_layers=16, d_model=256, n_heads=4, slstm_every=8)
    toks = np.random.default_rng(6).integers(0, 256, (1, 64))
    gaps = {}
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jcfg = jax_smoke_config(ARCH, dtype=jdt, **over)
        jp = jax_quantize(japi.init_params(jcfg, jax.random.PRNGKey(0)),
                          "dense")
        full, _ = japi.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
        last, _ = japi.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, 64)
        tcfg = get_smoke_config(ARCH, dtype=tdt, **over)
        tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        tfull, _ = api.forward(tcfg, tp, {"tokens": torch.tensor(toks)})
        tlast, _ = api.prefill(tcfg, tp, {"tokens": torch.tensor(toks)}, 64)
        for pkg, a, b in (("jax", full[:, -1], last),
                          ("port", tfull[:, -1].float(), tlast.float())):
            a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
            gaps[pkg, tdt] = float(np.abs(a - b).max() / np.abs(b).max())
    for pkg in ("jax", "port"):
        assert gaps[pkg, torch.float32] < 1e-3, gaps
        assert gaps[pkg, torch.bfloat16] > 5e-2, gaps


def test_insert_and_evict_slot():
    """The port's ``insert_request`` copies one row in place and
    ``evict_slot`` restores the pristine state (m back to -1e30)."""
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


# -- the engine ---------------------------------------------------------------

def _workload(vocab):
    """``tests/test_serving.py``'s mixed-length workload, prompts drawn
    below the smoke vocabulary."""
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


def test_engine_matches_oracle_and_jax_engine(dense_model):
    jcfg, jparams, tcfg, tparams = dense_model
    work = _workload(tcfg.vocab_size)
    engine = Engine(tcfg, tparams, batch_size=2, max_len=64, chunk_size=16,
                    device="cpu")
    for rid, prompt, n in work:
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    done = engine.run()
    assert done.drained and len(done) == 8 and engine.mixed_ticks > 0
    assert engine.dispatches == engine.steps
    assert engine.dispatched_columns > engine.steps
    streams = {r.rid: r.output for r in done}
    for rid, prompt, n in work:
        assert streams[rid] == reference_decode(
            tcfg, tparams, prompt, n, max_len=64, device="cpu"), rid
    jengine = JaxEngine(jcfg, jparams, batch_size=2, max_len=64,
                        chunk_size=16)
    for rid, prompt, n in work:
        jengine.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=n))
    assert {r.rid: r.output for r in jengine.run()} == streams


def test_reused_slot_is_reset_at_admission(dense_model):
    """One slot, two requests in turn: the second starts from a pristine
    state (the admission reset), so its stream is the oracle's, while the
    slot's state after the first differs from a fresh one."""
    _, _, tcfg, tparams = dense_model
    rng = np.random.default_rng(3)
    a, b = (rng.integers(0, tcfg.vocab_size, 9).astype(np.int32)
            for _ in range(2))
    engine = Engine(tcfg, tparams, batch_size=1, max_len=32, chunk_size=8,
                    device="cpu")
    engine.submit(Request(rid=0, prompt=a, max_new_tokens=4))
    engine.run()
    fresh = api.init_cache(tcfg, 1, 32, "cpu")
    assert any(not torch.equal(x, y) for x, y in zip(_leaves(engine.cache),
                                                     _leaves(fresh)))
    second = Request(rid=1, prompt=b, max_new_tokens=6)
    engine.submit(second)
    engine.run()
    assert second.output == reference_decode(tcfg, tparams, b, 6, max_len=32,
                                             device="cpu")


# -- compiler, interop, launcher ----------------------------------------------

def test_quantize_model_packs_the_reference_leaves_bitwise():
    """The port's compiler on the xLSTM tree (nested ``(seg, blk, in,
    out)`` stacks included) packs exactly the reference's leaves, with
    bitwise-equal ``packed`` and ``scales`` and equal ``quantized_bytes``;
    ``w_i``/``w_f``/``r_gates`` and the norms stay 16-bit."""
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
    assert packed == {"up_x", "up_z", "wq", "wk", "wv", "down", "w_gates",
                      "lm_head"}
    assert tq["mlstm_main"]["wq"].packed.shape[:2] == (2, 1)
    assert quantized_bytes(tq) == jax_bytes(jq)


def _quantized_paths(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _quantized_paths(v, path + (k,))
        elif isinstance(v, QuantizedTensor):
            yield path + (k,)


def _np_leaves(tree, path=()):
    """(path, leaf) of a numpy params tree, packed leaves whole."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _np_leaves(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


def test_interop_roundtrip_keeps_nested_stacks(dense_model):
    """JAX tree -> port -> numpy keeps every leaf bitwise, the nested
    ``(seg, blk, ...)`` packed stacks included."""
    _, jparams, _, tparams = dense_model
    src = dict(_np_leaves(jax.tree.map(np.asarray, jparams)))
    back = dict(_np_leaves(interop.params_to_numpy(tparams)))
    assert sorted(src) == sorted(back)
    for name, leaf in src.items():
        got = back[name]
        if hasattr(leaf, "packed"):
            for attr in ("packed", "scales"):
                a, b = getattr(leaf, attr), getattr(got, attr)
                assert a.dtype == b.dtype and a.shape == b.shape, name
                np.testing.assert_array_equal(a.view(np.uint8),
                                              b.view(np.uint8))
            assert tuple(leaf.shape) == got.shape, name
        else:
            assert leaf.dtype == got.dtype and leaf.shape == got.shape, name
            np.testing.assert_array_equal(leaf, got)
    assert back[("mlstm_main", "up_x")].packed.shape[:2] == (2, 1)


def test_xlstm_stack_init_params_layout():
    tcfg = get_smoke_config(ARCH)
    p = xlstm_stack.init_params(tcfg, torch.Generator().manual_seed(0))
    jp = japi.init_params(jax_smoke_config(ARCH), jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda a: tuple(a.shape), p) == shapes
    assert xlstm_stack._segmentation(get_smoke_config(ARCH)) == (2, 1, 0)


def test_launcher_serves_xlstm_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--max-new-tokens", "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert "arch=xlstm-1.3b-smoke" in out and "'completed': 3" in out
    with pytest.raises(SystemExit, match="no KV cache"):
        serve.main(["--arch", ARCH, "--device", "cpu",
                    "--kv-layout", "paged"])
