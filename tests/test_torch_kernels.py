"""The port's kernel ops against the JAX reference on the CPU.

Each plain PyTorch version (what a CPU tensor runs) is held against the
reference's ``impl="xla"`` twin, its ``impl="ref"`` oracle and the Pallas
kernel in interpret mode, on the same numpy inputs, in float32 with the
2e-4 tolerance the reference's own kernel tests use (sums taken in another
order by another library).  The CUDA kernels themselves are held against
these plain versions on the card (``tests/test_torch_gpu.py`` and
``chip_smoke.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.quant import quantize as jax_quantize  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.decode_flash import mixed_flash_attention_pallas  # noqa: E402
from repro.kernels.ffn_fused import ffn_fused_w4a16_pallas  # noqa: E402
from repro.kernels.w4a16_matmul import w4a16_matmul_pallas  # noqa: E402
from repro.kernels.xla_attention import mixed_attention_blocked  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.sparsity import block_sparsify_quantize  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.decode_flash import (  # noqa: E402
    KV_SPLIT_KEYS, KV_STEP_KEYS, fold_split, kv_block_size,
    mixed_attention_torch, split_span)
from repro_torch.kernels.ffn_fused import ffn_w4a16_torch  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_torch  # noqa: E402
from repro_torch.kernels.sparse_w4a16 import (  # noqa: E402
    sparse_w4a16_matmul_torch)
from repro_torch.kernels.w4a16_matmul import w4a16_matmul_torch  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=2e-4, atol=2e-4)


def _port_qt(jqt):
    return interop.params_from_numpy(
        {"w": jax_tree_np(jqt)}, "cpu")["w"]


def jax_tree_np(jqt):
    return type("QT", (), {"packed": np.asarray(jqt.packed),
                           "scales": np.asarray(jqt.scales),
                           "shape": jqt.shape,
                           "group_size": jqt.group_size})()


def _weights(rng, in_f, out_f):
    w = rng.normal(size=(in_f, out_f)).astype(np.float32) / np.sqrt(in_f)
    jqt = jax_quantize(jnp.asarray(w))
    return jqt, _port_qt(jqt)


# -- w4a16_matmul ------------------------------------------------------------

@pytest.mark.parametrize("tokens", [1, 33])
@pytest.mark.parametrize("out_f", [128, 384, 1024])
def test_w4a16_plain_matches_reference(tokens, out_f):
    rng = np.random.default_rng(tokens * 7 + out_f)
    jqt, tqt = _weights(rng, 256, out_f)
    x = rng.normal(size=(tokens, 256)).astype(np.float32)
    got = w4a16_matmul_torch(torch.from_numpy(x), tqt).numpy()
    jx = jnp.asarray(x)
    for want in (jops.w4a16_matmul(jx, jqt, impl="xla"),
                 w4a16_matmul_pallas(jx, jqt, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got, ops.w4a16_matmul(torch.from_numpy(x), tqt, impl="ref").numpy(),
        **TOL)


def test_w4a16_ragged_out_and_lead_dims():
    """out = 640 (not a multiple of the 512-wide output block): the
    reference's Pallas kernel refuses it, as it refuses qwen-7b's 151936-wide
    lm_head; the port's plain version (and kernel) take it."""
    rng = np.random.default_rng(3)
    jqt, tqt = _weights(rng, 128, 640)
    x = rng.normal(size=(2, 3, 128)).astype(np.float32)
    got = ops.w4a16_matmul(torch.from_numpy(x), tqt)
    assert got.shape == (2, 3, 640)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops.w4a16_matmul(jnp.asarray(x), jqt,
                                                  impl="xla")), **TOL)
    with pytest.raises(ValueError, match="block_out"):
        w4a16_matmul_pallas(jnp.asarray(x), jqt, interpret=True)


# -- ffn ---------------------------------------------------------------------

@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("tokens", [3, 40])
def test_ffn_plain_matches_reference(activation, tokens):
    rng = np.random.default_rng(tokens)
    d, f = 128, 256
    gj, gt = _weights(rng, d, f)
    uj, ut = _weights(rng, d, f)
    dj, dt = _weights(rng, f, d)
    x = rng.normal(size=(tokens, d)).astype(np.float32)
    kw = {}
    if activation == "gelu":
        ub = rng.normal(size=(f,)).astype(np.float32) * 0.1
        db = rng.normal(size=(d,)).astype(np.float32) * 0.1
        kw = {"up_bias": ub, "down_bias": db}
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    got = ffn_w4a16_torch(torch.from_numpy(x), gt, ut, dt,
                          activation=activation, **tkw).numpy()
    jx = jnp.asarray(x)
    wants = [
        jops.ffn_w4a16(jx, gj, uj, dj, activation=activation, impl="xla",
                       **jkw),
        jops.ffn_w4a16(jx, gj, uj, dj, activation=activation, impl="ref",
                       **jkw),
        ffn_fused_w4a16_pallas(jx, gj, uj, dj, activation=activation,
                               interpret=True, **jkw),
    ]
    for want in wants:
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


# -- attention ---------------------------------------------------------------

def _attn_operands(*, hq=8, hkv=2, c=16, d=32, max_len=128):
    rng = np.random.default_rng(0)
    b = 3
    q = rng.normal(size=(b, hq, c, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, max_len, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, max_len, d)).astype(np.float32)
    lengths = np.asarray([20, 1, 97], np.int32)       # incl. the chunk
    q_lens = np.asarray([16, 1, 5], np.int32)
    return q, k, v, lengths, q_lens


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("hkv", [2, 1])
def test_mixed_attention_plain_matches_reference(window, hkv):
    q, k, v, lengths, q_lens = _attn_operands(hkv=hkv)
    got = mixed_attention_torch(*_t(q, k, v, lengths, q_lens),
                                window=window).numpy()
    j = [jnp.asarray(a) for a in (q, k, v, lengths, q_lens)]
    wants = [
        jops.mixed_attention(*j, window=window, impl="ref"),
        mixed_attention_blocked(*j, window=window),
        mixed_flash_attention_pallas(*j, window=window, interpret=True),
    ]
    for want in wants:
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got, ops.mixed_attention(*_t(q, k, v, lengths, q_lens),
                                 window=window, impl="ref").numpy(), **TOL)


def test_decode_attention_matches_reference():
    q, k, v, lengths, _ = _attn_operands(c=1)
    got = ops.decode_attention(*_t(q, k, v, lengths)).numpy()
    want = jops.decode_attention(*[jnp.asarray(a) for a in (q, k, v,
                                                            lengths)],
                                 impl="xla")
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_dead_queries_exact_zero():
    q, k, v, lengths, q_lens = _attn_operands()
    out = ops.mixed_attention(*_t(q, k, v, lengths, q_lens))
    assert torch.equal(out[2, :, 5:], torch.zeros_like(out[2, :, 5:]))
    assert torch.equal(out[1, :, 1:], torch.zeros_like(out[1, :, 1:]))


def test_qlen1_bitwise_equals_decode():
    """A chunk of one is literally the decode contract."""
    q, k, v, lengths, _ = _attn_operands(c=1)
    dec = ops.decode_attention(*_t(q, k, v, lengths))
    mix = ops.mixed_attention(*_t(q, k, v, lengths),
                              torch.ones(3, dtype=torch.int32))
    assert torch.equal(dec, mix)


def test_qlen1_inside_chunk_matches_decode():
    """Row 1 has q_lens = 1 inside a C = 16 chunk: the same value as the
    C = 1 call (bitwise on the card; within tolerance for the CPU plain
    version, whose matmuls change shape with C)."""
    q, k, v, lengths, q_lens = _attn_operands()
    chunk = ops.mixed_attention(*_t(q, k, v, lengths, q_lens))
    one = ops.decode_attention(*_t(np.ascontiguousarray(q[:, :, :1]), k, v,
                                   lengths))
    np.testing.assert_allclose(chunk[1, :, 0].numpy(), one[1, :, 0].numpy(),
                               **TOL)


# -- kernel 3's split-and-fold order (the plain version repeats the bf16
# kernel's arithmetic: splits of split_span(bk) keys, 64-key steps, a fold
# in increasing split order)

def test_split_span_is_a_function_of_the_tile():
    for bk in range(8, 129):
        span = split_span(bk)
        assert span % bk == 0 and KV_SPLIT_KEYS // 2 < span <= KV_SPLIT_KEYS
        assert -(-span // KV_STEP_KEYS) <= 2       # at most two steps
    assert split_span(16) == split_span(128) == 128


@pytest.mark.parametrize("block_kv,window", [(128, None), (48, None),
                                             (32, 40), (8, None)])
def test_mixed_attention_plain_across_splits_matches_reference(block_kv,
                                                               window):
    """Rows spanning several splits (a 384-key cache; spans of 128 and, at
    block_kv 48, 96 keys with a partial second step): the plain version
    equals the reference's dense oracle, its blocked twin and its Pallas
    kernel (interpret mode) within the f32 tolerance."""
    rng = np.random.default_rng(block_kv)
    b, hq, hkv, c, d, s = 3, 8, 2, 16, 32, 384
    q = rng.normal(size=(b, hq, c, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    lengths = np.asarray([300, 129, 384], np.int32)
    q_lens = np.asarray([16, 1, 9], np.int32)
    got = mixed_attention_torch(*_t(q, k, v, lengths, q_lens), window=window,
                                block_kv=block_kv).numpy()
    j = [jnp.asarray(a) for a in (q, k, v, lengths, q_lens)]
    for want in (jops.mixed_attention(*j, window=window, impl="ref"),
                 mixed_attention_blocked(*j, window=window),
                 mixed_flash_attention_pallas(*j, window=window,
                                              interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


def _split_operands(b=4, max_len=384):
    rng = np.random.default_rng(11)
    hq, hkv, c, d = 8, 2, 8, 32
    q = rng.normal(size=(b, hq, c, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, max_len, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, max_len, d)).astype(np.float32)
    return _t(q, k, v)


def test_row_bitwise_when_another_row_crosses_a_split():
    """Rows 0 and 2 keep their bits when row 1's length moves from inside
    its first split to its third, and row 3's from its third to its
    first."""
    q, k, v = _split_operands()
    q_lens = torch.tensor([8, 1, 5, 3], dtype=torch.int32)
    a = mixed_attention_torch(q, k, v, torch.tensor([200, 100, 50, 300]),
                              q_lens)
    b = mixed_attention_torch(q, k, v, torch.tensor([200, 290, 50, 20]),
                              q_lens)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])


def test_row_bitwise_when_the_batch_grows():
    """Two rows alone are bitwise those rows inside a batch of five."""
    q, k, v = _split_operands(b=5)
    lengths = torch.tensor([300, 129, 40, 384, 7], dtype=torch.int32)
    q_lens = torch.tensor([8, 1, 3, 8, 0], dtype=torch.int32)
    full = mixed_attention_torch(q, k, v, lengths, q_lens, window=70)
    two = mixed_attention_torch(q[:2], k[:2], v[:2], lengths[:2], q_lens[:2],
                                window=70)
    assert torch.equal(two, full[:2])


@pytest.mark.parametrize("bs", [8, 16, 48])
def test_scrambled_pool_bitwise_equals_slot_across_splits(bs):
    """The same keys scattered over a scrambled pool (spare blocks, the null
    block last) give the slot walk's bits at ``block_kv = bs``: the split
    span is a function of the tile alone; at bs 8 and 16 the span is 128
    keys, as the slot cache's default 128-key tile gives, so the default
    slot walk is bitwise the pool too."""
    q, k, v = _split_operands()
    b, hkv, s, d = k.shape
    n_pages = s // bs
    rng = np.random.default_rng(bs)
    table = torch.from_numpy(rng.permutation(b * n_pages + 3)[:b * n_pages]
                             .reshape(b, n_pages).astype(np.int32))
    pools = []
    for leaf in (k, v):
        pool = torch.full((b * n_pages + 4, hkv, bs, d), 7.5)
        pool[table.long()] = leaf.reshape(b, hkv, n_pages, bs, d
                                          ).transpose(1, 2)
        pools.append(pool)
    lengths = torch.tensor([300, 129, 40, 384], dtype=torch.int32)
    q_lens = torch.tensor([8, 1, 3, 8], dtype=torch.int32)
    paged = mixed_attention_torch(q, *pools, lengths, q_lens,
                                  page_table=table)
    assert torch.equal(paged, mixed_attention_torch(q, k, v, lengths, q_lens,
                                                    block_kv=bs))
    if split_span(bs) == split_span(kv_block_size(s)):
        assert torch.equal(paged, mixed_attention_torch(q, k, v, lengths,
                                                        q_lens))


def test_fold_of_a_split_the_query_does_not_see_keeps_its_bits():
    """A split wholly past a query's position has m = -1e30, l = 0,
    acc = 0: folding it leaves the running state bitwise unchanged
    (alpha = 1, contribution 0), from a live state and from the empty
    one; the plain version's fold skips such a split, which is the same."""
    rng = np.random.default_rng(5)
    m = torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32))
    l = torch.from_numpy(rng.uniform(1, 9, (2, 3)).astype(np.float32))
    acc = torch.from_numpy(rng.normal(size=(2, 3, 4)).astype(np.float32))
    empty = (torch.full((2, 3), -1e30), torch.zeros(2, 3),
             torch.zeros(2, 3, 4))
    yes = torch.ones(2, 3, dtype=torch.bool)
    for state in ((m, l, acc), empty):
        out = fold_split(state, empty, yes)
        for a, b in zip(out, state):
            assert torch.equal(a, b)
    # and the first split a query sees is taken as it is
    out = fold_split(empty, (m, l, acc), yes)
    for a, b in zip(out, (m, l, acc)):
        assert torch.equal(a, b)


def test_kv_block_size_matches_reference():
    from repro.kernels.decode_flash import kv_block_size as jax_kv_block
    for n in (1, 7, 96, 128, 500, 512, 4096):
        assert kv_block_size(n, 128) == jax_kv_block(n, 128)


# -- rmsnorm and rope --------------------------------------------------------

def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, 3, 256)).astype(np.float32)
    g = rng.normal(size=(256,)).astype(np.float32)
    got = rmsnorm(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    want = jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(g))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert np.array_equal(got, rmsnorm_torch(*_t(x, g)).numpy())


def test_rope_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 4, 7, 32)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 7)).astype(np.int32)
    got = tlayers.apply_rope(*_t(x, pos), 10000.0).numpy()
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


# -- dispatch ----------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(6)
    _, tqt = _weights(rng, 128, 256)
    x = torch.from_numpy(rng.normal(size=(4, 128)).astype(np.float32))
    assert torch.equal(ops.w4a16_matmul(x, tqt), w4a16_matmul_torch(x, tqt))
    tst = block_sparsify_quantize(torch.from_numpy(
        rng.normal(size=(256, 128)).astype(np.float32)), 0.5,
        blocks_per_group=2)
    x2 = torch.cat([x, x], -1)
    assert torch.equal(ops.sparse_w4a16_matmul(x2, tst),
                       sparse_w4a16_matmul_torch(x2, tst))
    assert not _build.launches


@pytest.mark.parametrize("op", ["w4a16", "ffn", "attention", "rmsnorm",
                                "sparse_w4a16", "sparse_ffn"])
def test_cuda_impl_refuses_cpu_tensors(op):
    """A CUDA wrapper never falls back: on a CPU tensor it raises."""
    rng = np.random.default_rng(7)
    _, tqt = _weights(rng, 128, 128)
    tst = block_sparsify_quantize(torch.from_numpy(
        rng.normal(size=(256, 128)).astype(np.float32)), 0.5,
        blocks_per_group=2, tile_uniform=True)
    x = torch.from_numpy(rng.normal(size=(2, 128)).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        if op == "w4a16":
            ops.w4a16_matmul(x, tqt, impl="cuda")
        elif op == "ffn":
            ops.ffn_w4a16(x, tqt, tqt, tqt, impl="cuda")
        elif op == "sparse_w4a16":
            ops.sparse_w4a16_matmul(torch.cat([x, x], -1), tst, impl="cuda")
        elif op == "sparse_ffn":
            gate = block_sparsify_quantize(torch.from_numpy(
                rng.normal(size=(128, 256)).astype(np.float32)), 1.0,
                blocks_per_group=1)
            ops.ffn_w4a16(x, gate, gate, tst, impl="cuda")
        elif op == "attention":
            q, k, v, lengths, q_lens = _attn_operands()
            ops.mixed_attention(*_t(q, k, v, lengths, q_lens), impl="cuda")
        else:
            rmsnorm(x, torch.ones(128), impl="cuda")
