"""Card-only tests of the port's CUDA kernels (marker ``gpu``).

Each hand kernel is held against its plain PyTorch version on the card, and
the batch-invariance properties the engine's oracle parity rests on are
checked bitwise.  This file imports nothing of JAX, so it runs on the
machine with the card:

    python -m pytest -m gpu tests/test_torch_gpu.py

On a machine without a card every test skips (decided inside the
``cuda`` fixture, never at import time)."""

import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.quant import quantize  # noqa: E402
from repro_torch.core.sparsity import block_sparsify_quantize  # noqa: E402
from repro_torch.kernels import _build, ops, slstm_scan  # noqa: E402
from repro_torch.kernels.ffn_fused import (  # noqa: E402
    ffn_gate_up_sparse_cuda, ffn_gate_up_sparse_torch, kept_f_tiles)
from repro_torch.kernels.decode_flash import VARIANTS as VARIANTS_NAMES  # noqa: E402,E501
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BLOCK_KV, BLOCK_Q, flash_attention_torch)
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402
from repro_torch.serving.engine import _unpack_tick  # noqa: E402

pytestmark = pytest.mark.gpu

# relative to max |reference|: bf16 rounding of f32 sums taken in another
# order (2^-7), f32 accumulation order
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max()
    assert float(err) <= TOL[dtype] * float(want.float().abs().max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens,out_f", [(1, 128), (4, 644), (37, 1024)])
def test_w4a16_kernel_matches_plain(cuda, dtype, tokens, out_f):
    gen = torch.Generator(device="cuda").manual_seed(tokens)
    qt = quantize(_rand(gen, 384, out_f) * 0.05)
    x = _rand(gen, tokens, 384, dtype=dtype)
    before = _build.launches["w4a16_matmul"]
    got = ops.w4a16_matmul(x, qt)
    assert _build.launches["w4a16_matmul"] == before + 1
    _close(got, ops.w4a16_matmul(x, qt, impl="torch"), dtype)
    # batch invariance: a row alone equals the same row inside the batch
    assert torch.equal(ops.w4a16_matmul(x[:1], qt), got[:1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_ffn_kernel_matches_plain(cuda, dtype, activation):
    gen = torch.Generator(device="cuda").manual_seed(3)
    d, f = 256, 384
    gate, up = (quantize(_rand(gen, d, f) * 0.05) for _ in range(2))
    down = quantize(_rand(gen, f, d) * 0.05)
    x = _rand(gen, 9, d, dtype=dtype)
    got = ops.ffn_w4a16(x, gate, up, down, activation=activation)
    want = ops.ffn_w4a16(x, gate, up, down, activation=activation,
                         impl="torch")
    _close(got, want, dtype)
    assert torch.equal(ops.ffn_w4a16(x[:2], gate, up, down,
                                     activation=activation), got[:2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens", [1, 4, 37])
@pytest.mark.parametrize("in_f,out_f,m,tile_uniform",
                         [(1024, 384, 8, False), (768, 256, 2, True)])
def test_sparse_w4a16_kernel_matches_plain(cuda, dtype, tokens, in_f, out_f,
                                           m, tile_uniform):
    gen = torch.Generator(device="cuda").manual_seed(tokens)
    st = block_sparsify_quantize(_rand(gen, in_f, out_f) * 0.05, 0.5,
                                 blocks_per_group=m,
                                 tile_uniform=tile_uniform)
    x = _rand(gen, tokens, in_f, dtype=dtype)
    before = _build.launches["sparse_w4a16_matmul"]
    got = ops.sparse_w4a16_matmul(x, st)
    assert _build.launches["sparse_w4a16_matmul"] == before + 1
    _close(got, ops.sparse_w4a16_matmul(x, st, impl="torch"), dtype)
    assert torch.equal(ops.sparse_w4a16_matmul(x[:1], st), got[:1])


def _sparse_ffn(gen, d, f, down_kind):
    gate, up = (block_sparsify_quantize(_rand(gen, d, f) * 0.05, 0.25)
                for _ in range(2))
    w = _rand(gen, f, d) * 0.05
    down = (block_sparsify_quantize(w, 0.5, blocks_per_group=2,
                                    tile_uniform=True)
            if down_kind == "sparse" else quantize(w))
    return gate, up, down


def _ffn_biases(gen, activation, f, d):
    """The gelu FFN's up and down biases (f32), none for a gated one."""
    if activation != "gelu":
        return {}
    return {"up_bias": _rand(gen, f) * 0.1, "down_bias": _rand(gen, d) * 0.1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("down_kind", ["sparse", "dense"])
def test_sparse_ffn_kernel_matches_plain(cuda, dtype, activation, down_kind):
    """Kernel 5 with either down; gelu: up alone with both biases, counted
    as ``ffn_fused_sparse_gelu``."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    gate, up, down = _sparse_ffn(gen, 1024, 768, down_kind)
    kw = _ffn_biases(gen, activation, 768, 1024)
    if activation == "gelu":
        gate = None
    x = _rand(gen, 9, 1024, dtype=dtype)
    before = dict(_build.launches)
    got = ops.ffn_w4a16(x, gate, up, down, activation=activation, **kw)
    launched = {k: v - before.get(k, 0) for k, v in _build.launches.items()
                if v != before.get(k, 0)}
    second = ("sparse_w4a16_matmul" if down_kind == "sparse"
              else "w4a16_matmul")
    first = ("ffn_fused_sparse_gelu" if activation == "gelu"
             else "ffn_fused_sparse")
    assert launched == {first: 1, second: 1}
    _close(got, ops.ffn_w4a16(x, gate, up, down, activation=activation,
                              impl="torch", **kw), dtype)
    assert torch.equal(ops.ffn_w4a16(x[:2], gate, up, down,
                                     activation=activation, **kw), got[:2])
    # the hidden tiles the kernel writes match the plain version's
    tiles = kept_f_tiles(down)
    cols = (torch.arange(768, device="cuda") if tiles is None else
            (tiles.long()[:, None] * 128
             + torch.arange(128, device="cuda")).reshape(-1))
    ub = kw.get("up_bias")
    h = ffn_gate_up_sparse_cuda(x, gate, up, activation, tiles, ub)
    _close(h[:, cols], ffn_gate_up_sparse_torch(x, gate, up, activation,
                                                tiles, ub), dtype)


def test_sparse_ffn_never_reads_dropped_f_tiles(cuda):
    """With a tile_uniform down, the gate/up blocks (gelu: the up blocks
    and the up bias) of the hidden tiles down drops are never read: NaN
    there changes nothing, in both dtypes."""
    for activation in ("swiglu", "gelu"):
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device="cuda").manual_seed(8)
            gate, up, down = _sparse_ffn(gen, 1024, 768, "sparse")
            kw = _ffn_biases(gen, activation, 768, 1024)
            if activation == "gelu":
                gate = None
            x = _rand(gen, 5, 1024, dtype=dtype)
            clean = ops.ffn_w4a16(x, gate, up, down, activation=activation,
                                  **kw)
            dropped = torch.ones(768 // 128, dtype=torch.bool,
                                 device="cuda")
            dropped[kept_f_tiles(down).long()] = False
            assert bool(dropped.any())
            for w in (gate, up):
                if w is not None:
                    w.scales[dropped] = float("nan")
            if "up_bias" in kw:
                kw["up_bias"].view(-1, 128)[dropped] = float("nan")
            poisoned = ops.ffn_w4a16(x, gate, up, down,
                                     activation=activation, **kw)
            assert bool(torch.isfinite(poisoned).all()), (activation, dtype)
            assert torch.equal(poisoned, clean), (activation, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("head_dim", [32, 128])
def test_attention_kernel_matches_plain(cuda, dtype, window, head_dim):
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, hq, hkv, c, max_len = 3, 8, 2, 16, 192
    q = _rand(gen, b, hq, c, head_dim, dtype=dtype)
    k = _rand(gen, b, hkv, max_len, head_dim, dtype=dtype)
    v = _rand(gen, b, hkv, max_len, head_dim, dtype=dtype)
    lengths = torch.tensor([20, 1, 180], dtype=torch.int32, device="cuda")
    q_lens = torch.tensor([16, 1, 5], dtype=torch.int32, device="cuda")
    got = ops.mixed_attention(q, k, v, lengths, q_lens, window=window)
    _close(got, ops.mixed_attention(q, k, v, lengths, q_lens, window=window,
                                    impl="torch"), dtype)
    assert bool((got[1, :, 1:] == 0).all()) and \
        bool((got[2, :, 5:] == 0).all())
    # q_lens = 1 inside a C = 16 chunk is bitwise the C = 1 result
    one = ops.mixed_attention(q[:, :, :1].contiguous(), k, v, lengths,
                              torch.ones_like(q_lens), window=window)
    assert torch.equal(got[1, :, 0], one[1, :, 0])


def _attention_operands(gen, dtype, b, hkv, s, d, bs, quant):
    """A contiguous cache (fp or int8 with scales), the same cache scattered
    into a pool under a scrambled page table (3 unassigned blocks and the
    null block last), and both as keyword arguments of ``ops``."""
    from repro_torch.models.attention import quantize_kv
    k = _rand(gen, b, hkv, s, d)
    v = _rand(gen, b, hkv, s, d)
    leaves = {"k": k.to(dtype), "v": v.to(dtype)}
    if quant:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        leaves = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    n_pages = s // bs
    rows = b * n_pages + 4
    perm = torch.randperm(rows - 1, generator=gen, device="cuda")
    table = perm[:b * n_pages].reshape(b, n_pages).to(torch.int32)
    pool = {}
    for name, t in leaves.items():
        p = torch.zeros((rows, hkv, bs, t.shape[-1]), dtype=t.dtype,
                        device="cuda")
        p[table.long()] = t.reshape(b, hkv, n_pages, bs, -1).transpose(1, 2)
        pool[name] = p
    return leaves, pool, table


def _attend(q, leaves, lengths, q_lens, **kw):
    scales = {n: leaves[n] for n in ("k_scale", "v_scale") if n in leaves}
    return ops.mixed_attention(q, leaves["k"], leaves["v"], lengths, q_lens,
                               **scales, **kw)


VARIANTS = [(False, True), (True, False), (True, True)]   # (paged, int8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paged,quant", VARIANTS,
                         ids=["slot-int8", "paged", "paged-int8"])
@pytest.mark.parametrize("chunk,window", [(1, None), (16, None), (16, 24)])
def test_attention_variants_match_plain(cuda, dtype, paged, quant, chunk,
                                        window):
    """Each new variant against its plain version, with the launch counted
    under its own name; paged equals slot bitwise at ``block_kv = bs``."""
    gen = torch.Generator(device="cuda").manual_seed(9 + chunk)
    b, hq, hkv, s, d, bs = 3, 8, 2, 128, 128, 16
    leaves, pool, table = _attention_operands(gen, dtype, b, hkv, s, d, bs,
                                              quant)
    q = _rand(gen, b, hq, chunk, d, dtype=dtype)
    lengths = torch.tensor([37, 128, 5], dtype=torch.int32, device="cuda")
    q_lens = torch.tensor([min(chunk, 3), chunk, 1], dtype=torch.int32,
                          device="cuda")
    cache, kw = ((pool, {"page_table": table}) if paged else (leaves, {}))
    name = VARIANTS_NAMES[(paged, quant)]
    before = _build.launches[name]
    got = _attend(q, cache, lengths, q_lens, window=window, **kw)
    assert _build.launches[name] == before + 1
    _close(got, _attend(q, cache, lengths, q_lens, window=window,
                        impl="torch", **kw), dtype)
    if paged:
        slot = _attend(q, leaves, lengths, q_lens, window=window, block_kv=bs)
        assert torch.equal(got, slot)


@pytest.mark.parametrize("paged,quant", VARIANTS,
                         ids=["slot-int8", "paged", "paged-int8"])
def test_attention_variants_row_invariant(cuda, paged, quant):
    """4 rows alone are bitwise those rows inside a batch of 64."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    b, hq, hkv, s, d, bs = 64, 8, 2, 64, 128, 16
    leaves, pool, table = _attention_operands(gen, torch.bfloat16, b, hkv, s,
                                              d, bs, quant)
    q = _rand(gen, b, hq, 8, d, dtype=torch.bfloat16)
    lengths = torch.randint(8, s + 1, (b,), generator=gen, device="cuda",
                            dtype=torch.int32)
    q_lens = torch.randint(0, 9, (b,), generator=gen, device="cuda",
                           dtype=torch.int32)
    if paged:
        full = _attend(q, pool, lengths, q_lens, page_table=table)
        four = _attend(q[:4], pool, lengths[:4], q_lens[:4],
                       page_table=table[:4])
    else:
        full = _attend(q, leaves, lengths, q_lens)
        four = _attend(q[:4], {n: t[:4] for n, t in leaves.items()},
                       lengths[:4], q_lens[:4])
    assert torch.equal(four, full[:4])


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_paged_kernel_never_reads_null_or_unleased_blocks(cuda, quant):
    """Pages past each row's live range point at the null block; it, every
    unleased block and the tail of each row's last page hold NaN (int8:
    NaN scales): the output stays finite and bitwise unchanged."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    b, hq, hkv, s, d, bs = 3, 8, 2, 128, 128, 16
    _, pool, table = _attention_operands(gen, torch.bfloat16, b, hkv, s, d,
                                         bs, quant)
    q = _rand(gen, b, hq, 16, d, dtype=torch.bfloat16)
    lengths = torch.tensor([37, 128, 5], dtype=torch.int32, device="cuda")
    q_lens = torch.tensor([16, 3, 1], dtype=torch.int32, device="cuda")
    clean = _attend(q, pool, lengths, q_lens, page_table=table)
    null = pool["k"].shape[0] - 1
    live = (lengths.long() + bs - 1) // bs
    table = table.clone()
    table[torch.arange(s // bs, device="cuda")[None, :] >= live[:, None]] = \
        null
    leased = torch.zeros(null + 1, dtype=torch.bool, device="cuda")
    leased[table[table != null].long()] = True
    for name, leaf in pool.items():
        if leaf.dtype == torch.int8:
            continue
        leaf[~leased] = float("nan")
        for r in range(b):
            page, off = divmod(int(lengths[r]), bs)
            if off:
                leaf[table[r, page].long(), :, off:] = float("nan")
    poisoned = _attend(q, pool, lengths, q_lens, page_table=table)
    assert bool(torch.isfinite(poisoned).all())
    assert torch.equal(poisoned, clean)


def test_paged_kernel_refuses_page_sizes_it_cannot_tile(cuda):
    gen = torch.Generator(device="cuda").manual_seed(12)
    q = _rand(gen, 1, 4, 1, 32, dtype=torch.bfloat16)
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    for bs in (4, 256):
        pool = _rand(gen, 3, 2, bs, 32, dtype=torch.bfloat16)
        table = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
        with pytest.raises(ValueError, match="page size"):
            ops.mixed_attention(q, pool, pool, one, one, page_table=table)


# (Sq, Skv, rep, head_dim, causal, window): whole tiles, ragged edges, a q
# block ending a longer context, chatglm's rep 16, windows, non-causal
# (cross-attention) and Sq > Skv (rows that see no key return zeros)
FLASH_CASES = {"causal": (256, 256, 8, 128, True, None),
               "ragged": (300, 300, 4, 128, True, None),
               "offset": (100, 333, 2, 64, True, None),
               "window-rep16": (200, 260, 16, 128, True, 37),
               "non-causal": (45, 150, 1, 64, False, None),
               "non-causal-window": (64, 130, 2, 64, False, 20),
               "head-dim-32": (70, 70, 2, 32, True, None),
               "sq-over-skv": (80, 50, 2, 64, True, None)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_kernel_matches_plain(cuda, dtype, case):
    """Kernel 7 against its plain version walking the kernel's own tiles,
    and against the plain version at the TPU kernel's tiles."""
    sq, skv, rep, d, causal, window = FLASH_CASES[case]
    gen = torch.Generator(device="cuda").manual_seed(sq + skv)
    q = _rand(gen, 2, 2 * rep, sq, d, dtype=dtype)
    k = _rand(gen, 2, 2, skv, d, dtype=dtype)
    v = _rand(gen, 2, 2, skv, d, dtype=dtype)
    before = _build.launches["flash_attention"]
    got = ops.attention(q, k, v, causal=causal, window=window)
    assert _build.launches["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _close(got, flash_attention_torch(q, k, v, causal=causal, window=window,
                                      block_q=BLOCK_Q, block_kv=BLOCK_KV),
           dtype)
    _close(got, ops.attention(q, k, v, causal=causal, window=window,
                              impl="torch"), dtype)
    if sq > skv and causal:
        assert bool((got[:, :, :sq - skv] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_batch_and_query_invariant(cuda, dtype):
    """A row of a batch of 3 is bitwise the same row alone, and the last 40
    queries of a 300-query call are bitwise those queries alone (the q block
    ends the context in both): no reduction follows B or Sq."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    q = _rand(gen, 3, 8, 300, 128, dtype=dtype)
    k = _rand(gen, 3, 2, 300, 128, dtype=dtype)
    v = _rand(gen, 3, 2, 300, 128, dtype=dtype)
    for window in (None, 50):
        full = ops.attention(q, k, v, window=window)
        assert torch.equal(full[1:2], ops.attention(q[1:2], k[1:2], v[1:2],
                                                    window=window))
        assert torch.equal(full[:, :, -40:], ops.attention(
            q[:, :, -40:], k, v, window=window))


def test_flash_kernel_refuses_what_it_cannot_take(cuda):
    gen = torch.Generator(device="cuda").manual_seed(22)
    q = _rand(gen, 1, 4, 8, 64, dtype=torch.bfloat16)
    k = _rand(gen, 1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="bfloat16 on cuda"):
        ops.attention(q, k.cpu(), k.cpu(), impl="cuda")
    with pytest.raises(ValueError, match="must be"):
        ops.attention(q, k.float(), k.float())
    with pytest.raises(ValueError, match="head_dim 96"):
        ops.attention(_rand(gen, 1, 4, 8, 96, dtype=torch.bfloat16),
                      *[_rand(gen, 1, 2, 8, 96, dtype=torch.bfloat16)] * 2)
    with pytest.raises(ValueError, match="multiple"):
        ops.attention(_rand(gen, 1, 3, 8, 64, dtype=torch.bfloat16), k, k)
    with pytest.raises(ValueError, match="window"):
        ops.attention(q, k, k, window=0)


def test_forward_last_position_is_prefill_on_card(cuda):
    """forward's last position is bitwise prefill's logits (every kernel on
    the path is row-invariant), one flash launch per layer and call."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.compiler import quantize_model
    from repro_torch.models import api
    cfg = get_smoke_config("chatglm-6b", dtype=torch.bfloat16, head_dim=128,
                           n_heads=4, n_kv_heads=1, d_model=256)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = quantize_model(api.init_params(cfg, gen), "dense")
    toks = torch.randint(0, cfg.vocab_size, (2, 77), generator=gen,
                         device="cuda")
    _build.launches.clear()
    logits, _ = api.forward(cfg, params, {"tokens": toks})
    last, cache = api.prefill(cfg, params, {"tokens": toks}, 96)
    assert _build.launches["flash_attention"] == 2 * cfg.n_layers
    assert _build.launches["mixed_flash_attention"] == 0
    assert torch.equal(logits[:, -1], last)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_batch_invariant(cuda, dtype):
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = _rand(gen, 64, 4096, dtype=dtype)
    gamma = (1 + 0.1 * _rand(gen, 4096)).to(dtype)
    got = rmsnorm(x, gamma)
    _close(got, rmsnorm(x, gamma, impl="torch"), dtype)
    assert torch.equal(rmsnorm(x[:3], gamma), got[:3])


ENGINE_CASES = {"dense": ("dense", {}), "strategy2": ("strategy2", {}),
                "strategy3": ("strategy3", {}),
                "paged": ("strategy2", dict(kv_layout="paged",
                                            kv_block_size=16,
                                            kv_pool_blocks=6)),
                "paged-int8": ("strategy2", dict(kv_layout="paged",
                                                 kv_block_size=16,
                                                 kv_pool_blocks=6,
                                                 kv_quant="int8"))}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_matches_oracle_on_card(cuda, case):
    """strategy2/3 at d_model 1024, d_ff 768: wo, gate and up block-sparse,
    down tile_uniform sparse (strategy2) or dense-quantized (strategy3), so
    every MLP runs the sparse gate/up kernel and one of the two downs.  The
    paged cases serve strategy2 from a 6-block pool of 16-token pages
    (fewer than 3 slots x 4 pages: admission stalls), fp and int8 K/V, with
    ``audit()`` on every tick."""
    strategy, kv = ENGINE_CASES[case]
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.compiler import quantize_model
    from repro_torch.models import api
    from repro_torch.serving.engine import Engine, Request, reference_decode
    over = (dict(head_dim=128, n_heads=2, n_kv_heads=1, d_model=256)
            if strategy == "dense" else
            dict(head_dim=128, n_heads=8, n_kv_heads=2, d_model=1024,
                 d_ff=768))
    cfg = get_smoke_config("qwen-7b", dtype=torch.bfloat16, **over, **kv)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = quantize_model(api.init_params(cfg, gen), strategy)
    _build.launches.clear()
    engine = Engine(cfg, params, batch_size=3, max_len=64, chunk_size=16,
                    audit_every=1, device="cuda")
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(3, 40))),
                    max_new_tokens=int(rng.integers(2, 8)))
            for i in range(6)]
    for r in reqs:
        engine.submit(r)
    done = engine.run()
    assert len(done) == 6
    attention = VARIANTS_NAMES[(cfg.kv_layout == "paged",
                                cfg.kv_quant == "int8")]
    assert _build.launches[attention] == engine.steps * cfg.n_layers
    if engine.paged:
        assert engine.admission_stalls > 0
        assert engine.pool_stats()["free"] == engine.pool_blocks
    if strategy != "dense":
        sparse_per_layer = 2 if strategy == "strategy2" else 1   # wo (+down)
        assert _build.launches["ffn_fused_sparse"] == (engine.steps
                                                       * cfg.n_layers)
        assert _build.launches["sparse_w4a16_matmul"] == (
            sparse_per_layer * engine.steps * cfg.n_layers)
    for r in reqs:
        assert r.output == reference_decode(cfg, params, r.prompt,
                                            r.max_new_tokens, max_len=64,
                                            device="cuda")


# -- the xLSTM family: kernel 8 (the sLSTM scan) and the mLSTM decode cell ----

def _scan_operands(gen, b, L, h, dh, r_dtype):
    gx = _rand(gen, b, L, h, 4 * dh)
    r = (_rand(gen, h, dh, 4 * dh) * 0.02).to(r_dtype)
    bias = _rand(gen, h, 4 * dh) * 0.1
    return gx, r, bias


def _lived_in_state(gen, b, h, dh):
    """(c, n, h, m): c, h, m random, n positive."""
    c, hid, m = (_rand(gen, b, h, dh) for _ in range(3))
    return c, _rand(gen, b, h, dh).abs() + 0.5, hid, m


@pytest.mark.parametrize("b,L,h,dh,r_dtype", [
    (2, 512, 4, 512, torch.bfloat16),       # xlstm-1.3b's sLSTM, forward
    (2, 300, 4, 512, torch.bfloat16),       # ragged: no time chunk
    (3, 96, 2, 64, torch.float32),
    (5, 33, 1, 256, torch.bfloat16),        # two row groups, 8 CTAs a head
    (2, 17, 2, 96, torch.bfloat16),         # a cluster of 3
    (1, 9, 3, 32, torch.bfloat16),          # a cluster of 1
    (2, 9, 1, 1000, torch.bfloat16),        # no cluster: CUDA-core kernel
])
def test_slstm_scan_kernel_matches_plain(cuda, b, L, h, dh, r_dtype):
    """Within the reference's own kernel tolerance (2e-4) of the plain
    scan and the ``_slstm_step`` oracle, all in f32, on the kernel
    ``scan_plan`` names (one launch, one route)."""
    gen = torch.Generator(device="cuda").manual_seed(L)
    gx, r, bias = _scan_operands(gen, b, L, h, dh, r_dtype)
    kernel = slstm_scan.scan_plan(h, dh, r_dtype).kernel
    before = _build.launches["slstm_scan"]
    routed = slstm_scan.routes[kernel]
    got = ops.slstm_scan(gx, r, bias)
    assert _build.launches["slstm_scan"] == before + 1
    assert slstm_scan.routes[kernel] == routed + 1
    for want in (ops.slstm_scan(gx, r, bias, impl="torch"),
                 ops.slstm_scan(gx, r, bias, impl="ref")):
        assert float((got - want).abs().max()) <= 2e-4 * (
            1 + float(want.abs().max()))


def test_slstm_scan_kernel_decode_step_from_a_state(cuda):
    """L = 1 from a lived-in state at xlstm-1.3b's width: hidden states and
    the state written back match the plain version; an inactive row keeps
    its state; rows are bitwise independent of the batch."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, h, dh = 4, 4, 512
    gx, r, bias = _scan_operands(gen, b, 1, h, dh, torch.bfloat16)
    state = _lived_in_state(gen, b, h, dh)
    plain = tuple(t.clone() for t in state)
    kern = tuple(t.clone() for t in state)
    active = torch.tensor([True, True, False, True], device="cuda")
    want = ops.slstm_scan(gx, r, bias, plain, active=active, impl="torch")
    got = ops.slstm_scan(gx, r, bias, kern, active=active)
    assert float((got - want).abs().max()) <= 2e-4 * (
        1 + float(want.abs().max()))
    for k, p, s0 in zip(kern, plain, state):
        assert float((k - p).abs().max()) <= 2e-4 * (1 + float(p.abs().max()))
        assert torch.equal(k[2], s0[2])
    alone = tuple(t[1:2].clone() for t in state)
    one = ops.slstm_scan(gx[1:2].contiguous(), r, bias, alone)
    assert torch.equal(one[0], got[1])
    assert all(torch.equal(a[0], k[1]) for a, k in zip(alone, kern))


def test_slstm_scan_kernel_rows_batch_invariant(cuda):
    gen = torch.Generator(device="cuda").manual_seed(2)
    gx, r, bias = _scan_operands(gen, 4, 64, 4, 512, torch.bfloat16)
    got = ops.slstm_scan(gx, r, bias)
    for row in range(4):
        alone = ops.slstm_scan(gx[row:row + 1].contiguous(), r, bias)
        assert torch.equal(alone[0], got[row])


def test_slstm_scan_plan_takes_the_cluster_kernel_at_xlstm_widths(cuda):
    """xlstm-1.3b in bf16 (4 heads of 512) runs the cluster kernel: 16 CTAs
    a head, and the card holds its 4 clusters at once."""
    plan = slstm_scan.scan_plan(4, 512, torch.bfloat16)
    assert plan.kernel == "cluster" and plan.cluster == 16
    assert slstm_scan.cluster_capacity(512) >= 4


@pytest.mark.parametrize("b,h,dh", [(3, 4, 512), (2, 2, 64)])
def test_slstm_scan_cluster_steps_equal_one_call(cuda, b, h, dh):
    """L steps in one call are bitwise L one-step calls with the state
    carried: what the engine's mixed ≡ sequential rests on."""
    gen = torch.Generator(device="cuda").manual_seed(dh)
    L = 40
    gx, r, bias = _scan_operands(gen, b, L, h, dh, torch.bfloat16)
    state = _lived_in_state(gen, b, h, dh)
    whole = tuple(t.clone() for t in state)
    got = ops.slstm_scan(gx, r, bias, whole)
    stepped = tuple(t.clone() for t in state)
    steps = torch.cat([ops.slstm_scan(gx[:, t:t + 1].contiguous(), r, bias,
                                      stepped) for t in range(L)], dim=1)
    assert torch.equal(steps, got)
    assert all(torch.equal(a, c) for a, c in zip(stepped, whole))


def test_slstm_scan_cluster_rows_alone_at_every_batch(cuda):
    """Each row alone equals the same row inside B = 1 .. 8 (one or two
    row groups of a cluster), bitwise, hidden states and state."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    h, dh, L = 4, 512, 12
    gx, r, bias = _scan_operands(gen, 8, L, h, dh, torch.bfloat16)
    state = _lived_in_state(gen, 8, h, dh)
    alone = []
    for row in range(8):
        st = tuple(t[row:row + 1].clone() for t in state)
        alone.append((ops.slstm_scan(gx[row:row + 1].contiguous(), r, bias,
                                     st), st))
    for b in range(1, 9):
        st = tuple(t[:b].clone() for t in state)
        got = ops.slstm_scan(gx[:b].contiguous(), r, bias, st)
        for row in range(b):
            hs, st1 = alone[row]
            assert torch.equal(got[row], hs[0])
            assert all(torch.equal(a[row], c[0]) for a, c in zip(st, st1))


def test_slstm_scan_cluster_active_mask_keeps_state(cuda):
    """Over L = 7 steps at B = 6 (two row groups): masked rows keep their
    state exactly, the others match a run without the masked rows."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    h, dh = 4, 512
    gx, r, bias = _scan_operands(gen, 6, 7, h, dh, torch.bfloat16)
    state = _lived_in_state(gen, 6, h, dh)
    active = torch.tensor([True, False, True, True, False, True],
                          device="cuda")
    st = tuple(t.clone() for t in state)
    hs = ops.slstm_scan(gx, r, bias, st, active=active)
    keep = active.nonzero().flatten()
    sub = tuple(t[keep].clone() for t in state)
    want = ops.slstm_scan(gx[keep].contiguous(), r, bias, sub)
    assert torch.equal(hs[keep], want)
    for a, s0, w in zip(st, state, sub):
        assert torch.equal(a[~active], s0[~active])
        assert torch.equal(a[keep], w)


def _cell_operands(gen, b, h, dh, dtype):
    di = h * dh
    xp = _rand(gen, b, di, dtype=dtype)
    q, k, v = (_rand(gen, b, h, dh, dtype=dtype) for _ in range(3))
    w_i, w_f = ((_rand(gen, di, h) * 0.01).to(dtype) for _ in range(2))
    b_i = _rand(gen, h) * 0.1
    b_f = 3.0 + _rand(gen, h) * 0.1
    C = _rand(gen, b, h, dh, dh) * 0.1
    n = _rand(gen, b, h, dh).abs() + 0.5
    m = _rand(gen, b, h)
    return xp, q, k, v, w_i, w_f, b_i, b_f, C, n, m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,dh", [(4, 4, 1024), (3, 2, 96), (2, 3, 98),
                                    (3, 2, 600), (2, 2, 3), (2, 1, 4096)])
def test_mlstm_cell_kernel_matches_plain(cuda, dtype, b, h, dh):
    """Readout, C', n' and m' against the reference's algebra, relative to
    the largest value (the gates round to the model dtype: a bf16 gate one
    step apart moves the exponentials by 2^-8); an inactive row keeps its
    state."""
    gen = torch.Generator(device="cuda").manual_seed(dh)
    xp, q, k, v, w_i, w_f, b_i, b_f, C, n, m = _cell_operands(gen, b, h, dh,
                                                              dtype)
    active = torch.ones(b, dtype=torch.bool, device="cuda")
    active[1] = False
    Cp, Ck = C.clone(), C.clone()
    want = ops.mlstm_cell(xp, q, k, v, w_i, w_f, b_i, b_f, Cp, n, m,
                          active=active, impl="torch")
    before = _build.launches["mlstm_cell"]
    got = ops.mlstm_cell(xp, q, k, v, w_i, w_f, b_i, b_f, Ck, n, m,
                         active=active)
    assert _build.launches["mlstm_cell"] == before + 1
    for g, w in zip(got + (Ck,), want + (Cp,)):
        _close(g, w, dtype)
    assert torch.equal(Ck[1], C[1])
    assert torch.equal(got[1][1], n[1]) and torch.equal(got[2][1], m[1])


def test_mlstm_cell_kernel_rows_batch_invariant(cuda):
    gen = torch.Generator(device="cuda").manual_seed(5)
    ops_in = _cell_operands(gen, 4, 4, 1024, torch.bfloat16)
    *head, C, n, m = ops_in
    Cb = C.clone()
    y, n2, m2 = ops.mlstm_cell(*head, Cb, n, m)
    for row in range(4):
        sl = [t[row:row + 1].contiguous() for t in head[:4]]
        Cr = C[row:row + 1].clone()
        yr, nr, mr = ops.mlstm_cell(*sl, *head[4:], Cr, n[row:row + 1]
                                    .contiguous(), m[row:row + 1]
                                    .contiguous())
        assert torch.equal(yr[0], y[row]) and torch.equal(Cr[0], Cb[row])
        assert torch.equal(nr[0], n2[row]) and torch.equal(mr[0], m2[row])


@pytest.mark.parametrize("dh", [98, 600])
def test_mlstm_cell_kernel_rows_invariant_at_ragged_widths(cuda, dh):
    """Scalar rows of C (dh % 4 != 0) and a ragged last column tile: each
    row alone is bitwise the row inside B = 3."""
    gen = torch.Generator(device="cuda").manual_seed(dh)
    *head, C, n, m = _cell_operands(gen, 3, 2, dh, torch.bfloat16)
    Cb = C.clone()
    y, n2, m2 = ops.mlstm_cell(*head, Cb, n, m)
    for row in range(3):
        sl = [t[row:row + 1].contiguous() for t in head[:4]]
        Cr = C[row:row + 1].clone()
        yr, nr, mr = ops.mlstm_cell(*sl, *head[4:], Cr, n[row:row + 1]
                                    .contiguous(), m[row:row + 1]
                                    .contiguous())
        assert torch.equal(yr[0], y[row]) and torch.equal(Cr[0], Cb[row])
        assert torch.equal(nr[0], n2[row]) and torch.equal(mr[0], m2[row])


def test_xlstm_engine_matches_oracle_on_card(cuda):
    """A reduced xlstm-1.3b in bf16 ("dense" W4A16, 4 blocks: mLSTM and
    sLSTM in turn, d_model 256): every stream equals ``reference_decode``,
    3 slots reused by 6 requests; each decode step launches both xLSTM
    kernels once per block of their kind."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.compiler import quantize_model
    from repro_torch.models import api
    from repro_torch.serving.engine import Engine, Request, reference_decode
    cfg = get_smoke_config("xlstm-1.3b", dtype=torch.bfloat16, d_model=256)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = quantize_model(api.init_params(cfg, gen), "dense")
    _build.launches.clear()
    engine = Engine(cfg, params, batch_size=3, max_len=64, chunk_size=16,
                    device="cuda")
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(3, 40))),
                    max_new_tokens=int(rng.integers(2, 8)))
            for i in range(6)]
    for r in reqs:
        engine.submit(r)
    assert len(engine.run()) == 6
    steps = engine.dispatched_columns
    assert _build.launches["slstm_scan"] == 2 * steps
    assert _build.launches["mlstm_cell"] == 2 * steps
    for r in reqs:
        assert r.output == reference_decode(cfg, params, r.prompt,
                                            r.max_new_tokens, max_len=64,
                                            device="cuda")


# -- 16-bit serving: dense_matmul, kernel 6, layernorm, kernel 2's gelu -------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens,in_f,out_f,bias", [
    (1, 256, 128, False), (4, 384, 300, True), (37, 200, 644, False),
    (9, 1024, 4, True)])
def test_dense_matmul_kernel_matches_plain(cuda, dtype, tokens, in_f, out_f,
                                           bias):
    """Ragged outputs (300, 644, 4 columns), a contraction that is no
    multiple of 128 (200) and the f32 bias epilogue; a row alone is bitwise
    the row in the batch."""
    gen = torch.Generator(device="cuda").manual_seed(tokens)
    w = (_rand(gen, in_f, out_f) * 0.05).to(dtype)
    b = _rand(gen, out_f) * 0.1 if bias else None
    x = _rand(gen, tokens, in_f, dtype=dtype)
    before = _build.launches["dense_matmul"]
    got = ops.dense_matmul(x, w, b)
    assert _build.launches["dense_matmul"] == before + 1
    _close(got, ops.dense_matmul(x, w, b, impl="torch"), dtype)
    _close(got, ops.dense_matmul(x, w, b, impl="ref"), dtype)
    assert torch.equal(ops.dense_matmul(x[:1], w, b), got[:1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_ffn_dense_kernel_matches_plain(cuda, dtype, activation):
    """Kernel 6 (16-bit weights): the hidden stage and the whole FFN
    against ``ffn_fused_dense_torch``, one launch of each stage; rows
    bitwise independent of the batch."""
    from repro_torch.kernels.ffn_fused import (
        ffn_dense_gate_up_cuda, ffn_fused_dense_torch, ffn_gate_up_torch)
    gen = torch.Generator(device="cuda").manual_seed(6)
    d, f = 256, 384
    gated = activation != "gelu"
    gate = (_rand(gen, d, f) * 0.05).to(dtype) if gated else None
    up = (_rand(gen, d, f) * 0.05).to(dtype)
    down = (_rand(gen, f, d) * 0.05).to(dtype)
    kw = ({} if gated else
          dict(up_bias=(_rand(gen, f) * 0.1).to(dtype),
               down_bias=(_rand(gen, d) * 0.1).to(dtype)))
    x = _rand(gen, 9, d, dtype=dtype)
    _close(ffn_dense_gate_up_cuda(x, gate, up, activation, kw.get("up_bias")),
           ffn_gate_up_torch(x, gate, up, activation, kw.get("up_bias")),
           dtype)
    before = dict(_build.launches)
    got = ops.ffn_w4a16(x, gate, up, down, activation=activation, **kw)
    assert {k: v - before.get(k, 0) for k, v in _build.launches.items()
            if v != before.get(k, 0)} == {"ffn_fused_dense": 1,
                                          "dense_matmul": 1}
    _close(got, ffn_fused_dense_torch(x, gate, up, down,
                                      activation=activation, **kw), dtype)
    assert torch.equal(ops.ffn_w4a16(x[:2], gate, up, down,
                                     activation=activation, **kw), got[:2])


# -- the bf16 tensor-core tile (csrc/dense_mma_tile.cuh) ----------------------
# The launcher picks its tile by the token count: T <= 16, T <= 128, above.

def _rows_alone_equal(fn, x, got):
    """The first row, the last row (in a ragged last token tile unless T is
    a multiple of 64) and, past 16 tokens, 4 rows from the middle, each run
    alone, are bitwise the rows of the whole call."""
    n = x.shape[0]
    windows = [(0, 1), (n - 1, n)] + ([(n // 2, n // 2 + 4)] if n > 16
                                      else [])
    for a, b in windows:
        assert torch.equal(fn(x[a:b]), got[a:b]), (n, a, b)


@pytest.mark.parametrize("tokens", [1, 3, 16, 17, 255, 300])
@pytest.mark.parametrize("in_f", [200, 4100])
@pytest.mark.parametrize("out_f", [4, 36, 300, 644])
def test_dense_mma_tile_ragged_shapes(cuda, tokens, in_f, out_f):
    """bf16 ``dense_matmul`` on the tensor-core tile at a contraction that
    is no multiple of the stage (200) or of 8 (4100: the masked scalar x
    path), output widths that are no multiple of 8 (4, 36, 300, 644: the
    8-byte weight copies) and token counts on both sides of each tile
    boundary; the f32 bias on the 4100-wide cases."""
    gen = torch.Generator(device="cuda").manual_seed(tokens + in_f + out_f)
    w = (_rand(gen, in_f, out_f) * 0.05).to(torch.bfloat16)
    b = _rand(gen, out_f) * 0.1 if in_f == 4100 else None
    x = _rand(gen, tokens, in_f, dtype=torch.bfloat16)
    before = _build.launches["dense_matmul"]
    got = ops.dense_matmul(x, w, b)
    assert _build.launches["dense_matmul"] == before + 1
    _close(got, ops.dense_matmul(x, w, b, impl="torch"), torch.bfloat16)
    _rows_alone_equal(lambda v: ops.dense_matmul(v, w, b), x, got)


@pytest.mark.parametrize("tokens", [3, 40, 300])
def test_dense_mma_tile_unaligned_operands_bitwise(cuda, tokens):
    """x 2 bytes past a 16-byte boundary (the masked scalar x path) and the
    weight 8 bytes past one (the 8-byte copies) fill the ring with the same
    bits as the aligned 16-byte copies: the results are bitwise equal."""
    gen = torch.Generator(device="cuda").manual_seed(tokens)
    in_f, out_f = 264, 520
    w = (_rand(gen, in_f, out_f) * 0.05).to(torch.bfloat16)
    x = _rand(gen, tokens, in_f, dtype=torch.bfloat16)
    want = ops.dense_matmul(x, w)
    xs = torch.empty(tokens * in_f + 1, dtype=torch.bfloat16, device="cuda")
    x_odd = xs[1:].view(tokens, in_f)
    x_odd.copy_(x)
    ws = torch.empty(in_f * out_f + 4, dtype=torch.bfloat16, device="cuda")
    w_odd = ws[4:].view(in_f, out_f)
    w_odd.copy_(w)
    assert x_odd.data_ptr() % 16 and w_odd.data_ptr() % 16
    assert torch.equal(ops.dense_matmul(x_odd, w), want)
    assert torch.equal(ops.dense_matmul(x, w_odd), want)
    assert torch.equal(ops.dense_matmul(x_odd, w_odd), want)


@pytest.mark.parametrize("tokens", [40, 300])
@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_ffn_dense_mma_prefill_tiles(cuda, tokens, activation):
    """Kernel 6 in bf16 at token counts that take the two prefill tile
    configurations (40: T <= 128; 300: above, with a ragged last tile):
    the hidden stage and the whole FFN against the plain version, rows
    alone bitwise equal."""
    from repro_torch.kernels.ffn_fused import (
        ffn_dense_gate_up_cuda, ffn_fused_dense_torch, ffn_gate_up_torch)
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(tokens)
    d, f = 384, 1152
    gated = activation != "gelu"
    gate = (_rand(gen, d, f) * 0.05).to(bf16) if gated else None
    up = (_rand(gen, d, f) * 0.05).to(bf16)
    down = (_rand(gen, f, d) * 0.05).to(bf16)
    ub = (_rand(gen, f) * 0.1).to(bf16) if not gated else None
    kw = {} if gated else dict(up_bias=ub,
                               down_bias=(_rand(gen, d) * 0.1).to(bf16))
    x = _rand(gen, tokens, d, dtype=bf16)

    def stage(v):
        return ffn_dense_gate_up_cuda(v, gate, up, activation, ub)

    def ffn(v):
        return ops.ffn_w4a16(v, gate, up, down, activation=activation, **kw)

    h = stage(x)
    _close(h, ffn_gate_up_torch(x, gate, up, activation, ub), bf16)
    _rows_alone_equal(stage, x, h)
    got = ffn(x)
    _close(got, ffn_fused_dense_torch(x, gate, up, down,
                                      activation=activation, **kw), bf16)
    _rows_alone_equal(ffn, x, got)


@pytest.mark.parametrize("tokens", [17, 300])
@pytest.mark.parametrize("in_f,out_f", [(200, 300), (4100, 644)])
def test_dense_f32_tile_matches_plain(cuda, tokens, in_f, out_f):
    """float32 keeps the CUDA-core tile (dense_tile.cuh): within the f32
    tolerance of the plain version at prefill token counts and ragged
    shapes, the f32 bias too, rows alone bitwise equal."""
    gen = torch.Generator(device="cuda").manual_seed(tokens + in_f)
    w = _rand(gen, in_f, out_f) * 0.05
    b = _rand(gen, out_f) * 0.1
    x = _rand(gen, tokens, in_f)
    got = ops.dense_matmul(x, w, b)
    _close(got, ops.dense_matmul(x, w, b, impl="torch"), torch.float32)
    _rows_alone_equal(lambda v: ops.dense_matmul(v, w, b), x, got)


def _tile_invariant(fn, x):
    """Rows 100-103 alone (T=4, the decode tile) are bitwise the same rows
    inside calls of 17, 64 and 100 tokens (the T <= 128 tiles) and of 256,
    300 and 1024 (the wide tiles); row 299 alone is the last row of the
    T=300 call (a ragged last tile) and row 299 of the T=1024 call."""
    want = fn(x[100:104])
    for start, t in ((100, 17), (64, 64), (50, 100), (0, 256), (0, 300),
                     (0, 1024)):
        assert torch.equal(fn(x[start:start + t])[100 - start:104 - start],
                           want), t
    last = fn(x[299:300])
    for t in (300, 1024):
        assert torch.equal(fn(x[:t])[299:300], last), t


@pytest.mark.parametrize("bias", [False, True])
def test_dense_matmul_rows_invariant_across_tiles(cuda, bias):
    gen = torch.Generator(device="cuda").manual_seed(17)
    w = (_rand(gen, 4096, 4096) * 0.02).to(torch.bfloat16)
    b = _rand(gen, 4096) * 0.1 if bias else None
    x = _rand(gen, 1024, 4096, dtype=torch.bfloat16)
    _tile_invariant(lambda v: ops.dense_matmul(v, w, b), x)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_ffn_dense_rows_invariant_across_tiles(cuda, activation):
    from repro_torch.kernels.ffn_fused import ffn_dense_gate_up_cuda
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(18)
    d, f = 1024, 2816
    gated = activation != "gelu"
    gate = (_rand(gen, d, f) * 0.02).to(bf16) if gated else None
    up = (_rand(gen, d, f) * 0.02).to(bf16)
    down = (_rand(gen, f, d) * 0.02).to(bf16)
    ub = None if gated else (_rand(gen, f) * 0.1).to(bf16)
    kw = {} if gated else dict(up_bias=ub,
                               down_bias=(_rand(gen, d) * 0.1).to(bf16))
    x = _rand(gen, 1024, d, dtype=bf16)
    _tile_invariant(lambda v: ffn_dense_gate_up_cuda(v, gate, up, activation,
                                                     ub), x)
    _tile_invariant(lambda v: ops.ffn_w4a16(v, gate, up, down,
                                            activation=activation, **kw), x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_w4a16_gelu_kernel_matches_plain(cuda, dtype):
    """Kernel 2's ungated gelu variant with up and down biases: the up
    stage under its own launch name, down through the W4A16 kernel with
    its f32 bias epilogue."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    d, f = 256, 384
    up = quantize(_rand(gen, d, f) * 0.05)
    down = quantize(_rand(gen, f, d) * 0.05)
    kw = dict(activation="gelu", up_bias=(_rand(gen, f) * 0.1).to(dtype),
              down_bias=(_rand(gen, d) * 0.1).to(dtype))
    x = _rand(gen, 9, d, dtype=dtype)
    before = dict(_build.launches)
    got = ops.ffn_w4a16(x, None, up, down, **kw)
    assert {k: v - before.get(k, 0) for k, v in _build.launches.items()
            if v != before.get(k, 0)} == {"ffn_fused_w4a16_gelu": 1,
                                          "w4a16_matmul": 1}
    _close(got, ops.ffn_w4a16(x, None, up, down, impl="torch", **kw), dtype)
    assert torch.equal(ops.ffn_w4a16(x[:2], None, up, down, **kw), got[:2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_kernel_batch_invariant(cuda, dtype):
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = _rand(gen, 64, 4608, dtype=dtype) * 3 + 1
    gamma = (1 + 0.1 * _rand(gen, 4608)).to(dtype)
    beta = (0.1 * _rand(gen, 4608)).to(dtype)
    before = _build.launches["layernorm"]
    got = ops.layernorm(x, gamma, beta)
    assert _build.launches["layernorm"] == before + 1
    _close(got, ops.layernorm(x, gamma, beta, impl="torch"), dtype)
    assert torch.equal(ops.layernorm(x[:3], gamma, beta), got[:3])


# arch, strategy, overrides of the full config: a few layers at full width
ENGINE_16BIT_CASES = {
    "none": ("qwen-7b", "none", dict(n_layers=2)),
    "starcoder2-none": ("starcoder2-7b", "none", dict(n_layers=2)),
    "starcoder2-dense": ("starcoder2-7b", "dense", dict(n_layers=2)),
    "starcoder2-strategy2": ("starcoder2-7b", "strategy2",
                             dict(n_layers=2)),
}


@pytest.mark.parametrize("case", list(ENGINE_16BIT_CASES))
def test_16bit_and_starcoder2_engine_matches_oracle_on_card(cuda, case):
    """16-bit qwen-7b and starcoder2-7b (16-bit, W4A16 and strategy2:
    sparse wo and up, tile_uniform sparse down, the gelu FFN's biases) at
    full width, 2 layers: every stream equals ``reference_decode``; per
    tick one attention launch and one FFN launch per layer, the norms
    through the fixed-order kernels, and no 16-bit product outside
    ``dense_matmul``."""
    arch, strategy, over = ENGINE_16BIT_CASES[case]
    from repro_torch.configs import get_config
    from repro_torch.core.compiler import quantize_model
    from repro_torch.models import api
    from repro_torch.serving.engine import Engine, Request, reference_decode
    cfg = get_config(arch, **over)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = quantize_model(api.init_params(cfg, gen), strategy)
    _build.launches.clear()
    engine = Engine(cfg, params, batch_size=3, max_len=64, chunk_size=16,
                    device="cuda")
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(3, 40))),
                    max_new_tokens=int(rng.integers(2, 8)))
            for i in range(6)]
    for r in reqs:
        engine.submit(r)
    assert len(engine.run()) == 6
    L, ticks = cfg.n_layers, engine.steps
    norms = ({"layernorm": 1, "add_layernorm": 2 * L}   # the adds fused
             if cfg.norm == "layernorm" else
             {"rmsnorm": 1, "add_rmsnorm": 2 * L})
    ffn = {"none": "ffn_fused_dense", "dense": (
        "ffn_fused_w4a16_gelu" if cfg.activation == "gelu"
        else "ffn_fused_w4a16"), "strategy2": "ffn_fused_sparse_gelu"}[
            strategy]
    matmul = "dense_matmul" if strategy == "none" else "w4a16_matmul"
    sparse = 2 * L if strategy == "strategy2" else 0     # wo and down
    assert _build.launches["mixed_flash_attention"] == ticks * L
    for norm, n in norms.items():
        assert _build.launches[norm] == ticks * n
    assert _build.launches["qkv_rope_write"] == ticks * L
    assert _build.launches[ffn] == ticks * L
    assert _build.launches[matmul] == ticks * (5 * L + 1) - ticks * sparse
    assert _build.launches["sparse_w4a16_matmul"] == ticks * sparse
    for r in reqs:
        assert r.output == reference_decode(cfg, params, r.prompt,
                                            r.max_new_tokens, max_len=64,
                                            device="cuda")


# -- the bf16 W4A16 tensor-core tile (csrc/w4a16_mma_tile.cuh) ---------------
# The launcher picks its tile by the token count: T <= 16 (16 x 32, or
# 16 x 128 past 33792 outputs), T <= 128, above (64 x 128, or 128 x 128
# once that gives every SM a block).

@pytest.mark.parametrize("tokens", [1, 3, 16, 17, 255, 300])
@pytest.mark.parametrize("in_f", [128, 384])
@pytest.mark.parametrize("out_f", [4, 36, 300, 644, 151936])
def test_w4a16_mma_tile_ragged_shapes(cuda, tokens, in_f, out_f):
    """bf16 kernel 1 at a contraction of one and three 128-row groups (the
    decode tiles' two-group stages then end half past in_f), output
    widths that are no multiple of 16 (4, 36, 300, 644: the 4-byte packed
    and 8-byte scale copies) and qwen-7b's vocabulary, token counts on
    both sides of each tile boundary; the f32 bias on the 384-row cases."""
    from repro_torch.kernels.w4a16_matmul import (
        w4a16_matmul_cuda, w4a16_matmul_torch)
    gen = torch.Generator(device="cuda").manual_seed(tokens + in_f + out_f)
    qt = quantize(_rand(gen, in_f, out_f) * 0.05)
    b = _rand(gen, out_f) * 0.1 if in_f == 384 else None
    x = _rand(gen, tokens, in_f, dtype=torch.bfloat16)
    before = _build.launches["w4a16_matmul"]
    got = w4a16_matmul_cuda(x, qt, b)
    assert _build.launches["w4a16_matmul"] == before + 1
    _close(got, w4a16_matmul_torch(x, qt, b), torch.bfloat16)
    _rows_alone_equal(lambda v: w4a16_matmul_cuda(v, qt, b), x, got)


@pytest.mark.parametrize("tokens", [3, 40, 300])
def test_w4a16_mma_tile_unaligned_operands_bitwise(cuda, tokens):
    """Packed weights 4 bytes and scales 8 bytes past a 16-byte boundary
    (the 4- and 8-byte copies) fill the ring with the same bits as the
    16-byte copies, and an x 2 bytes past one is copied to an aligned
    buffer: the results are bitwise equal."""
    from repro_torch.core.quant import QuantizedTensor
    gen = torch.Generator(device="cuda").manual_seed(tokens)
    in_f, out_f = 256, 528
    qt = quantize(_rand(gen, in_f, out_f) * 0.05)
    x = _rand(gen, tokens, in_f, dtype=torch.bfloat16)
    want = ops.w4a16_matmul(x, qt)
    pk = torch.empty(qt.packed.numel() + 4, dtype=torch.uint8, device="cuda")
    pk_odd = pk[4:].view(qt.packed.shape)
    pk_odd.copy_(qt.packed)
    sc = torch.empty(qt.scales.numel() + 4, dtype=torch.bfloat16,
                     device="cuda")
    sc_odd = sc[4:].view(qt.scales.shape)
    sc_odd.copy_(qt.scales)
    assert pk_odd.data_ptr() % 16 and sc_odd.data_ptr() % 16
    odd = QuantizedTensor(pk_odd, sc_odd, qt.shape, qt.group_size)
    xs = torch.empty(tokens * in_f + 1, dtype=torch.bfloat16, device="cuda")
    x_odd = xs[1:].view(tokens, in_f)
    x_odd.copy_(x)
    assert x_odd.data_ptr() % 16
    assert torch.equal(ops.w4a16_matmul(x, odd), want)
    assert torch.equal(ops.w4a16_matmul(x_odd, qt), want)
    assert torch.equal(ops.w4a16_matmul(x_odd, odd), want)


@pytest.mark.parametrize("bias", [False, True])
def test_w4a16_matmul_rows_invariant_across_tiles(cuda, bias):
    from repro_torch.kernels.w4a16_matmul import w4a16_matmul_cuda
    gen = torch.Generator(device="cuda").manual_seed(19)
    qt = quantize(_rand(gen, 4096, 4096) * 0.02)
    b = _rand(gen, 4096) * 0.1 if bias else None
    x = _rand(gen, 1024, 4096, dtype=torch.bfloat16)
    _tile_invariant(lambda v: w4a16_matmul_cuda(v, qt, b), x)


# -- the bf16 tensor-core flash attention (kernel 7) --------------------------

MASKS = {"causal": (True, None), "window": (True, 40),
         "non-causal": (False, None)}


@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("sq,skv", [(70, 203), (150, 90)])
def test_flash_mma_kernel_matches_plain(cuda, head_dim, mask, sq, skv):
    """bf16 kernel 7 on the tensor cores at every head dim it takes, each
    mask, a q block ending a longer context (Sq < Skv) and Sq > Skv, where
    under the causal masks the first Sq - Skv rows see no key and are
    zeros; ragged query and key tiles throughout."""
    causal, window = MASKS[mask]
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(head_dim + sq)
    q = _rand(gen, 2, 6, sq, head_dim, dtype=bf16)
    k = _rand(gen, 2, 2, skv, head_dim, dtype=bf16)
    v = _rand(gen, 2, 2, skv, head_dim, dtype=bf16)
    got = ops.attention(q, k, v, causal=causal, window=window)
    assert bool(torch.isfinite(got).all())
    _close(got, flash_attention_torch(q, k, v, causal=causal, window=window,
                                      block_q=BLOCK_Q, block_kv=BLOCK_KV),
           bf16)
    if causal and sq > skv:
        assert bool((got[:, :, :sq - skv] == 0).all())


@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("mask", list(MASKS))
def test_flash_mma_rows_invariant_across_query_tiling(cuda, head_dim, mask):
    """A query row's bits do not depend on where the query tiling puts it:
    the last 237, 64 and 1 queries of a 300-query call (each start falls
    at another row of a 64-row tile) are bitwise those queries alone."""
    causal, window = MASKS[mask]
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(head_dim)
    q = _rand(gen, 1, 4, 300, head_dim, dtype=bf16)
    k = _rand(gen, 1, 2, 300, head_dim, dtype=bf16)
    v = _rand(gen, 1, 2, 300, head_dim, dtype=bf16)
    full = ops.attention(q, k, v, causal=causal, window=window)
    for n in (237, 64, 1):
        assert torch.equal(full[:, :, -n:], ops.attention(
            q[:, :, -n:], k, v, causal=causal, window=window)), n


# -- kernel 3's bf16 tensor-core kernel (csrc/decode_flash.cu) ----------------
# Splits of split_span(bk) keys from key 0, 64-key steps, folded in order.

ATTN_VARIANTS = [(False, False), (False, True), (True, False), (True, True)]
ATTN_IDS = ["slot", "slot-int8", "paged", "paged-int8"]


@pytest.mark.parametrize("paged,quant", ATTN_VARIANTS, ids=ATTN_IDS)
@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("page", [8, 16, 32, 48, 96, 128])
@pytest.mark.parametrize("chunk", [1, 16, 64])
@pytest.mark.parametrize("window", [None, 24])
def test_attention_mma_matches_plain(cuda, paged, quant, head_dim, page,
                                     chunk, window):
    """bf16 kernel 3, every variant, head dim and page size (the slot
    layout walking tiles of the same size), decode and chunks, with and
    without a window, against its plain version; 256- or 288-key caches,
    so rows cross split boundaries (spans of 128 keys, and of 96 at pages
    48 and 96: a partial second step, keys past the split masked); dead
    queries are exact zeros; paged is bitwise the slot kernel at
    ``block_kv = page``."""
    gen = torch.Generator(device="cuda").manual_seed(
        head_dim + page + chunk + 7 * quant)
    b, hq, hkv, s = 3, 8, 2, 256 if 256 % page == 0 else 288
    leaves, pool, table = _attention_operands(
        gen, torch.bfloat16, b, hkv, s, head_dim, page, quant)
    q = _rand(gen, b, hq, chunk, head_dim, dtype=torch.bfloat16)
    lengths = torch.tensor([37, 256, 130 + chunk], dtype=torch.int32,
                           device="cuda")
    q_lens = torch.tensor([min(chunk, 3), chunk, max(chunk - 2, 1)],
                          dtype=torch.int32, device="cuda")
    cache, kw = ((pool, {"page_table": table}) if paged
                 else (leaves, {"block_kv": page}))
    name = VARIANTS_NAMES[(paged, quant)]
    before = _build.launches[name]
    got = _attend(q, cache, lengths, q_lens, window=window, **kw)
    assert _build.launches[name] == before + 1
    assert bool(torch.isfinite(got).all())
    _close(got, _attend(q, cache, lengths, q_lens, window=window,
                        impl="torch", **kw), torch.bfloat16)
    for r in range(b):
        assert bool((got[r, :, int(q_lens[r]):] == 0).all())
    if paged:
        assert torch.equal(got, _attend(q, leaves, lengths, q_lens,
                                        window=window, block_kv=page))


@pytest.mark.parametrize("paged,quant", ATTN_VARIANTS, ids=ATTN_IDS)
@pytest.mark.parametrize("window", [None, 40])
def test_attention_mma_rows_bitwise(cuda, paged, quant, window, monkeypatch):
    """A query row's bits do not depend on B, C or how many splits the call
    has: each query of a 64-wide chunk is its own decode (C = 1 at length
    q_pos + 1, the engine's oracle); rows 0-1 alone are those rows of a
    batch of 5; moving other rows' lengths across split boundaries, or
    launching the chunk in slices of its queries (a small scratch budget),
    changes nothing."""
    from repro_torch.kernels import decode_flash
    gen = torch.Generator(device="cuda").manual_seed(30 + 2 * paged + quant)
    b, hq, hkv, s, d, bs = 5, 16, 2, 512, 128, 16
    leaves, pool, table = _attention_operands(gen, torch.bfloat16, b, hkv,
                                              s, d, bs, quant)
    cache, kw = (pool, {"page_table": table}) if paged else (leaves, {})

    def rows(idx):
        if paged:
            return pool, {"page_table": table[idx]}
        return {n: t[idx] for n, t in leaves.items()}, {}
    q = _rand(gen, b, hq, 64, d, dtype=torch.bfloat16)
    lengths = torch.tensor([300, 129, 512, 64, 200], dtype=torch.int32,
                           device="cuda")
    q_lens = torch.tensor([64, 1, 17, 64, 0], dtype=torch.int32,
                          device="cuda")
    full = _attend(q, cache, lengths, q_lens, window=window, **kw)
    c0, k0 = rows(slice(0, 1))
    for j in (0, 13, 63):
        at = torch.tensor([300 - 64 + j + 1], dtype=torch.int32,
                          device="cuda")
        one = _attend(q[:1, :, j:j + 1].contiguous(), c0, at,
                      torch.ones_like(at), window=window, **k0)
        assert torch.equal(full[0, :, j], one[0, :, 0]), j
    c2, k2 = rows(slice(0, 2))
    assert torch.equal(_attend(q[:2], c2, lengths[:2], q_lens[:2],
                               window=window, **k2), full[:2])
    moved = lengths.clone()
    moved[2], moved[3], moved[4] = 127, 257, 385
    other = _attend(q, cache, moved, q_lens, window=window, **kw)
    assert torch.equal(other[:2], full[:2])
    monkeypatch.setattr(decode_flash, "SPLIT_SCRATCH_BYTES", 1 << 20)
    assert torch.equal(_attend(q, cache, lengths, q_lens, window=window,
                               **kw), full)


# -- kernel 2's bf16 gate/up stage on the W4A16 tensor-core tile --------------
# Gated: gate and up against one staged x tile (W4MmaGated*); gelu: kernel
# 1's one-weight tile with the f32 up bias in the epilogue.

@pytest.mark.parametrize("tokens", [1, 16, 17, 255, 300])
@pytest.mark.parametrize("d", [128, 384])
@pytest.mark.parametrize("f", [36, 300, 644])
@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_ffn_gate_up_mma_ragged_shapes(cuda, tokens, d, f, activation):
    """bf16 kernel 2's first stage at one and three 128-row groups, hidden
    widths that are no multiple of 16 (the 4- and 8-byte weight copies)
    and token counts on both sides of each tile boundary, against its plain
    version; rows alone are bitwise the rows of the call."""
    from repro_torch.kernels.ffn_fused import (
        GELU_NAME, NAME, ffn_gate_up_cuda, ffn_gate_up_torch)
    gen = torch.Generator(device="cuda").manual_seed(tokens + d + f)
    gated = activation != "gelu"
    gate = quantize(_rand(gen, d, f) * 0.05) if gated else None
    up = quantize(_rand(gen, d, f) * 0.05)
    ub = None if gated else _rand(gen, f) * 0.1
    x = _rand(gen, tokens, d, dtype=torch.bfloat16)
    name = NAME if gated else GELU_NAME
    before = _build.launches[name]
    got = ffn_gate_up_cuda(x, gate, up, activation, ub)
    assert _build.launches[name] == before + 1
    _close(got, ffn_gate_up_torch(x, gate, up, activation, ub),
           torch.bfloat16)
    _rows_alone_equal(lambda v: ffn_gate_up_cuda(v, gate, up, activation,
                                                 ub), x, got)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_ffn_gate_up_mma_rows_invariant_across_tiles(cuda, activation):
    """Rows 100-103 of kernel 2's bf16 stage (and of the whole FFN) are
    bitwise the same alone and inside every tile configuration's calls."""
    from repro_torch.kernels.ffn_fused import ffn_gate_up_cuda
    gen = torch.Generator(device="cuda").manual_seed(21)
    d, f = 1024, 2816
    gated = activation != "gelu"
    gate = quantize(_rand(gen, d, f) * 0.02) if gated else None
    up = quantize(_rand(gen, d, f) * 0.02)
    down = quantize(_rand(gen, f, d) * 0.02)
    ub = None if gated else _rand(gen, f) * 0.1
    kw = {} if gated else dict(up_bias=ub, down_bias=_rand(gen, d) * 0.1)
    x = _rand(gen, 1024, d, dtype=torch.bfloat16)
    _tile_invariant(lambda v: ffn_gate_up_cuda(v, gate, up, activation, ub),
                    x)
    _tile_invariant(lambda v: ops.ffn_w4a16(v, gate, up, down,
                                            activation=activation, **kw), x)


@pytest.mark.parametrize("tokens", [3, 40, 300])
def test_ffn_gate_up_mma_unaligned_operands_bitwise(cuda, tokens):
    """Gate and up weights 4 (packed) and 8 bytes (scales) past a 16-byte
    boundary take the narrow copies and fill the ring with the same bits;
    an x 2 bytes past one is copied to an aligned buffer."""
    from repro_torch.core.quant import QuantizedTensor
    from repro_torch.kernels.ffn_fused import ffn_gate_up_cuda
    gen = torch.Generator(device="cuda").manual_seed(40 + tokens)
    d, f = 256, 528
    gate, up = (quantize(_rand(gen, d, f) * 0.05) for _ in range(2))
    x = _rand(gen, tokens, d, dtype=torch.bfloat16)
    want = ffn_gate_up_cuda(x, gate, up, "swiglu")

    def odd(qt):
        pk = torch.empty(qt.packed.numel() + 4, dtype=torch.uint8,
                         device="cuda")[4:].view(qt.packed.shape)
        pk.copy_(qt.packed)
        sc = torch.empty(qt.scales.numel() + 4, dtype=torch.bfloat16,
                         device="cuda")[4:].view(qt.scales.shape)
        sc.copy_(qt.scales)
        assert pk.data_ptr() % 16 and sc.data_ptr() % 16
        return QuantizedTensor(pk, sc, qt.shape, qt.group_size)
    xs = torch.empty(tokens * d + 1, dtype=torch.bfloat16, device="cuda")
    x_odd = xs[1:].view(tokens, d)
    x_odd.copy_(x)
    assert torch.equal(ffn_gate_up_cuda(x, odd(gate), up, "swiglu"), want)
    assert torch.equal(ffn_gate_up_cuda(x_odd, gate, odd(up), "swiglu"), want)


# -- the bf16 log-scale sparse tile (csrc/sparse_mma_tile.cuh) ----------------
# Kernel 4 and kernel 5's gate/up stage (two weights, or up alone with its
# bias for gelu) on mma.sync; the launcher picks the tile by the token
# count: T <= 16 (16 x 32), T <= 128 (64 x 64), above (64 x 128, or, for
# one weight, 128 x 128 once that gives every SM a block).

# (in_f, out_f, density, m, tile_uniform): qwen-7b's wo pattern, down
# patterns (m = 2, tile_uniform), an odd kept count (S = 3: the two-block
# decode stages end half past the last block) and one kept block a tile
SPARSE_LAYOUTS = {"wo": (1024, 384, 0.5, 8, False),
                  "down": (768, 256, 0.5, 2, True),
                  "odd-S": (768, 512, 0.5, 2, False),
                  "S=1": (256, 640, 0.5, 2, True)}


@pytest.mark.parametrize("tokens", [1, 4, 17, 37, 300])
@pytest.mark.parametrize("layout", list(SPARSE_LAYOUTS))
@pytest.mark.parametrize("bias", [False, True])
def test_sparse_mma_tile_ragged_shapes(cuda, tokens, layout, bias):
    """bf16 kernel 4 on the tensor-core tile against its plain version over
    ragged token counts on both sides of each tile boundary, with and
    without the f32 bias; rows alone are bitwise the rows of the call."""
    from repro_torch.kernels.sparse_w4a16 import (
        sparse_w4a16_matmul_cuda, sparse_w4a16_matmul_torch)
    in_f, out_f, density, m, tu = SPARSE_LAYOUTS[layout]
    gen = torch.Generator(device="cuda").manual_seed(tokens + in_f + out_f)
    st = block_sparsify_quantize(_rand(gen, in_f, out_f) * 0.05, density,
                                 blocks_per_group=m, tile_uniform=tu)
    b = _rand(gen, out_f) * 0.1 if bias else None
    x = _rand(gen, tokens, in_f, dtype=torch.bfloat16)
    before = _build.launches["sparse_w4a16_matmul"]
    got = sparse_w4a16_matmul_cuda(x, st, b)
    assert _build.launches["sparse_w4a16_matmul"] == before + 1
    _close(got, sparse_w4a16_matmul_torch(x, st, b), torch.bfloat16)
    _rows_alone_equal(lambda v: sparse_w4a16_matmul_cuda(v, st, b), x, got)


@pytest.mark.parametrize("tokens", [1, 4, 17, 37, 300])
@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("f_tiles", ["all", "kept"])
def test_sparse_ffn_mma_ragged_shapes(cuda, tokens, activation, f_tiles):
    """bf16 kernel 5's first stage against its plain version: gate and up
    each gather their own kept blocks (two weights), or up alone with its
    bias (gelu), over every f-tile or a tile_uniform down's kept ones."""
    gen = torch.Generator(device="cuda").manual_seed(60 + tokens)
    d, f = 768, 640
    gated = activation != "gelu"
    gate, up = (block_sparsify_quantize(_rand(gen, d, f) * 0.05, 0.5,
                                        blocks_per_group=2)
                for _ in range(2))
    if not gated:
        gate = None
    assert gated is False or not torch.equal(gate.block_idx, up.block_idx)
    ub = None if gated else _rand(gen, f) * 0.1
    tiles = (None if f_tiles == "all" else
             torch.tensor([4, 1, 3], dtype=torch.int32, device="cuda"))
    cols = (torch.arange(f, device="cuda") if tiles is None else
            (tiles.long()[:, None] * 128
             + torch.arange(128, device="cuda")).reshape(-1))
    x = _rand(gen, tokens, d, dtype=torch.bfloat16)
    h = ffn_gate_up_sparse_cuda(x, gate, up, activation, tiles, ub)
    _close(h[:, cols], ffn_gate_up_sparse_torch(x, gate, up, activation,
                                                tiles, ub), torch.bfloat16)
    _rows_alone_equal(
        lambda v: ffn_gate_up_sparse_cuda(v, gate, up, activation, tiles,
                                          ub)[:, cols], x, h[:, cols])


@pytest.mark.parametrize("bias", [False, True])
def test_sparse_w4a16_rows_invariant_across_tiles(cuda, bias):
    """Rows 100-103 of bf16 kernel 4 at qwen-7b's wo (4096 -> 4096, half
    the blocks kept) alone are bitwise the same inside every tile
    configuration's calls, with and without the bias."""
    from repro_torch.kernels.sparse_w4a16 import sparse_w4a16_matmul_cuda
    gen = torch.Generator(device="cuda").manual_seed(23)
    st = block_sparsify_quantize(_rand(gen, 4096, 4096) * 0.02, 0.5)
    b = _rand(gen, 4096) * 0.1 if bias else None
    x = _rand(gen, 1024, 4096, dtype=torch.bfloat16)
    _tile_invariant(lambda v: sparse_w4a16_matmul_cuda(v, st, b), x)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_sparse_ffn_rows_invariant_across_tiles(cuda, activation):
    """Rows 100-103 of bf16 kernel 5's stage and of the whole sparse FFN
    (tile_uniform sparse down) alone are bitwise the same inside every
    tile configuration's calls."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    d, f = 1024, 2816
    gate, up, down = _sparse_ffn(gen, d, f, "sparse")
    kw = _ffn_biases(gen, activation, f, d)
    if activation == "gelu":
        gate = None
    tiles = kept_f_tiles(down)
    x = _rand(gen, 1024, d, dtype=torch.bfloat16)
    cols = (tiles.long()[:, None] * 128
            + torch.arange(128, device="cuda")).reshape(-1)
    _tile_invariant(lambda v: ffn_gate_up_sparse_cuda(
        v, gate, up, activation, tiles, kw.get("up_bias"))[:, cols], x)
    _tile_invariant(lambda v: ops.ffn_w4a16(v, gate, up, down,
                                            activation=activation, **kw), x)


def _odd_sparse(st):
    """``st`` with its packed blocks 4 bytes and its scales 8 bytes past a
    16-byte boundary."""
    import dataclasses
    pk = torch.empty(st.packed.numel() + 4, dtype=torch.uint8,
                     device="cuda")[4:].view(st.packed.shape)
    pk.copy_(st.packed)
    sc = torch.empty(st.scales.numel() + 4, dtype=torch.bfloat16,
                     device="cuda")[4:].view(st.scales.shape)
    sc.copy_(st.scales)
    assert pk.data_ptr() % 16 and sc.data_ptr() % 16
    return dataclasses.replace(st, packed=pk, scales=sc)


@pytest.mark.parametrize("tokens", [3, 40, 300])
def test_sparse_mma_unaligned_operands_bitwise(cuda, tokens):
    """Sparse weights 4 (packed) and 8 bytes (scales) past a 16-byte
    boundary take the narrow copies and fill the ring with the same bits;
    an x 2 bytes past one is copied to an aligned buffer: kernel 4 and both
    branches of kernel 5 give the same bits as with aligned operands."""
    gen = torch.Generator(device="cuda").manual_seed(70 + tokens)
    d, f = 768, 640
    st = block_sparsify_quantize(_rand(gen, d, f) * 0.05, 0.5,
                                 blocks_per_group=2)
    up = block_sparsify_quantize(_rand(gen, d, f) * 0.05, 0.5,
                                 blocks_per_group=2)
    ub = _rand(gen, f) * 0.1
    x = _rand(gen, tokens, d, dtype=torch.bfloat16)
    xs = torch.empty(tokens * d + 1, dtype=torch.bfloat16, device="cuda")
    x_odd = xs[1:].view(tokens, d)
    x_odd.copy_(x)
    assert x_odd.data_ptr() % 16
    want = ops.sparse_w4a16_matmul(x, st)
    assert torch.equal(ops.sparse_w4a16_matmul(x, _odd_sparse(st)), want)
    assert torch.equal(ops.sparse_w4a16_matmul(x_odd, st), want)
    for act, gate, bias in (("swiglu", st, None), ("gelu", None, ub)):
        want = ffn_gate_up_sparse_cuda(x, gate, up, act, None, bias)
        odd_gate = None if gate is None else _odd_sparse(gate)
        assert torch.equal(ffn_gate_up_sparse_cuda(
            x, odd_gate, up, act, None, bias), want), act
        assert torch.equal(ffn_gate_up_sparse_cuda(
            x_odd, gate, _odd_sparse(up), act, None, bias), want), act


# -- the KV write kernel and the engine's captured ticks ----------------------

def _kv_leaves(gen, lead, hd, kind):
    def rand(shape, dtype):
        if dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=gen,
                                 device="cuda", dtype=torch.int8)
        return _rand(gen, *shape, dtype=dtype)
    if kind == "int8":
        return {"k": rand((*lead, hd), torch.int8),
                "v": rand((*lead, hd), torch.int8),
                "k_scale": rand((*lead, 1), torch.float32),
                "v_scale": rand((*lead, 1), torch.float32)}
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    return {"k": rand((*lead, hd), dtype), "v": rand((*lead, hd), dtype)}


@pytest.mark.parametrize("hd", [128, 3])
@pytest.mark.parametrize("chunk", [1, 7, 64])
@pytest.mark.parametrize("kind", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("paged", [False, True])
def test_kv_write_kernel_matches_plain(cuda, paged, kind, chunk, hd):
    """Bitwise the plain version's index writes: ragged ``q_lens`` with a
    dead row (a decode write: a write mask and a rolling window's index),
    scrambled page tables, k contiguous and v a transposed view; the null
    block and every dead position keep their bits; one launch a call."""
    from repro_torch.kernels.kv_write import kv_write_torch
    gen = torch.Generator(device="cuda").manual_seed(chunk + hd)
    b, hkv, span, bs = 5, 4, 96, 16
    rng = np.random.default_rng(chunk)
    if chunk == 1:
        lengths = torch.from_numpy(rng.integers(1, 2 * span, b)).to(
            torch.int32)
        starts = ((lengths - 1) % span).cuda()            # rolling window
        q_lens = torch.tensor([1, 0, 1, 1, 0], dtype=torch.int32,
                              device="cuda")
    else:
        q = rng.integers(0, chunk + 1, b)
        q[1] = 0
        starts = torch.tensor([rng.integers(0, span - x + 1) for x in q],
                              dtype=torch.int32, device="cuda")
        q_lens = torch.from_numpy(q).to(torch.int32).cuda()
    table = None
    if paged:
        n_pages = span // bs
        perm = rng.permutation(b * n_pages + 7)[:b * n_pages]
        table = torch.from_numpy(perm.reshape(b, n_pages)).to(
            torch.int32).cuda()
        cache = _kv_leaves(gen, (b * n_pages + 8, hkv, bs), hd, kind)
    else:
        cache = _kv_leaves(gen, (b, hkv, span), hd, kind)
    rows = _kv_leaves(gen, (b, chunk, hkv), hd, kind)
    new = {n: t.transpose(1, 2) if n.startswith("v") else
           t.transpose(1, 2).contiguous() for n, t in rows.items()}
    want = {n: t.clone() for n, t in cache.items()}
    kv_write_torch(want, new, starts, q_lens, table)
    before = _build.launches["kv_write"]
    ops.kv_write(cache, new, starts, q_lens, page_table=table)
    torch.cuda.synchronize()
    assert _build.launches["kv_write"] == before + 1
    for n in cache:
        assert torch.equal(cache[n].view(torch.uint8),
                           want[n].view(torch.uint8)), n


GRAPH_CASES = {
    "dense": ("qwen-7b", "dense", dict(head_dim=128, n_heads=2,
                                        n_kv_heads=1, d_model=256)),
    "paged-int8": ("qwen-7b", "dense", dict(
        head_dim=128, n_heads=2, n_kv_heads=1, d_model=256,
        kv_layout="paged", kv_block_size=16, kv_pool_blocks=10,
        kv_quant="int8")),
    "xlstm": ("xlstm-1.3b", "dense", dict(d_model=256)),
    # 8 experts top-2 at 32-row groups (d 512 / 16), a tied head of 251
    # (odd) columns, the dropless capacity factor
    "moe": ("granite-moe-3b-a800m", "dense", dict(
        d_model=512, d_ff=512, n_heads=4, n_kv_heads=2, head_dim=128,
        n_experts=8, top_k=2, moe_capacity_factor=4.0, vocab_size=251)),
}


def _graph_engine(case):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.compiler import quantize_model
    from repro_torch.models import api
    from repro_torch.serving.engine import Engine
    arch, strategy, over = GRAPH_CASES[case]
    cfg = get_smoke_config(arch, dtype=torch.bfloat16, **over)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = quantize_model(api.init_params(cfg, gen), strategy)
    engine = Engine(cfg, params, batch_size=3, max_len=64, chunk_size=32,
                    audit_every=1, device="cuda")
    return cfg, params, engine


def _graph_workload(cfg, seed=2):
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(3, 40))),
                    max_new_tokens=int(rng.integers(2, 8)))
            for i in range(6)]


def _live_inputs(engine, name, width, rng):
    """Host inputs of a tick with live rows: a dead row, a decode row and
    prompt chunks (mixed), or a masked row (decode); paged rows lease
    distinct pool blocks in a scrambled order."""
    b = engine.batch
    per_row = (engine.pool_blocks // b * engine.block_size if engine.paged
               else engine.max_len)
    if name == "mixed":
        q_lens = rng.integers(1, width + 1, b).astype(np.int32)
        q_lens[0], q_lens[1] = 0, 1
        lengths = rng.integers(0, per_row - width + 1, b).astype(np.int32)
        host = {"tokens": rng.integers(0, engine.cfg.vocab_size,
                                       (b, width)).astype(np.int64),
                "lengths": lengths, "q_lens": q_lens}
        need = lengths + q_lens
    else:
        mask = np.ones(b, bool)
        mask[0] = False
        lengths = rng.integers(1, per_row + 1, b).astype(np.int32)
        host = {"tokens": rng.integers(0, engine.cfg.vocab_size,
                                       (b, 1)).astype(np.int64),
                "lengths": lengths, "write_mask": mask}
        need = lengths
    if engine.paged:
        table = np.full((b, engine.n_pages), engine._null_block, np.int32)
        free = rng.permutation(engine.pool_blocks)
        k = 0
        for i in range(b):
            n = -(-int(need[i]) // engine.block_size)
            table[i, :n] = free[k:k + n]
            k += n
        host["page_table"] = table
    return host


def _cache_leaves(tree):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _cache_leaves(tree[k])
        else:
            yield tree[k]


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_graph_replay_equals_eager_for_every_key(cuda, case):
    """Every key the engine captured: one replay on the engine's cache and
    the same function run eagerly on a copy give bitwise the same logits,
    tokens and cache or state leaves."""
    cfg, params, engine = _graph_engine(case)
    for r in _graph_workload(cfg):
        engine.submit(r)
    engine.run()
    keys = [k for k in engine.cache_compiles.keys() if k[0] != "insert"]
    assert {k[0] for k in keys} == {"mixed", "decode"}
    assert sorted(engine.capture_seconds) == sorted(keys)
    rng = np.random.default_rng(7)
    for name, bucket in keys:
        tick = engine._executable(name, None if name == "decode" else bucket)
        host = _live_inputs(engine, name, bucket, rng)
        copy = _clone_tree(engine.cache)
        tok_e, logits_e = tick.fn(params, copy, **{
            k: torch.from_numpy(a).cuda() for k, a in host.items()})
        tok_g, logits_g = tick(params, engine.cache, **host)
        torch.cuda.synchronize()
        assert torch.equal(logits_e, logits_g), (name, bucket)
        # ids and finiteness, as the engine reads them (past them the
        # packed tensor may hold padding that nothing reads)
        got, want = (_unpack_tick(t.cpu().numpy(), engine.batch,
                                  logits_e.dtype) for t in (tok_g, tok_e))
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        for a, g in zip(_cache_leaves(copy), _cache_leaves(engine.cache)):
            assert torch.equal(a, g), (name, bucket)


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_second_run_makes_no_new_capture(cuda, case):
    """The same workload served again on the same engine: no new miss or
    capture, the same streams, and launch counts that follow the ticks."""
    from repro_torch.kernels.decode_flash import VARIANTS
    cfg, params, engine = _graph_engine(case)
    streams, counts = [], []
    for _ in range(2):
        reqs = _graph_workload(cfg)
        for r in reqs:
            engine.submit(r)
        _build.launches.clear()
        steps, cols = engine.steps, engine.dispatched_columns
        assert len(engine.run()) == len(reqs)
        streams.append([r.output for r in reqs])
        counts.append(dict(_build.launches))
        if cfg.family == "ssm":
            assert counts[-1]["slstm_scan"] == (
                engine.dispatched_columns - cols) * 2
        else:
            ticks = engine.steps - steps
            attention = VARIANTS[(cfg.kv_layout == "paged",
                                  cfg.kv_quant == "int8")]
            assert counts[-1][attention] == ticks * cfg.n_layers
            assert counts[-1]["qkv_rope_write"] == ticks * cfg.n_layers
        if len(streams) == 1:
            misses = engine.cache_compiles.misses
            captured = dict(engine.capture_seconds)
    assert engine.cache_compiles.misses == misses <= engine.compile_budget
    assert engine.capture_seconds == captured
    assert streams[0] == streams[1] and counts[0] == counts[1]


@pytest.mark.parametrize("case", list(GRAPH_CASES) + ["slot-int8", "paged"])
def test_steps_never_sync_the_host(cuda, case):
    """A mixed step and a decode step on device inputs raise nothing under
    ``torch.cuda.set_sync_debug_mode("error")``: no host read, so each
    can be captured."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.compiler import quantize_model
    from repro_torch.models import api
    extra = {"slot-int8": dict(kv_quant="int8"),
             "paged": dict(kv_layout="paged", kv_block_size=16)}
    arch, strategy, over = GRAPH_CASES.get(case, GRAPH_CASES["dense"])
    cfg = get_smoke_config(arch, dtype=torch.bfloat16, **over,
                           **extra.get(case, {}))
    params = quantize_model(api.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0)), strategy)
    b, c = 3, 16
    cache = api.init_cache(cfg, b, 64, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (b, c), device="cuda")
    lengths = torch.tensor([3, 0, 9], dtype=torch.int32, device="cuda")
    q_lens = torch.tensor([5, 0, 16], dtype=torch.int32, device="cuda")
    kw = {}
    if api.has_paged_kv(cfg):
        kw["page_table"] = torch.arange(
            b * 4, dtype=torch.int32, device="cuda").reshape(b, 4)
    write_mask = q_lens > 0
    decode_lengths = lengths + q_lens + 1
    _build.prepare()
    api.mixed_step(cfg, params, cache, tokens, lengths, q_lens, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        api.mixed_step(cfg, params, cache, tokens, lengths, q_lens, **kw)
        api.decode_step(cfg, params, cache, tokens[:, :1], decode_lengths,
                        write_mask=write_mask, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _case_model(case):
    """A GRAPH_CASES model, or ``paged``: the dense case on a paged pool of
    16-token pages."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.compiler import quantize_model
    from repro_torch.models import api
    extra = {"paged": dict(kv_layout="paged", kv_block_size=16,
                           kv_pool_blocks=10)}
    arch, strategy, over = GRAPH_CASES.get(case, GRAPH_CASES["dense"])
    cfg = get_smoke_config(arch, dtype=torch.bfloat16, **over,
                           **extra.get(case, {}))
    params = quantize_model(api.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0)), strategy)
    return cfg, params


@pytest.mark.parametrize("case", ["dense", "paged", "paged-int8"])
def test_all_logits_positions_equal_sequential_decode(cuda, case):
    """``mixed_step(all_logits=True)`` at W = 4 and then 8 (rows at lengths
    0, 5, 13 and 29, ragged ``q_lens``, a dead row; paged: a scrambled
    page table): every live position's logits and every cache leaf
    bitwise the sequential ``decode_step``'s."""
    import dataclasses
    from repro_torch.models import api
    cfg, params = _case_model(case)
    cfg = dataclasses.replace(cfg, kv_pool_blocks=0)   # 4 x 4 pages
    b, max_len = 4, 64
    rng = np.random.default_rng(5)
    lens = np.asarray([0, 5, 13, 29], np.int32)
    kw = {}
    if api.has_paged_kv(cfg):
        kw["page_table"] = torch.tensor(
            rng.permutation(b * 4).reshape(b, 4), dtype=torch.int32,
            device="cuda")
    mix = api.init_cache(cfg, b, max_len, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (b, 32), device="cuda")
    api.mixed_step(cfg, params, mix, toks, [0] * b, lens, **kw)
    seq = _clone_tree(mix)
    for w, q_lens in ((4, [4, 0, 3, 4]), (8, [8, 5, 0, 8])):
        q_lens = np.asarray(q_lens, np.int32)
        toks = torch.randint(0, cfg.vocab_size, (b, w), device="cuda")
        logits, _ = api.mixed_step(cfg, params, mix, toks, lens, q_lens,
                                   all_logits=True, **kw)
        assert logits.shape == (b, w, cfg.vocab_size)
        for j in range(w):
            step, _ = api.decode_step(
                cfg, params, seq, toks[:, j:j + 1],
                lens + np.minimum(j, q_lens - 1) + 1,
                write_mask=torch.tensor(j < q_lens, device="cuda"), **kw)
            for r in np.flatnonzero(j < q_lens):
                assert torch.equal(logits[r, j], step[r]), (w, r, j)
        for a, g in zip(_cache_leaves(seq), _cache_leaves(mix)):
            assert torch.equal(a, g), w
        lens = lens + q_lens


def _rep_requests(cfg, n=6, seed=2, system=()):
    """Prompts of a 2-5 token pattern tiled 3 times (``tests/test_spec.py``
    ``_rep_reqs``), each after ``system``."""
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=np.concatenate([
        np.asarray(system, np.int64),
        np.tile(rng.integers(0, cfg.vocab_size, int(rng.integers(2, 6))),
                3)]), max_new_tokens=int(rng.integers(4, 10)))
        for i in range(n)]


@pytest.mark.parametrize("case", ["dense", "paged-int8"])
def test_speculating_and_sharing_engines_equal_the_oracle(cuda, case):
    """A speculating engine (and, paged, one that also shares prefixes)
    served twice: every stream equal to ``reference_decode``, drafts
    scored, prefix hits and copies on write, misses within the budget and
    none in the second run, the pool whole after ``drop_prefix_cache``."""
    from repro_torch.serving.engine import Engine, reference_decode
    cfg, params = _case_model(case)
    share = cfg.kv_layout == "paged"
    engine = Engine(cfg, params, batch_size=3, max_len=64, chunk_size=32,
                    spec_k=4, prefix_cache=share, audit_every=1,
                    device="cuda")
    system = np.random.default_rng(1).integers(0, cfg.vocab_size, 20)
    outs = []
    for run in range(2):
        reqs = _rep_requests(cfg, system=system if share else ())
        for r in reqs:
            engine.submit(r)
        assert len(engine.run()) == len(reqs)
        outs.append([r.output for r in reqs])
        if run == 0:
            misses = engine.cache_compiles.misses
    assert engine.cache_compiles.misses == misses <= engine.compile_budget
    assert outs[0] == outs[1]
    for r in reqs:
        assert r.output == reference_decode(cfg, params, r.prompt,
                                            r.max_new_tokens, max_len=64,
                                            device="cuda"), r.rid
    assert engine.spec_drafted > 0
    assert sorted(engine.capture_seconds) == sorted(
        k for k in engine.cache_compiles.keys() if k[0] != "insert")
    if share:
        assert engine.prefix_hits > 0 and engine.cow_copies > 0
        assert ("cow", 0) in engine.capture_seconds
        engine.drop_prefix_cache()
        stats = engine.pool_stats()
        assert stats["free"] == stats["total"] and not stats["leased"]


def test_cow_graph_replays_equal_the_eager_copy(cuda):
    """The ``("cow", 0)`` graph replayed twice (two copies of an int8
    pool's block, scales included) leaves every leaf bitwise what the
    eager ``copy_pool_block`` gives on a copy of the cache."""
    from repro_torch.models import api
    from repro_torch.serving.engine import Engine
    cfg, params = _case_model("paged-int8")
    engine = Engine(cfg, params, batch_size=2, max_len=64, chunk_size=32,
                    prefix_cache=True, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    for leaf in _cache_leaves(engine.cache):
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen,
                                     device="cuda", dtype=torch.int8))
        else:
            leaf.copy_(torch.rand(leaf.shape, generator=gen,
                                  device="cuda").to(leaf.dtype))
    copy = _clone_tree(engine.cache)
    tick = engine.cache_compiles.get(
        "cow", 0, lambda: engine._build_tick("cow", 0, None))
    assert ("cow", 0) in engine.capture_seconds
    for leaf_g, leaf_c in zip(_cache_leaves(engine.cache),
                              _cache_leaves(copy)):
        assert torch.equal(leaf_g, leaf_c)    # the capture wrote nothing
    for src, dst in ((3, 7), (7, 1)):
        tick(params, engine.cache, src=np.array([src], np.int64),
             dst=np.array([dst], np.int64))
        api.copy_pool_block(cfg, copy, torch.tensor([src], device="cuda"),
                            torch.tensor([dst], device="cuda"))
    torch.cuda.synchronize()
    for leaf_g, leaf_c in zip(_cache_leaves(engine.cache),
                              _cache_leaves(copy)):
        assert torch.equal(leaf_g, leaf_c)


# -- the fused glue: add_rmsnorm, add_layernorm and the q/k/v epilogue --------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,keep", [(4, 4096, True), (300, 4096, True),
                                         (3, 4608, False), (5, 128, True),
                                         (2, 6016, True)])
def test_add_rmsnorm_kernel_matches_plain(cuda, dtype, rows, d, keep):
    """Bitwise ``x + h`` then the rmsnorm kernel, s and n (s only when
    kept), up to the widest row the kernel stages in f32; one launch a
    call."""
    from repro_torch.kernels.rmsnorm import add_rmsnorm_torch
    gen = torch.Generator(device="cuda").manual_seed(rows + d)
    x, h = _rand(gen, rows, d, dtype=dtype), _rand(gen, rows, d, dtype=dtype)
    gamma = (1 + 0.1 * _rand(gen, d)).to(dtype)
    before = _build.launches["add_rmsnorm"]
    s, n = ops.add_rmsnorm(x, h, gamma, keep_sum=keep)
    torch.cuda.synchronize()
    assert _build.launches["add_rmsnorm"] == before + 1
    ps, pn = add_rmsnorm_torch(x, h, gamma)
    assert torch.equal(n.view(torch.uint8), pn.view(torch.uint8))
    assert (s is None) if not keep else torch.equal(s.view(torch.uint8),
                                                    ps.view(torch.uint8))
    assert torch.equal(ops.add_rmsnorm(x[:1], h[:1], gamma)[1], n[:1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,keep", [(4, 4608, True), (300, 4608, True),
                                         (3, 4608, False), (5, 144, True),
                                         (2, 16384, True)])
def test_add_layernorm_kernel_matches_plain(cuda, dtype, rows, d, keep):
    """Bitwise ``x + h`` then the layernorm kernel, s and n (s only when
    kept), at starcoder2-7b's width (55 KB staged in f32, past the 48 KB a
    block takes without an opt-in) up to the widest row the kernel takes
    in f32 (64 KB); one launch a call; a row alone bitwise inside the
    call."""
    from repro_torch.kernels.layernorm import add_layernorm_torch
    gen = torch.Generator(device="cuda").manual_seed(rows + d)
    x = _rand(gen, rows, d, dtype=dtype) * 3 + 1
    h = _rand(gen, rows, d, dtype=dtype)
    gamma = (1 + 0.1 * _rand(gen, d)).to(dtype)
    beta = (0.1 * _rand(gen, d)).to(dtype)
    before = _build.launches["add_layernorm"]
    s, n = ops.add_layernorm(x, h, gamma, beta, keep_sum=keep)
    torch.cuda.synchronize()
    assert _build.launches["add_layernorm"] == before + 1
    ps, pn = add_layernorm_torch(x, h, gamma, beta)
    assert torch.equal(n.view(torch.uint8), pn.view(torch.uint8))
    assert (s is None) if not keep else torch.equal(s.view(torch.uint8),
                                                    ps.view(torch.uint8))
    assert torch.equal(ops.add_layernorm(x[:1], h[:1], gamma, beta)[1],
                       n[:1])
    _close(n, ops.layernorm(x + h, gamma, beta, impl="torch"), dtype)


def test_layernorm_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    """The layernorm body stages a row of at most 64 KB with gamma and
    beta, 16-byte aligned: a wider row (f32 16400), a width off 16 bytes
    and a misaligned h or x raise before any launch."""
    from repro_torch.kernels.layernorm import (
        add_layernorm_cuda, layernorm_cuda)
    gen = torch.Generator(device="cuda").manual_seed(7)
    before = dict(_build.launches)
    for d, dtype in ((16400, torch.float32), (32776, torch.bfloat16),
                     (100, torch.bfloat16), (6, torch.float32)):
        x = _rand(gen, 2, d, dtype=dtype)
        g = _rand(gen, d, dtype=dtype)
        with pytest.raises(ValueError, match="bytes"):
            add_layernorm_cuda(x, x, g, g)
        with pytest.raises(ValueError, match="bytes"):
            layernorm_cuda(x, g, g)
    x = _rand(gen, 2, 4608, dtype=torch.bfloat16)
    g = _rand(gen, 4608, dtype=torch.bfloat16)
    h = _rand(gen, 2 * 4608 + 1, dtype=torch.bfloat16)[1:].view(2, 4608)
    with pytest.raises(ValueError, match="16-byte"):
        add_layernorm_cuda(x, h, g, g)
    with pytest.raises(ValueError, match="16-byte"):
        layernorm_cuda(h, g, g)
    assert dict(_build.launches) == before


@pytest.mark.parametrize("route", ["forward", "prefill"])
def test_starcoder2_full_sequence_fused_equals_plain_on_card(cuda, route,
                                                             monkeypatch):
    """starcoder2-7b at full width, 2 layers, 16-bit weights: ``forward``
    (B = 2, S = 64) and ``prefill`` launch ``add_layernorm`` 2L times and
    ``layernorm`` once, and their logits (and the prefill's cache) are
    bitwise the same calls with ``add_layernorm`` swapped for its plain
    chain (``x + h`` then the layernorm kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    cfg = get_config("starcoder2-7b", n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(25)
    params = api.init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                         device="cuda")
    L = cfg.n_layers

    def run():
        if route == "forward":
            return api.forward(cfg, params, {"tokens": toks})[0], {}
        return api.prefill(cfg, params, {"tokens": toks}, 80)

    _build.launches.clear()
    got, got_cache = run()
    torch.cuda.synchronize()
    assert _build.launches["add_layernorm"] == 2 * L
    assert _build.launches["layernorm"] == 1
    assert _build.launches["flash_attention"] == L
    with monkeypatch.context() as m:
        _plain_glue(m)
        want, want_cache = run()
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    for n in got_cache:
        assert torch.equal(got_cache[n].view(torch.uint8),
                           want_cache[n].view(torch.uint8)), n


@pytest.mark.parametrize("hd", [36, 128])
@pytest.mark.parametrize("chunk", [1, 16])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qkv_rope_write_kernel_matches_plain(cuda, dtype, paged, quant,
                                             chunk, hd):
    """Bitwise the chain it replaced (bias adds, ``apply_rope``,
    ``quantize_kv``, the ``kv_write`` kernel, ``q.contiguous()``): q at
    every live position and every cache leaf; a dead row, a masked row and
    a row at the span's last position; the null block keeps its bits; one
    launch a call."""
    b, hq, hkv, span, bs = 4, 6, 2, 64, 16
    gen = torch.Generator(device="cuda").manual_seed(chunk + hd)
    rng = np.random.default_rng(chunk + hd)
    if chunk == 1:
        rope_base = np.array([3, span - 1, 20, 63])
        starts, q_lens = rope_base, np.array([1, 1, 0, 1])
    else:
        q_lens = np.array([chunk, 0, 5, 1])
        starts = np.array([rng.integers(0, span - q + 1) for q in q_lens])
        rope_base = starts
    lead = (b * span // bs + 3, hkv, bs) if paged else (b, hkv, span)
    kv = torch.int8 if quant else dtype
    cache = {n: (torch.randint(-127, 128, (*lead, hd), generator=gen,
                               device="cuda", dtype=torch.int8)
                 if kv == torch.int8 else _rand(gen, *lead, hd, dtype=kv))
             for n in ("k", "v")}
    if quant:
        cache.update({n: _rand(gen, *lead, 1) for n in ("k_scale",
                                                        "v_scale")})
    table = None
    if paged:
        table = torch.from_numpy(rng.permutation(b * span // bs + 2)[
            :b * span // bs].reshape(b, span // bs).astype(np.int32)).cuda()
    q = _rand(gen, b, chunk, hq * hd, dtype=dtype)
    k = _rand(gen, b, chunk, hkv * hd, dtype=dtype)
    v = _rand(gen, b, chunk, hkv * hd, dtype=dtype)
    bias = tuple(_rand(gen, h * hd, dtype=dtype) for h in (hq, hkv, hkv))
    ints = {n: torch.tensor(a, dtype=torch.int32, device="cuda") for n, a in
            (("rope_base", rope_base), ("starts", starts),
             ("q_lens", q_lens))}
    want = {n: t.clone() for n, t in cache.items()}
    kw = dict(n_heads=hq, theta=1e4, page_table=table, **ints)
    before = _build.launches["qkv_rope_write"]
    got_q = ops.qkv_rope_write(cache, q, k, v, bias, **kw)
    torch.cuda.synchronize()
    assert _build.launches["qkv_rope_write"] == before + 1
    want_q = ops.qkv_rope_write(want, q, k, v, bias, impl="torch", **kw)
    for r, ql in enumerate(q_lens):       # a dead position's q is free
        assert torch.equal(got_q[r, :, :ql].view(torch.uint8),
                           want_q[r, :, :ql].view(torch.uint8))
    for n in cache:
        assert torch.equal(cache[n].view(torch.uint8),
                           want[n].view(torch.uint8)), n


def test_fused_wrappers_refuse_what_their_kernels_do_not_take(cuda):
    """The norm kernel stages a row and gamma of at most 47 KB, 16-byte
    aligned: a wider row (f32 6144 just past it), a width off 16 bytes and
    a misaligned operand raise before any launch."""
    from repro_torch.kernels.rmsnorm import add_rmsnorm_cuda, rmsnorm_cuda
    gen = torch.Generator(device="cuda").manual_seed(5)
    before = dict(_build.launches)
    for d, dtype in ((12040, torch.bfloat16), (6144, torch.float32),
                     (100, torch.bfloat16)):
        x = _rand(gen, 2, d, dtype=dtype)
        g = _rand(gen, d, dtype=dtype)
        with pytest.raises(ValueError, match="bytes"):
            add_rmsnorm_cuda(x, x, g)
        with pytest.raises(ValueError, match="bytes"):
            rmsnorm_cuda(x, g)
    x = _rand(gen, 2, 4096, dtype=torch.bfloat16)
    g = _rand(gen, 4096, dtype=torch.bfloat16)
    h = _rand(gen, 2 * 4096 + 1, dtype=torch.bfloat16)[1:].view(2, 4096)
    with pytest.raises(ValueError, match="16-byte"):
        add_rmsnorm_cuda(x, h, g)
    assert dict(_build.launches) == before


_EPILOGUE_AT = """
import sys
import torch
from repro_torch.kernels import ops
span, hd = 16, 64
cache = {n: torch.zeros(1, 1, span, hd, dtype=torch.bfloat16, device="cuda")
         for n in ("k", "v")}
q = torch.ones(1, 1, 2 * hd, dtype=torch.bfloat16, device="cuda")
k = v = torch.ones(1, 1, hd, dtype=torch.bfloat16, device="cuda")
pos = torch.tensor([int(sys.argv[1])], dtype=torch.int32, device="cuda")
ops.qkv_rope_write(cache, q, k, v, n_heads=2, theta=1e4, rope_base=pos,
                   starts=torch.zeros_like(pos), q_lens=torch.ones_like(pos))
torch.cuda.synchronize()
print("accepted")
"""


def test_epilogue_refuses_a_live_position_outside_its_table(cuda):
    """The epilogue's RoPE table holds the cache's span; a live position
    past it fails the launch (a device-side assert, so in a process of
    its own) instead of taking the last row's angle.  The span's last
    position is taken."""
    import os
    import pathlib
    import subprocess
    import sys
    import repro_torch
    env = dict(os.environ, PYTHONPATH=str(
        pathlib.Path(repro_torch.__file__).parents[1]))
    runs = {pos: subprocess.run([sys.executable, "-c", _EPILOGUE_AT, pos],
                                capture_output=True, text=True, env=env,
                                timeout=600)
            for pos in ("15", "16")}
    ok, bad = runs["15"], runs["16"]
    assert ok.returncode == 0 and "accepted" in ok.stdout, ok.stderr[-2000:]
    assert bad.returncode != 0 and "accepted" not in bad.stdout
    assert "outside the RoPE table" in bad.stdout + bad.stderr, \
        (bad.stdout + bad.stderr)[-2000:]


def _plain_glue(m):
    """Inside the ``monkeypatch`` context ``m``, the fused ops run their
    plain chains on the card (every other op keeps its kernel)."""
    import functools
    from repro_torch.kernels import kv_write as kvw
    from repro_torch.kernels import layernorm as ln
    from repro_torch.kernels import rmsnorm as rms
    m.setattr(ops, "add_rmsnorm_cuda", rms.add_rmsnorm_torch)
    m.setattr(ops, "add_layernorm_cuda", ln.add_layernorm_torch)
    m.setattr(ops, "qkv_rope_write_cuda", functools.partial(
        kvw.qkv_rope_write_torch, write=ops.kv_write))
    m.setattr(ops, "combine_add_rmsnorm_cuda",
              rms.combine_add_rmsnorm_torch)


FUSED_CASES = {"slot": {}, "int8": dict(kv_quant="int8"),
               "paged-int8": dict(kv_layout="paged", kv_block_size=16,
                                  kv_pool_blocks=64, kv_quant="int8")}


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_steps_equal_plain_chains_on_card(cuda, case, monkeypatch):
    """A mixed and a decode step through ``add_rmsnorm`` and the epilogue
    are bitwise the same steps with the two ops' plain chains: logits and
    every cache leaf."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import api
    cfg = get_smoke_config("qwen-7b", dtype=torch.bfloat16, head_dim=128,
                           n_heads=4, n_kv_heads=2, d_model=256,
                           **FUSED_CASES[case])
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = api.init_params(cfg, gen)
    b = 4
    toks = torch.randint(0, cfg.vocab_size, (b, 16), generator=gen,
                         device="cuda")
    lengths = torch.tensor([0, 3, 20, 40], dtype=torch.int32, device="cuda")
    q_lens = torch.tensor([16, 0, 5, 1], dtype=torch.int32, device="cuda")
    fused = api.init_cache(cfg, b, 64, "cuda")
    plain = {n: t.clone() for n, t in fused.items()}
    outs = []
    for cache in (fused, plain):
        with monkeypatch.context() as m:
            if cache is plain:
                _plain_glue(m)
            outs.append((
                api.mixed_step(cfg, params, cache, toks, lengths, q_lens)[0],
                api.decode_step(cfg, params, cache, toks[:, :1],
                                lengths + q_lens + 1,
                                write_mask=q_lens > 0)[0]))
    torch.cuda.synchronize()
    for got, want in zip(*outs):
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    for n in fused:
        assert torch.equal(fused[n].view(torch.uint8),
                           plain[n].view(torch.uint8)), n


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_rolling_window_decode_past_the_span_on_card(cuda, layout,
                                                     monkeypatch):
    """24 decode steps through a 16-token span under a 16-token window (a
    rolling buffer: positions run past the span and the epilogue's table)
    are bitwise the same steps through the two ops' plain chains: logits
    at every step and every cache leaf."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import api
    over = dict(kv_layout="paged", kv_block_size=8) if layout == "paged" \
        else {}
    cfg = dataclasses.replace(get_smoke_config(
        "qwen-7b", dtype=torch.bfloat16, **over), window=16)
    gen = torch.Generator(device="cuda").manual_seed(6)
    params = api.init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (24,), generator=gen,
                         device="cuda")
    caches = {"fused": api.init_cache(cfg, 1, 16, "cuda")}
    caches["plain"] = {n: t.clone() for n, t in caches["fused"].items()}
    for n in range(1, 25):
        logits = {}
        for name, cache in caches.items():
            with monkeypatch.context() as m:
                if name == "plain":
                    _plain_glue(m)
                logits[name], _ = api.decode_step(
                    cfg, params, cache, toks[n - 1].view(1, 1), [n])
        assert torch.equal(logits["fused"].view(torch.uint8),
                           logits["plain"].view(torch.uint8)), n
    for leaf in caches["fused"]:
        assert torch.equal(caches["fused"][leaf].view(torch.uint8),
                           caches["plain"][leaf].view(torch.uint8)), leaf


# -- the lifecycle on captured graphs ------------------------------------------

def _lifecycle_model(layout, pool_blocks=24):
    """GRAPH_CASES' dense model (bf16, head dim 128, W4A16), on a slot
    cache or a pool of 16-token pages."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.compiler import quantize_model
    from repro_torch.models import api
    over = (dict(kv_layout="paged", kv_block_size=16,
                 kv_pool_blocks=pool_blocks) if layout == "paged" else {})
    cfg = get_smoke_config("qwen-7b", dtype=torch.bfloat16, head_dim=128,
                           n_heads=2, n_kv_heads=1, d_model=256, **over)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cfg, quantize_model(api.init_params(cfg, gen), "dense")


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_finite_flag_quarantines_a_nan_row_on_card(cuda, layout):
    """One ``embed`` row set to NaN on the card, its id in one prompt only
    (no other prompt and no oracle stream holds it): through captured
    graphs, the flag that comes back with the ids quarantines exactly that
    row; every other stream equals ``reference_decode``, later requests
    take its slot and blocks, the null block stays finite and the pool is
    whole."""
    from repro_torch.serving.engine import Engine, Request, reference_decode
    cfg, params = _lifecycle_model(layout)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n)
               for n in (12, 9, 20, 7, 10, 11)]
    oracle = [reference_decode(cfg, params, p, 6, max_len=64)
              for p in prompts]
    used = {int(x) for p in prompts for x in p} | \
        {x for s in oracle for x in s}
    poison = next(x for x in range(cfg.vocab_size) if x not in used)
    prompts[0][5] = poison
    params["embed"][poison] = float("nan")
    engine = Engine(cfg, params, batch_size=2, max_len=64, chunk_size=16,
                    audit_every=1, device="cuda")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    assert engine.run().drained
    assert engine.capture_seconds, "no tick was captured"
    assert [r.status for r in reqs] == ["error"] + ["done"] * 5
    assert reqs[0].error == "non-finite logits" and engine.row_faults == 1
    for r in reqs[1:]:
        assert r.output == oracle[r.rid], r.rid
    if layout == "paged":
        assert engine.alloc.n_free == engine.pool_blocks
        for leaf in engine.cache.values():
            assert torch.isfinite(
                leaf[:, engine._null_block].float()).all()


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_preemption_on_captured_graphs_equals_the_oracle(cuda, prefix_cache):
    """A pool of 6 16-token pages (short of two requests' worst cases):
    the head preempts the running hog (its blocks donated when sharing),
    which re-admits through the same captured graphs; both streams equal
    ``reference_decode``, misses stay within the budget and a second run
    captures nothing."""
    from repro_torch.serving.engine import Engine, Request, reference_decode
    cfg, params = _lifecycle_model("paged", pool_blocks=6)
    rng = np.random.default_rng(8)
    hog_p, head_p = (rng.integers(0, cfg.vocab_size, n) for n in (20, 30))
    oracle = [reference_decode(cfg, params, hog_p, 40, max_len=96),
              reference_decode(cfg, params, head_p, 30, max_len=96)]
    engine = Engine(cfg, params, batch_size=2, max_len=96, chunk_size=16,
                    prefix_cache=prefix_cache, max_preemptions=2,
                    audit_every=1, device="cuda")
    for run in range(2):
        hog = Request(rid=2 * run, prompt=hog_p, max_new_tokens=40)
        head = Request(rid=2 * run + 1, prompt=head_p, max_new_tokens=30)
        engine.submit(hog)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            engine.run(max_steps=6)
        assert 0 < len(hog.output) < 40
        engine.submit(head)
        misses = engine.cache_compiles.misses
        assert engine.run().drained
        assert hog.preemptions >= 1 and hog.status == head.status == "done"
        assert [hog.output, head.output] == oracle
        if run:
            assert engine.cache_compiles.misses == misses
    assert engine.cache_compiles.misses <= engine.compile_budget
    assert sorted(engine.capture_seconds) == sorted(
        k for k in engine.cache_compiles.keys() if k[0] != "insert")
    engine.drop_prefix_cache()
    assert engine.alloc.n_free == engine.pool_blocks


# -- durable serving: snapshot, kill, restore on captured graphs ------------

@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_restore_on_card_equals_the_never_killed_engine(cuda, layout,
                                                       tmp_path):
    """A mid-flight ``snapshot()``, three more ticks into the journal only,
    the engine dropped, then ``Engine.restore`` on the card: the restore
    captures its graphs over the in-place-loaded cache (each graph holds
    the restored engine's cache tensor for tensor, loaded bitwise from the
    snapshot), no tick after it captures, a deliberate rebind of the cache
    raises at the replay, and the durable streams equal the never-killed
    engine's (so ``reference_decode``'s)."""
    import gc

    from repro_torch.models import api
    from repro_torch.serving import snapshot as snaplib
    from repro_torch.serving.engine import Engine, Request, reference_decode
    from repro_torch.train import checkpoint
    cfg, params = _lifecycle_model(layout)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (20, 9, 33, 14,
                                                           27)]
    kw = dict(batch_size=2, max_len=96, chunk_size=16, audit_every=1,
              device="cuda")
    whole = Engine(cfg, params, **kw)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=12)
            for i, p in enumerate(prompts)]
    for r in reqs:
        whole.submit(r)
    assert whole.run().drained
    want = {r.rid: r.output for r in reqs}
    assert want == {i: reference_decode(cfg, params, p, 12, max_len=96)
                    for i, p in enumerate(prompts)}
    del whole
    wd = str(tmp_path / "store")
    eng = Engine(cfg, params, snapshot_dir=wd, **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=12))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        eng.run(max_steps=5)
        eng.snapshot()
        eng.run(max_steps=3)
    snap = snaplib.latest_snapshot(wd)[1]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    restored = Engine.restore(wd, params)
    assert restored.device.type == "cuda"
    arrays, _ = checkpoint.read_state(os.path.join(snap, "device"),
                                      {"cache": restored.cache})
    host = api.export_cache(cfg, restored.cache)
    for path, leaf in checkpoint.tree_paths(host):
        got = (leaf.view(torch.int16).numpy().view(np.uint16)
               if leaf.dtype == torch.bfloat16 else leaf.numpy())
        assert np.array_equal(got, arrays["cache/" + path]), path
    cc = restored.cache_compiles
    ticks = {k: cc.get(*k, None) for k in cc.keys() if k[0] != "insert"}
    assert sorted(ticks) == sorted(restored._key_space())
    assert all(t.cache is restored.cache and t.params is params
               for t in ticks.values())
    misses = cc.misses
    assert misses <= restored.compile_budget
    assert restored.run().drained
    assert cc.misses == misses
    restored.audit()
    streams, status = snaplib.journaled_streams(wd)
    assert status == {i: "done" for i in want}
    assert streams == want
    if layout == "paged":
        assert restored.alloc.n_free == restored.pool_blocks
    rebound = {k: v.clone() for k, v in restored.cache.items()}
    with pytest.raises(ValueError, match="captured with"):
        ticks[("decode", 2)](params, rebound,
                             **restored._dead_inputs(None))


# -- the MoE family --------------------------------------------------------------

def _ulps(got, want):
    step = (torch.nextafter(want, torch.full_like(want, float("inf")))
            - want).abs()
    return float(((got - want).abs() / step).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,k,b,s,cap,q_lens", [
    (40, 8, 4, 1, 8, None), (40, 8, 4, 64, 64, None),
    (40, 8, 4, 64, 16, [64, 1, 40, 0]), (8, 2, 3, 33, 9, None),
    (64, 4, 2, 300, 20, [300, 17]), (8, 2, 1, 4096, 1280, None)])
def test_moe_route_kernel_matches_plain(cuda, dtype, e, k, b, s, cap,
                                        q_lens):
    """Indices, slots, counts, offsets and rows bitwise, weights within 2
    ulp of the plain version, with drops and dead positions; the launch
    counted once."""
    from repro_torch.kernels import moe_route as mr
    gen = torch.Generator(device="cuda").manual_seed(e * s)
    logits = _rand(gen, b * s, e, dtype=dtype)
    logits[:, 0] += 1.0                      # a favourite, so groups drop
    ql = (None if q_lens is None else
          torch.tensor(q_lens, dtype=torch.int32, device="cuda"))
    before = _build.launches["moe_route"]
    got = mr.moe_route_cuda(logits, s, k, cap, ql)
    assert _build.launches["moe_route"] == before + 1
    want = mr.moe_route_torch(logits, s, k, cap, ql)
    kept = int(got.counts.sum())
    for name in ("topi", "slot", "counts", "offsets"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(got.rows[:kept], want.rows[:kept])
    assert _ulps(got.topw, want.topw) <= 2
    live = b * s if q_lens is None else sum(q_lens)
    assert kept < live * k or cap >= s


def test_moe_route_ties_go_to_the_lower_index(cuda):
    from repro_torch.kernels import moe_route as mr
    logits = torch.zeros(6, 40, device="cuda")
    logits[:, [3, 7, 9]] = 1.0
    r = mr.moe_route_cuda(logits, 6, 8, 48)
    assert r.topi[:, :3].tolist() == [[3, 7, 9]] * 6
    assert r.topi[:, 3:].tolist() == [[0, 1, 2, 4, 5]] * 6
    assert torch.equal(r.topi, mr.moe_route_torch(logits, 6, 8, 48).topi)


def _bits(t):
    """A tensor's bits, so that NaNs compare equal where their bits are."""
    return t.contiguous().view({2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _same_route(got, want):
    for name in ("topw", "topi", "slot", "counts", "offsets"):
        assert torch.equal(_bits(getattr(got, name)),
                           _bits(getattr(want, name))), name
    kept = int(want.counts.sum())
    assert torch.equal(got.rows[:kept], want.rows[:kept])
    assert got.max_rows == want.max_rows


def _router_inputs(gen, b, s, d, e, dtype):
    """x (b*s, d) and a router (d, e) in dtype: expert 0 a favourite (so
    groups drop), the last two router columns equal (tied logits), and
    row 1 NaN where there are two rows."""
    router = _rand(gen, d, e) / d ** 0.5
    router[:, -1] = router[:, -2]
    r0 = router[:, 0]
    x = _rand(gen, b * s, d) + 1.5 * r0 / (r0 @ r0)
    if b * s > 1:
        x[1] = float("nan")
    return x.to(dtype), router.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,k,b,s,cap,q_lens,d", [
    (40, 8, 4, 1, 8, None, 1536), (40, 8, 4, 64, 64, None, 1536),
    (40, 8, 4, 64, 16, [64, 1, 40, 0], 1536), (8, 2, 3, 33, 9, None, 256),
    (64, 4, 2, 300, 20, [300, 17], 200), (8, 2, 1, 4096, 1280, None, 128),
    (8, 2, 4, 1, 2, None, 6144), (8, 2, 4, 64, 64, None, 6144),
    (12, 3, 2, 5, 3, [5, 2], 100)])
@pytest.mark.parametrize("ctas", [0, 1, 3, 16])
def test_moe_router_route_kernel_matches_the_chain(cuda, dtype, e, k, b, s,
                                                   cap, q_lens, d, ctas):
    """The route with the router's product inside it: logits bitwise
    ``ops.dense_matmul``'s, every ``Route`` field bitwise the route
    kernel's on those logits, at every CTA count of the cluster (the
    layout follows T freely), weights within 2 ulp of the plain version
    away from the NaN row; drops, dead positions, tied logits; one launch
    counted."""
    from repro_torch.kernels import moe_route as mr
    gen = torch.Generator(device="cuda").manual_seed(e * s + d)
    x, router = _router_inputs(gen, b, s, d, e, dtype)
    ql = (None if q_lens is None else
          torch.tensor(q_lens, dtype=torch.int32, device="cuda"))
    before = _build.launches["moe_route"]
    logits, got = mr.moe_router_route_cuda(x, router, s, k, cap, ql,
                                           ctas=ctas)
    assert _build.launches["moe_route"] == before + 1
    want_logits = ops.dense_matmul(x, router)
    assert torch.equal(_bits(logits), _bits(want_logits))
    _same_route(got, mr.moe_route_cuda(want_logits, s, k, cap, ql))
    _same_route(got, mr.moe_route_cuda(want_logits, s, k, cap, ql,
                                       ctas=max(1, ctas // 2)))
    plain = mr.moe_route_torch(want_logits, s, k, cap, ql)
    fine = torch.isfinite(logits).all(1)
    assert torch.equal(got.topi[fine], plain.topi[fine])
    assert _ulps(got.topw[fine], plain.topw[fine]) <= 2
    if b * s > 1:                        # the NaN row: the first k indices
        assert got.topi[1].tolist() == list(range(k))
    assert int(got.counts.sum()) <= (sum(q_lens) if q_lens else b * s) * k


@pytest.mark.parametrize("b,s", [(4, 1), (4, 64)])
def test_moe_router_route_graph_replays_a_new_route(cuda, b, s):
    """A CUDA graph of the fused route captured on one x and replayed after
    another x is copied in gives bitwise the eager launch's logits and
    ``Route`` on that x (other counts, offsets and rows)."""
    from repro_torch.kernels import moe_route as mr
    gen = torch.Generator(device="cuda").manual_seed(30 + s)
    x_a, router = _router_inputs(gen, b, s, _GRANITE_D, 40, torch.bfloat16)
    x_b = _rand(gen, b * s, _GRANITE_D, dtype=torch.bfloat16)
    want_logits, want = mr.moe_router_route_cuda(x_b, router, s, 8, s)
    xs = x_a.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mr.moe_router_route_cuda(xs, router, s, 8, s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits, got = mr.moe_router_route_cuda(xs, router, s, 8, s)
    xs.copy_(x_b)
    graph.replay()
    torch.cuda.synchronize()
    assert not torch.equal(want.counts, mr.moe_router_route_cuda(
        x_a, router, s, 8, s)[1].counts)
    assert torch.equal(logits, want_logits)
    _same_route(got, want)


@pytest.mark.parametrize("dtype,d,e,k", [
    (torch.float32, 1536, 40, 8), (torch.bfloat16, 1536, 40, 8),
    (torch.bfloat16, 6144, 8, 2)])
@pytest.mark.parametrize("b,s", [(4, 1), (4, 64)])
def test_combine_add_rmsnorm_kernel_is_the_chain(cuda, dtype, d, e, k, b, s):
    """``combine_add_rmsnorm`` bitwise ``moe_combine`` then
    ``add_rmsnorm`` (both kernels) and its plain version, the sum kept and
    not, through ``ops`` with ``(B, S, k)`` routes too, at granite's and
    mixtral's widths, with drops and a dead row; one launch a call."""
    from repro_torch.kernels import moe_route as mr
    from repro_torch.kernels import rmsnorm as rms
    gen = torch.Generator(device="cuda").manual_seed(d + s)
    t = b * s
    logits = _rand(gen, t, e)
    logits[:, 0] += 1.0
    ql = (None if s == 1 else
          torch.tensor([s, 1, 0, s // 2], dtype=torch.int32, device="cuda"))
    r = mr.moe_route_cuda(logits, s, k, max(k, s // 4), ql)
    assert s == 1 or bool((r.slot < 0).any())
    y = _rand(gen, t * k, d, dtype=dtype)
    x = _rand(gen, t, d, dtype=dtype)
    gamma = (_rand(gen, d) * 0.1 + 1.0).to(dtype)
    before = _build.launches["combine_add_rmsnorm"]
    got_s, got_n = rms.combine_add_rmsnorm_cuda(x, y, r.slot, r.topw, gamma)
    assert _build.launches["combine_add_rmsnorm"] == before + 1
    m = mr.moe_combine_cuda(y, r.slot, r.topw)
    want_s, want_n = rms.add_rmsnorm_cuda(x, m, gamma)
    assert torch.equal(got_s, want_s) and torch.equal(got_n, want_n)
    none_s, none_n = rms.combine_add_rmsnorm_cuda(x, y, r.slot, r.topw,
                                                  gamma, keep_sum=False)
    assert none_s is None and torch.equal(none_n, want_n)
    p_s, p_n = rms.combine_add_rmsnorm_torch(x, y, r.slot, r.topw, gamma)
    assert torch.equal(p_s, want_s) and torch.equal(p_n, want_n)
    o_s, o_n = ops.combine_add_rmsnorm(
        x.reshape(b, s, d), y, r.slot.reshape(b, s, k),
        r.topw.reshape(b, s, k), gamma)
    assert torch.equal(o_s.reshape(t, d), want_s)
    assert torch.equal(o_n.reshape(t, d), want_n)


def _experts(gen, e, d, f, group):
    gate, up = (quantize(_rand(gen, e, d, f) * 0.05, group_size=group)
                for _ in range(2))
    down = quantize(_rand(gen, e, f, d) * 0.05, group_size=group)
    return gate, up, down


@pytest.mark.parametrize("group", [32, 64, 128])
@pytest.mark.parametrize("b,s", [(4, 1), (4, 64), (2, 300)])
def test_moe_expert_kernels_match_plain(cuda, group, b, s):
    """The grouped gate/up and down kernels against their plain versions on
    every kept row (W4A16 tolerance), each tile configuration; a token's
    rows are bitwise the same routed alone."""
    from repro_torch.kernels import moe_experts as mx
    from repro_torch.kernels import moe_route as mr
    gen = torch.Generator(device="cuda").manual_seed(group + s)
    e, k, d, f = 8, 2, 512, 384
    gate, up, down = _experts(gen, e, d, f, group)
    x = _rand(gen, b * s, d, dtype=torch.bfloat16)
    logits = _rand(gen, b * s, e, dtype=torch.bfloat16)
    r = mr.moe_route_cuda(logits, s, k, s)
    kept = int(r.counts.sum())
    h = mx.moe_gate_up_cuda(x, r, gate, up, "swiglu")
    _close(h[:kept], mx.moe_gate_up_torch(x, r, gate, up, "swiglu")[:kept],
           torch.bfloat16)
    y = mx.moe_down_cuda(h, r, down)
    _close(y[:kept], mx.moe_down_torch(h, r, down)[:kept], torch.bfloat16)
    one = mr.moe_route_cuda(logits[:1], 1, k, k)
    y1 = mx.moe_ffn_cuda(x[:1], one, gate, up, down)
    for j in range(k):
        assert torch.equal(y1[int(one.slot[0, j])], y[int(r.slot[0, j])])


def test_moe_expert_kernels_skip_empty_experts_and_refuse(cuda):
    """An expert with no rows writes nothing; 16-bit experts, float32
    activations and a group the tile does not take raise."""
    from repro_torch.kernels import moe_experts as mx
    from repro_torch.kernels import moe_route as mr
    gen = torch.Generator(device="cuda").manual_seed(5)
    gate, up, down = _experts(gen, 4, 256, 128, 32)
    logits = torch.zeros(4, 4, device="cuda", dtype=torch.bfloat16)
    logits[:, 2] = 5.0
    logits[:, 1] = 4.0
    r = mr.moe_route_cuda(logits, 1, 2, 2)
    assert r.counts.tolist() == [0, 4, 4, 0]
    x = _rand(gen, 4, 256, dtype=torch.bfloat16)
    y = mx.moe_ffn_cuda(x, r, gate, up, down)
    want = mx.moe_ffn_torch(x, r, gate, up, down)
    _close(y, want, torch.bfloat16)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        mx.moe_ffn_cuda(x.float(), r, gate, up, down)
    with pytest.raises(NotImplementedError, match="W4A16 experts"):
        mx.moe_ffn_cuda(x, r, gate, up,
                        _rand(gen, 4, 128, 256, dtype=torch.bfloat16))


def _skewed_route(experts, b=4, s=64, e=40):
    """A route of b x s tokens whose top-len(experts) all land on
    ``experts`` (dropless), every other expert empty."""
    from repro_torch.kernels import moe_route as mr
    k = len(experts)
    logits = torch.zeros(b * s, e, device="cuda", dtype=torch.bfloat16)
    for j, ex in enumerate(experts):
        logits[:, ex] = 8.0 - j
    return mr.moe_route_cuda(logits, s, k, s)


# granite-moe-3b-a800m's expert widths
_GRANITE_D, _GRANITE_F = 1536, 512


@pytest.mark.parametrize("group", [32, 128])
@pytest.mark.parametrize("experts", [(0,), (39,), (0, 5, 17, 39)])
def test_moe_expert_kernels_take_skewed_routes(cuda, group, experts):
    """All 256 rows of a 4 x 64 chunk on one expert (first or last), or on
    four, every other expert empty: more work items than resident blocks
    (decode tiles) and long runs of experts with nothing.  The launcher's
    choice against the plain versions; every tile configuration bitwise
    the same rows."""
    from repro_torch.kernels import moe_experts as mx
    gen = torch.Generator(device="cuda").manual_seed(group + experts[-1])
    gate, up, down = _experts(gen, 40, _GRANITE_D, _GRANITE_F, group)
    r = _skewed_route(experts)
    kept = int(r.counts.sum())
    assert kept == 256 * len(experts)
    assert int((r.counts > 0).sum()) == len(experts)
    x = _rand(gen, 256, _GRANITE_D, dtype=torch.bfloat16)
    h_want = mx.moe_gate_up_torch(x, r, gate, up, "swiglu")
    h0 = mx.moe_gate_up_cuda(x, r, gate, up, "swiglu")
    y0 = mx.moe_down_cuda(h0, r, down)
    _close(h0[:kept], h_want[:kept], torch.bfloat16)
    _close(y0[:kept], mx.moe_down_torch(h0, r, down)[:kept], torch.bfloat16)
    for tile in mx.GATE_UP_TILES:
        h = mx.moe_gate_up_cuda(x, r, gate, up, "swiglu", tile=tile)
        assert torch.equal(h[:kept], h0[:kept]), tile
    for tile in mx.DOWN_TILES:
        y = mx.moe_down_cuda(h0, r, down, tile=tile)
        assert torch.equal(y[:kept], y0[:kept]), tile


@pytest.mark.parametrize("group", [32, 64, 128])
@pytest.mark.parametrize("b,s", [(4, 1), (4, 64)])
def test_moe_expert_rows_do_not_depend_on_grid_or_tile(cuda, group, b, s):
    """A row's bits do not depend on the persistent grid's size (one block,
    seven, the full grid) or on the tile configuration (decode, mid)."""
    from repro_torch.kernels import moe_experts as mx
    from repro_torch.kernels import moe_route as mr
    gen = torch.Generator(device="cuda").manual_seed(7 * group + s)
    gate, up, down = _experts(gen, 40, _GRANITE_D, _GRANITE_F, group)
    x = _rand(gen, b * s, _GRANITE_D, dtype=torch.bfloat16)
    r = mr.moe_route_cuda(_rand(gen, b * s, 40, dtype=torch.bfloat16), s, 8,
                          s)
    kept = int(r.counts.sum())
    h0 = mx.moe_gate_up_cuda(x, r, gate, up, "swiglu")
    y0 = mx.moe_down_cuda(h0, r, down)
    runs = [dict(blocks=n) for n in (1, 7)]
    for kw in runs + [dict(tile=t) for t in mx.GATE_UP_TILES]:
        h = mx.moe_gate_up_cuda(x, r, gate, up, "swiglu", **kw)
        assert torch.equal(h[:kept], h0[:kept]), kw
    for kw in runs + [dict(tile=t) for t in mx.DOWN_TILES]:
        assert torch.equal(mx.moe_down_cuda(h0, r, down, **kw)[:kept],
                           y0[:kept]), kw


@pytest.mark.parametrize("b,s", [(4, 1), (4, 64)])
def test_moe_expert_graph_replays_a_new_route(cuda, b, s):
    """A CUDA graph of the two grouped kernels, captured on one route and
    replayed after another route (other counts, offsets and rows) is
    copied into its tensors, equals the eager call on that route."""
    from repro_torch.kernels import moe_experts as mx
    from repro_torch.kernels import moe_route as mr
    gen = torch.Generator(device="cuda").manual_seed(11 + s)
    gate, up, down = _experts(gen, 40, _GRANITE_D, _GRANITE_F, 32)
    x_a, x_b = (_rand(gen, b * s, _GRANITE_D, dtype=torch.bfloat16)
                for _ in range(2))
    r_a, r_b = (mr.moe_route_cuda(_rand(gen, b * s, 40,
                                        dtype=torch.bfloat16), s, 8, s)
                for _ in range(2))
    assert not torch.equal(r_a.counts, r_b.counts)
    want = mx.moe_ffn_cuda(x_b, r_b, gate, up, down)
    xs = x_a.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mx.moe_ffn_cuda(xs, r_a, gate, up, down)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = mx.moe_ffn_cuda(xs, r_a, gate, up, down)
    graph.replay()
    kept_a = int(r_a.counts.sum())
    assert torch.equal(y[:kept_a],
                       mx.moe_ffn_cuda(x_a, r_a, gate, up, down)[:kept_a])
    for name in ("counts", "offsets", "rows"):
        getattr(r_a, name).copy_(getattr(r_b, name))
    xs.copy_(x_b)
    graph.replay()
    torch.cuda.synchronize()
    kept = int(r_b.counts.sum())
    assert torch.equal(y[:kept], want[:kept])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_combine_kernel_matches_plain_bitwise(cuda, dtype):
    from repro_torch.kernels import moe_route as mr
    gen = torch.Generator(device="cuda").manual_seed(9)
    t, k, d = 37, 8, 1536
    r = mr.moe_route_cuda(_rand(gen, t, 40), t, k, 6)
    y = _rand(gen, t * k, d, dtype=dtype)
    assert bool((r.slot < 0).any())
    got = mr.moe_combine_cuda(y, r.slot, r.topw)
    assert torch.equal(got, mr.moe_combine_torch(y, r.slot, r.topw))


@pytest.mark.parametrize("group", [32, 64])
@pytest.mark.parametrize("tokens", [1, 4, 37, 300])
def test_kernels_1_and_2_take_expert_groups(cuda, group, tokens):
    """Kernel 1 and kernel 2's gate/up stage at 32- and 64-row groups
    (bf16) against their plain versions, rows alone bitwise; float32 and
    the bias epilogue refuse such groups."""
    from repro_torch.kernels.ffn_fused import (
        ffn_gate_up_cuda, ffn_gate_up_torch)
    from repro_torch.kernels.w4a16_matmul import (
        w4a16_matmul_cuda, w4a16_matmul_torch)
    gen = torch.Generator(device="cuda").manual_seed(group + tokens)
    w = quantize(_rand(gen, 512, 1536) * 0.05, group_size=group)
    g, u = (quantize(_rand(gen, 1536, 512) * 0.05, group_size=group)
            for _ in range(2))
    x = _rand(gen, tokens, 512, dtype=torch.bfloat16)
    got = w4a16_matmul_cuda(x, w)
    _close(got, w4a16_matmul_torch(x, w), torch.bfloat16)
    assert torch.equal(w4a16_matmul_cuda(x[-1:], w), got[-1:])
    x2 = _rand(gen, tokens, 1536, dtype=torch.bfloat16)
    h = ffn_gate_up_cuda(x2, g, u, "swiglu")
    _close(h, ffn_gate_up_torch(x2, g, u, "swiglu"), torch.bfloat16)
    assert torch.equal(ffn_gate_up_cuda(x2[:1], g, u, "swiglu"), h[:1])
    with pytest.raises(ValueError, match="row groups"):
        w4a16_matmul_cuda(x.float(), w)
    with pytest.raises(ValueError, match="row groups"):
        w4a16_matmul_cuda(x, w, torch.zeros(1536, device="cuda"))


@pytest.mark.parametrize("tokens", [1, 4, 64, 300])
def test_tied_head_reads_the_embedding_in_place(cuda, tokens):
    """``dense_matmul(x, embed.T)`` at granite-moe-3b-a800m's 49155 columns
    against the plain version, with no copy of the weight; at a width the
    copied weight takes, bitwise the copied weight's result."""
    gen = torch.Generator(device="cuda").manual_seed(tokens)
    emb = _rand(gen, 49155, 1536, dtype=torch.bfloat16) * 0.02
    x = _rand(gen, tokens, 1536, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    got = ops.dense_matmul(x, emb.T)
    assert torch.cuda.memory_allocated() - before <= got.numel() * 2 + (1 << 20)
    _close(got, ops.dense_matmul(x, emb.T, impl="torch"), torch.bfloat16)
    assert torch.equal(ops.dense_matmul(x[-1:], emb.T), got[-1:])
    w = emb[:49152]
    assert torch.equal(ops.dense_matmul(x, w.T),
                       ops.dense_matmul(x, w.T.contiguous()))


def test_moe_mixed_step_equals_sequential_decode_on_card(cuda):
    """The MoE graph case at the dropless factor: a 13-token prompt in
    8-token chunks gives bitwise the logits and cache of 13 decode steps,
    through the route with the router's product, the grouped experts, the
    combine inside the next norm and the tied head (the decode steps'
    launches counted: no router ``dense_matmul``, no ``moe_combine``)."""
    from repro_torch.models import api
    cfg, params, _ = _graph_engine("moe")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 13)
    seq = api.init_cache(cfg, 1, 32, "cuda")
    _build.launches.clear()
    for t, tok in enumerate(prompt.tolist()):
        want, seq = api.decode_step(cfg, params, seq,
                                    torch.tensor([[tok]], device="cuda"),
                                    [t + 1])
    for name in ("moe_route", "moe_gate_up_w4a16", "moe_down_w4a16",
                 "combine_add_rmsnorm", "add_rmsnorm"):
        assert _build.launches[name] == 13 * cfg.n_layers, name
    assert _build.launches["moe_combine"] == 0
    assert _build.launches["dense_matmul"] == 13      # the tied head
    mix = api.init_cache(cfg, 1, 32, "cuda")
    for o in (0, 8):
        ql = min(8, 13 - o)
        chunk = np.zeros(8, np.int64)
        chunk[:ql] = prompt[o:o + ql]
        got, mix = api.mixed_step(cfg, params, mix,
                                  torch.tensor(chunk[None], device="cuda"),
                                  [o], [ql])
    assert torch.equal(got, want)
    for a, b in zip(_cache_leaves(seq), _cache_leaves(mix)):
        assert torch.equal(a, b)
