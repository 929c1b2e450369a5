"""Card-only tests of the port's CUDA kernels (marker ``gpu``).

Each hand kernel is held against its plain PyTorch version on the card, and
the batch-invariance properties the engine's oracle parity rests on are
checked bitwise.  This file imports nothing of JAX, so it runs on the
machine with the card:

    python -m pytest -m gpu tests/test_torch_gpu.py

On a machine without a card every test skips (decided inside the
``cuda`` fixture, never at import time)."""

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
    norm = "layernorm" if cfg.norm == "layernorm" else "rmsnorm"
    ffn = {"none": "ffn_fused_dense", "dense": (
        "ffn_fused_w4a16_gelu" if cfg.activation == "gelu"
        else "ffn_fused_w4a16"), "strategy2": "ffn_fused_sparse_gelu"}[
            strategy]
    matmul = "dense_matmul" if strategy == "none" else "w4a16_matmul"
    sparse = 2 * L if strategy == "strategy2" else 0     # wo and down
    assert _build.launches["mixed_flash_attention"] == ticks * L
    assert _build.launches[norm] == ticks * (2 * L + 1)
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
        assert torch.equal(tok_e, tok_g)
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
            assert counts[-1]["kv_write"] == ticks * cfg.n_layers
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
