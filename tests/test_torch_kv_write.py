"""``ops.kv_write``, the KV-cache write of the port's serving steps.

* Its plain version is bitwise the index writes the attention module used
  before (a copy of that code is kept here as the oracle), and on every
  position the reference writes for real it equals the JAX writers
  (``repro/models/attention.py`` ``_chunk_write``, ``_paged_chunk_write``,
  ``_paged_token_write``): slot and paged, fp and int8, ragged ``q_lens``
  with zeros, a rolling window and scrambled page tables.
* A dispatch in which every row is dead (the warm-up before a CUDA graph
  capture) leaves every cache and state leaf bitwise unchanged.
* On a CUDA tensor the op reaches the kernel's wrapper.
* A mixed step and a decode step perform no data-dependent operation
  outside the kernel ops (no ``nonzero``, no boolean-mask indexing, no read
  of a device value on the host), so the card can capture them; the check
  is shown to catch the former writers' ``nonzero``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import kv_write as kvw  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api, layers  # noqa: E402
from repro_torch.serving.engine import Engine, _unpack_tick  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the former writers (attention.py before ops.kv_write), the oracle -------

def old_chunk_write(cache_leaf, new, starts, q_lens):
    c = new.shape[2]
    j = torch.arange(c, device=new.device)
    rows, cols = (j[None, :] < q_lens[:, None]).nonzero(as_tuple=True)
    cache_leaf[rows, :, starts.long()[rows] + cols] = \
        new[rows, :, cols].to(cache_leaf.dtype)


def old_paged_chunk_write(pool, new, page_table, starts, q_lens):
    c = new.shape[2]
    bs = pool.shape[2]
    j = torch.arange(c, device=new.device)
    rows, cols = (j[None, :] < q_lens[:, None]).nonzero(as_tuple=True)
    pos = starts.long()[rows] + cols
    blk = page_table.long()[rows, pos // bs]
    pool[blk, :, pos % bs] = new[rows, :, cols].to(pool.dtype)


def old_paged_token_write(pool, new, page_table, pos, mask):
    rows = torch.arange(new.shape[0], device=new.device)
    if mask is not None:
        rows = rows[mask]
    pos = pos.long()[rows]
    bs = pool.shape[2]
    blk = page_table.long()[rows, pos // bs]
    pool[blk, :, pos % bs] = new[rows].to(pool.dtype)


def old_slot_token_write(leaf, new, write_idx, write_mask):
    rows = torch.arange(new.shape[0], device=new.device)
    if write_mask is not None:
        rows = rows[write_mask]
    idx = write_idx.long()[rows]
    leaf[rows, :, idx] = new[rows, :, 0].to(leaf.dtype)


# -- cases --------------------------------------------------------------------

B, HKV, HD, C = 4, 2, 8, 6
SPAN, BS, N_PAGES = 24, 4, 6        # slot length; page size and pages a row


def _bits(t):
    return t.contiguous().view(torch.uint8)


def _equal(a, b):
    return torch.equal(_bits(a), _bits(b))


def _leaves(rng, lead, quant, dtype):
    """Random K/V leaves (so a stray write shows) with token axes
    ``lead``."""
    def rand(shape, dt):
        if dt == torch.int8:
            return torch.from_numpy(rng.integers(-127, 128, shape,
                                                 dtype=np.int8))
        return torch.from_numpy(rng.standard_normal(shape,
                                                    dtype=np.float32)).to(dt)
    if quant:
        return {"k": rand((*lead, HD), torch.int8),
                "v": rand((*lead, HD), torch.int8),
                "k_scale": rand((*lead, 1), torch.float32),
                "v_scale": rand((*lead, 1), torch.float32)}
    return {"k": rand((*lead, HD), dtype), "v": rand((*lead, HD), dtype)}


def _new_rows(rng, c, quant, dtype):
    """This step's rows, k and v as the model makes them: k contiguous
    (b, hkv, c, hd), v a transposed view of (b, c, hkv, hd)."""
    rows = _leaves(rng, (B, c, HKV), quant, dtype)
    return {n: (t.transpose(1, 2) if n.startswith("v")
                else t.transpose(1, 2).contiguous()) for n, t in rows.items()}


def _scrambled_table(rng):
    """Each row's pages are distinct pool blocks in a random order; the
    pool has spare blocks and the null block last."""
    n_blocks = B * N_PAGES + 5
    perm = rng.permutation(n_blocks)[:B * N_PAGES]
    return (torch.from_numpy(perm.reshape(B, N_PAGES).astype(np.int32)),
            n_blocks + 1)


def _chunk_case(seed):
    rng = np.random.default_rng(seed)
    q_lens = rng.integers(0, C + 1, B).astype(np.int32)
    q_lens[seed % B] = 0                          # a dead row in every case
    starts = np.array([rng.integers(0, SPAN - q + 1) for q in q_lens],
                      np.int32)
    return rng, torch.from_numpy(starts), torch.from_numpy(q_lens)


def _decode_case(seed, rolling):
    """Lengths including the new token (up to twice the span when the
    window rolls), the write index the attention step computes, and a
    write mask with a False row."""
    rng = np.random.default_rng(100 + seed)
    hi = 2 * SPAN if rolling else SPAN
    lengths = torch.from_numpy(rng.integers(1, hi + 1, B).astype(np.int32))
    write_idx = ((lengths - 1) % SPAN if rolling
                 else torch.clamp(lengths - 1, 0, SPAN - 1))
    mask = torch.from_numpy(rng.random(B) < 0.6)
    mask[seed % B] = False
    return rng, write_idx, mask


DTYPES = {"f32": (False, torch.float32), "bf16": (False, torch.bfloat16),
          "int8": (True, torch.bfloat16)}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", sorted(DTYPES))
@pytest.mark.parametrize("paged", [False, True])
def test_plain_chunk_write_is_the_former_index_writes(paged, kind, seed):
    quant, dtype = DTYPES[kind]
    rng, starts, q_lens = _chunk_case(seed)
    table = None
    if paged:
        table, pool = _scrambled_table(rng)
        cache = _leaves(rng, (pool, HKV, BS), quant, dtype)
    else:
        cache = _leaves(rng, (B, HKV, SPAN), quant, dtype)
    new = _new_rows(rng, C, quant, dtype)
    want = {n: t.clone() for n, t in cache.items()}
    null = {n: t[-1].clone() for n, t in cache.items()}
    for n, t in new.items():
        if paged:
            old_paged_chunk_write(want[n], t, table, starts, q_lens)
        else:
            old_chunk_write(want[n], t, starts, q_lens)
    ops.kv_write(cache, new, starts, q_lens, page_table=table)
    for n in cache:
        assert _equal(cache[n], want[n]), n
    if paged:                                     # the null block: untouched
        assert all(_equal(cache[n][-1], null[n]) for n in cache)


@pytest.mark.parametrize("rolling", [False, True])
@pytest.mark.parametrize("kind", sorted(DTYPES))
@pytest.mark.parametrize("paged", [False, True])
def test_plain_decode_write_is_the_former_token_writes(paged, kind, rolling):
    """A decode write is the C == 1 case: ``q_lens`` the write mask as 0/1,
    ``starts`` the write index (the rolling window's modulo included); no
    mask writes every row."""
    quant, dtype = DTYPES[kind]
    for seed in range(3):
        rng, write_idx, mask = _decode_case(seed, rolling)
        table = None
        if paged:
            table, pool = _scrambled_table(rng)
            cache = _leaves(rng, (pool, HKV, BS), quant, dtype)
        else:
            cache = _leaves(rng, (B, HKV, SPAN), quant, dtype)
        new = _new_rows(rng, 1, quant, dtype)
        for m in (mask, None):
            want = {n: t.clone() for n, t in cache.items()}
            got = {n: t.clone() for n, t in cache.items()}
            for n, t in new.items():
                if paged:
                    old_paged_token_write(want[n], t[:, :, 0], table,
                                          write_idx, m)
                else:
                    old_slot_token_write(want[n], t, write_idx, m)
            live = (torch.ones(B, dtype=torch.int32) if m is None
                    else m.to(torch.int32))
            ops.kv_write(got, new, write_idx, live, page_table=table)
            for n in cache:
                assert _equal(got[n], want[n]), (n, seed, m is None)


def _j(t):
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_chunk_write_matches_jax_writers(seed, quant):
    """Slot: equal to the reference's read-modify-write everywhere.  Paged:
    the reference routes dead positions to the null block, which the port
    never writes; every other block is equal."""
    dtype = torch.float32
    rng, starts, q_lens = _chunk_case(seed)
    new = _new_rows(rng, C, quant, dtype)
    slot = _leaves(rng, (B, HKV, SPAN), quant, dtype)
    table, pool_blocks = _scrambled_table(rng)
    pool = _leaves(rng, (pool_blocks, HKV, BS), quant, dtype)
    want_slot = {n: np.asarray(jattn._chunk_write(
        _j(t), _j(new[n].contiguous()), _j(starts), _j(q_lens)))
        for n, t in slot.items()}
    want_pool = {n: np.asarray(jattn._paged_chunk_write(
        _j(t), _j(new[n].contiguous()), _j(table), _j(starts), _j(q_lens)))
        for n, t in pool.items()}
    ops.kv_write(slot, new, starts, q_lens)
    ops.kv_write(pool, new, starts, q_lens, page_table=table)
    for n in slot:
        np.testing.assert_array_equal(slot[n].numpy(), want_slot[n])
        np.testing.assert_array_equal(pool[n][:-1].numpy(),
                                      want_pool[n][:-1])


@pytest.mark.parametrize("rolling", [False, True])
def test_token_write_matches_jax_paged_token_write(rolling):
    dtype = torch.float32
    for seed in range(3):
        rng, write_idx, mask = _decode_case(seed, rolling)
        table, pool_blocks = _scrambled_table(rng)
        pool = _leaves(rng, (pool_blocks, HKV, BS), False, dtype)
        new = _new_rows(rng, 1, False, dtype)
        want = {n: np.asarray(jattn._paged_token_write(
            _j(t), _j(new[n][:, :, 0].contiguous()), _j(table),
            _j(write_idx), _j(mask))) for n, t in pool.items()}
        ops.kv_write(pool, new, write_idx, mask.to(torch.int32),
                     page_table=table)
        for n in pool:
            np.testing.assert_array_equal(pool[n][:-1].numpy(),
                                          want[n][:-1])


def test_card_dispatch_reaches_the_kernel_wrapper(monkeypatch):
    """With ``_resolve`` answering "cuda", ``ops.kv_write`` hands every
    leaf to the kernel's wrapper in one call."""
    calls = []

    def stub(cache, new, starts, q_lens, page_table):
        calls.append(sorted(new))
        kvw.kv_write_torch(cache, new, starts, q_lens, page_table)
    monkeypatch.setattr(ops, "_resolve",
                        lambda impl, x: "cuda" if impl == "auto" else impl)
    monkeypatch.setattr(ops, "kv_write_cuda", stub)
    rng, starts, q_lens = _chunk_case(0)
    cache = _leaves(rng, (B, HKV, SPAN), True, torch.float32)
    ops.kv_write(cache, _new_rows(rng, C, True, torch.float32), starts,
                 q_lens)
    assert calls == [["k", "k_scale", "v", "v_scale"]]
    with pytest.raises(ValueError, match="CUDA tensors"):
        kvw.kv_write_cuda(cache, _new_rows(rng, C, True, torch.float32),
                          starts, q_lens)


# -- steps and engines --------------------------------------------------------

TINY = dict(d_model=64, d_ff=128, vocab_size=256, n_layers=2)
FAMILIES = {
    "slot": ("qwen-7b", TINY),
    "slot-int8": ("qwen-7b", dict(TINY, kv_quant="int8")),
    "paged": ("qwen-7b", dict(TINY, kv_layout="paged", kv_block_size=8)),
    "paged-int8": ("qwen-7b", dict(TINY, kv_layout="paged", kv_block_size=8,
                                   kv_quant="int8")),
    "xlstm": ("xlstm-1.3b", {}),
}


def _model(name):
    arch, over = FAMILIES[name]
    cfg = get_smoke_config(arch, **over)
    return cfg, api.init_params(cfg, torch.Generator().manual_seed(0))


def _randomize(cache, seed):
    gen = torch.Generator().manual_seed(seed)
    for leaf in _tree_leaves(cache):
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen,
                                     dtype=torch.int8))
        else:
            leaf.copy_(torch.randn(leaf.shape, generator=gen))


def _tree_leaves(tree):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _tree_leaves(tree[k])
        else:
            yield tree[k]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_dead_dispatch_writes_no_leaf(name):
    """The warm-up a capture runs first: a mixed tick with every
    ``q_lens == 0`` and a decode tick with an all-False ``write_mask``
    leave every cache or state leaf bitwise as they were."""
    cfg, params = _model(name)
    engine = Engine(cfg, params, batch_size=3, max_len=32, chunk_size=16,
                    device="cpu")
    _randomize(engine.cache, 1)
    before = [t.clone() for t in _tree_leaves(engine.cache)]
    for width in (16, None):
        fn = engine._executable("mixed" if width else "decode", width)
        out, logits = fn(params, engine.cache, **engine._dead_inputs(width))
        tok, finite = _unpack_tick(out.numpy(), 3, logits.dtype)
        assert tok.shape == (3,) and finite.shape == (3,)
        assert logits.shape == (3, cfg.vocab_size)
        for got, want in zip(_tree_leaves(engine.cache), before):
            assert _equal(got, want), width


class DataDependence(TorchDispatchMode):
    """Records every operation whose output shape or host-side result
    depends on tensor values, outside the kernel ops: there the card runs a
    hand kernel (its wrapper launches, it reads nothing back), here the
    plain version."""

    SHAPE = {"nonzero", "masked_select", "unique_consecutive", "_unique2",
             "unique_dim", "argwhere", "masked_scatter", "nonzero_numpy"}
    HOST = {"_local_scalar_dense", "equal", "is_nonzero"}
    INDEX = {"index", "index_put", "index_put_", "_index_put_impl_"}

    def __init__(self):
        super().__init__()
        self.found: list[str] = []
        self.depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if not self.depth:
            masks = [i for i in (args[1] if name in self.INDEX else ())
                     if isinstance(i, torch.Tensor)
                     and i.dtype in (torch.bool, torch.uint8)]
            if name in self.SHAPE or name in self.HOST or masks:
                self.found.append(name)
        return func(*args, **kwargs)

    def op_boundary(self, fn):
        def inside(*a, **kw):
            self.depth += 1
            try:
                return fn(*a, **kw)
            finally:
                self.depth -= 1
        return inside


KERNEL_OPS = ("w4a16_matmul", "sparse_w4a16_matmul", "dense_matmul",
              "layernorm", "ffn_w4a16", "mixed_attention",
              "decode_attention", "kv_write", "slstm_scan", "mlstm_cell")


def _steps(cfg, params, check):
    """One mixed step (ragged q_lens with a dead row) and one decode step
    (a masked row) from a cache with history, under ``check``."""
    b, c = 3, 8
    cache = api.init_cache(cfg, b, 32, "cpu")
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (b, c), generator=gen)
    lengths = torch.tensor([3, 0, 9], dtype=torch.int32)
    q_lens = torch.tensor([5, 0, 8], dtype=torch.int32)
    table = None
    if api.has_paged_kv(cfg):
        pages = cache["k"].shape[1] - 1
        table = torch.randperm(pages, generator=gen)[:b * 4].reshape(b, 4)
        table = table.to(torch.int32)
    kw = {} if table is None else {"page_table": table}
    with check:
        api.mixed_step(cfg, params, cache, tokens, lengths, q_lens, **kw)
        api.decode_step(cfg, params, cache, tokens[:, :1],
                        lengths + q_lens + 1, write_mask=q_lens > 0, **kw)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_steps_make_no_data_dependent_op(name, monkeypatch):
    cfg, params = _model(name)
    check = DataDependence()
    for op in KERNEL_OPS:
        monkeypatch.setattr(ops, op, check.op_boundary(getattr(ops, op)))
    monkeypatch.setattr(layers, "_rmsnorm", check.op_boundary(
        layers._rmsnorm))
    _steps(cfg, params, check)
    assert check.found == [], check.found


@pytest.mark.parametrize("name", ["slot", "paged"])
def test_data_dependence_check_catches_the_former_writers(name,
                                                          monkeypatch):
    """The same check over the former index writes, called from the model
    code as they were, finds their ``nonzero``."""
    cfg, params = _model(name)
    check = DataDependence()

    def former(cache, new, starts, q_lens, *, page_table=None):
        for n, t in new.items():
            if page_table is None:
                old_chunk_write(cache[n], t, starts, q_lens)
            else:
                old_paged_chunk_write(cache[n], t, page_table, starts,
                                      q_lens)
    for op in KERNEL_OPS:
        monkeypatch.setattr(ops, op, check.op_boundary(getattr(ops, op)))
    monkeypatch.setattr(layers, "_rmsnorm", check.op_boundary(
        layers._rmsnorm))
    monkeypatch.setattr(ops, "kv_write", former)
    _steps(cfg, params, check)
    assert "nonzero" in check.found
