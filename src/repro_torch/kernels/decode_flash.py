"""Mixed prefill/decode flash attention: CUDA kernel wrapper and its plain
version, for the slot and paged KV layouts with a float or an int8 cache.

Port of ``repro/kernels/decode_flash.py::mixed_flash_attention_pallas``
(``decode_flash_attention_pallas`` is its ``q_lens = 1`` case) and of the
blocked twins in ``repro/kernels/xla_attention.py``.  The kernel is
``csrc/decode_flash.cu``: in bfloat16 a tensor-core kernel over the
splits and a second kernel that folds them, in float32 a CUDA-core
kernel; its four variants (slot or paged, fp or int8 K/V) are
instantiations of one template each.

Contract: q (B, hq, C, d); ``lengths`` (B,) = valid context including this
step's chunk; ``q_lens`` (B,) = live queries (query j of row b sits at
``lengths[b] - q_lens[b] + j``).  Intra-chunk causal, optional window, dead
queries return exact zeros.

* Slot layout: caches (B, hkv, MAX, d); the KV tile is
  ``kv_block_size(MAX, block_kv)``, fixed by the cache length alone.
* Paged layout: caches are shared pools (P, hkv, bs, d) and ``page_table``
  (B, n_pages) int32 maps logical tile ``ik`` of row ``b`` to pool block
  ``page_table[b, ik]``.  The KV tile IS the page size ``bs`` (8 to 128 on
  the card), and only tiles inside a row's live range are addressed, so
  unleased blocks and the null block are never read.  With
  ``block_kv = bs`` the slot walk reduces in the same order: paged ≡ slot
  bit for bit.
* The reduction order: the key axis is cut into splits of
  ``split_span(bk)`` keys from key 0 (a function of the tile alone), each
  an online softmax over ``KV_STEP_KEYS``-key steps, and a query folds the
  splits it sees in increasing order.  Nothing in it depends on B, C, the
  other rows or the grid, so a query inside a chunk gives the bits of the
  same query decoded alone.
* int8 K/V: int8 caches plus f32 per-token scales ``k_scale``/``v_scale``
  shaped like the cache with a last axis of 1.  Each int8 value converts
  exactly; the K scale multiplies the finished score (then ``scale`` does),
  ``l`` sums the probabilities before the V scale, and ``p * v_scale`` is
  rounded to the activation dtype before P·V (scale-after-dot).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.w4a16_matmul import DTYPE_CODES, check_activation

NAME = "mixed_flash_attention"
# launch-count name of each variant, by (paged, int8 K/V)
VARIANTS = {(False, False): NAME, (False, True): NAME + "_int8",
            (True, False): NAME + "_paged", (True, True): NAME + "_paged_int8"}
DEFAULT_BLOCK_KV = 128
# the head dims the kernels are instantiated at: bfloat16 (the tensor-core
# kernel) takes 112 (zamba2-7b's: its rows staged 128 wide, csrc/mma.cuh's
# staged_dim) and 256 too; float32's CUDA-core kernel gives each lane D / 32
# output dims (so not 112) and would stage 266 KB of K/V tiles at 256, past
# the 227 KB a block can hold.
HEAD_DIMS = {torch.bfloat16: (32, 64, 112, 128, 256),
             torch.float32: (32, 64, 128)}
PAGE_SIZES = range(8, 129)       # the reference's kernel wants >= 8; the tile
#                                  holds at most 128 keys
# A split of the key axis: the most whole KV tiles within this many keys (at
# least one tile), so its span is a function of the tile alone.  Each split
# walks its keys in online-softmax steps of KV_STEP_KEYS from its first key,
# and the splits' states are folded in increasing order.  The bf16 kernel
# (csrc/decode_flash.cu) stages a whole split in shared memory and takes the
# span from here.
KV_SPLIT_KEYS = 128
KV_STEP_KEYS = 64
# Scratch for the bf16 kernel's per-split states: a chunk whose states
# would take more is done in slices of its queries (no row's bits move).
SPLIT_SCRATCH_BYTES = 1 << 27
LOG2E = 1.4426950408889634
_NEG_INF = -1e30
_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def kv_block_size(max_len: int, block_kv: int = DEFAULT_BLOCK_KV) -> int:
    """Largest divisor of ``max_len`` that is <= ``block_kv``."""
    bk = min(block_kv, max_len)
    while max_len % bk:
        bk -= 1
    return bk


def split_span(bk: int) -> int:
    """Keys of one split for KV tile ``bk``: the most whole tiles within
    ``KV_SPLIT_KEYS``, at least one (64 < span <= 128 for bk in 8..128)."""
    return bk * max(1, KV_SPLIT_KEYS // bk)


def _rows(v, b: int, device) -> torch.Tensor:
    return torch.as_tensor(v, device=device).reshape(-1).expand(b)


def _keys(leaf, pos, bs: int, page_table) -> torch.Tensor:
    """Keys at logical positions ``pos`` (n,) of every row, (B, hkv, n, ...):
    slot cache rows, or pool block ``page_table[b, pos // bs]`` at offset
    ``pos % bs``."""
    if page_table is None:
        return leaf[:, :, pos]
    blocks = page_table[:, pos // bs].long()                       # (B, n)
    return leaf[blocks, :, pos % bs].transpose(1, 2)


def fold_split(state, split, visible):
    """Fold one split's (m, l, acc) into the running state where
    ``visible`` (the split holds a key the query sees), in the kernel's
    order; elsewhere the state is kept.  A split with no visible key has
    m = -1e30, l = 0, acc = 0, and folding it would keep the state too
    (alpha = 1, contribution 0)."""
    (m, l, acc), (ms, ls, accs) = state, split
    m_new = torch.maximum(m, ms)
    a, c = torch.exp2(m - m_new), torch.exp2(ms - m_new)
    l_new = l * a + ls * c
    acc_new = acc * a[..., None] + accs * c[..., None]
    return (torch.where(visible, m_new, m), torch.where(visible, l_new, l),
            torch.where(visible[..., None], acc_new, acc))


def mixed_attention_torch(q, k_cache, v_cache, lengths, q_lens, *,
                          window=None, scale=None, k_scale=None,
                          v_scale=None, page_table=None,
                          block_kv: int = DEFAULT_BLOCK_KV) -> torch.Tensor:
    """Plain version: the bf16 kernel's arithmetic, vectorised over rows.
    The key axis is cut into splits of ``split_span(bk)`` keys from key 0;
    each split runs an online softmax (log2 domain) over steps of
    ``KV_STEP_KEYS`` keys from its first key, and the splits a query sees
    are folded in increasing order.  A key the kernel masks or never loads
    gets p = 0 here, which leaves m, l and acc unchanged; keys at or past a
    row's length are zeroed as the kernel's loads zero them, so whatever a
    block holds there (the null block's garbage) never reaches a sum."""
    b, hq, c, d = q.shape
    hkv = k_cache.shape[1]
    rep = hq // hkv
    if page_table is not None:
        bk = k_cache.shape[2]
        max_len = bk * page_table.shape[1]
    else:
        max_len = k_cache.shape[2]
        bk = kv_block_size(max_len, block_kv)
    span = split_span(bk)
    quant = k_scale is not None
    if quant:
        k_scale = k_scale.reshape(k_cache.shape[:3])
        v_scale = v_scale.reshape(k_cache.shape[:3])
    scale = scale if scale is not None else float(1.0 / d ** 0.5)
    scale_log2 = scale * LOG2E
    dev = q.device
    lengths = _rows(lengths, b, dev).long()
    q_lens = _rows(q_lens, b, dev).long()
    q5 = q.reshape(b, hkv, rep, c, d).to(torch.float32)
    j = torch.arange(c, device=dev)
    q_pos = (lengths - q_lens)[:, None] + j[None, :]               # (b, c)
    lim = torch.clamp(lengths, max=max_len)
    # the keys query (b, j) sees: [lo, hi), empty for a dead query
    hi = torch.minimum(q_pos + 1, lim[:, None])
    lo = (torch.clamp(q_pos - window + 1, min=0) if window is not None
          else torch.zeros_like(q_pos))
    hi = torch.where(j[None, :] < q_lens[:, None], hi, lo)
    neg = torch.tensor(_NEG_INF, device=dev)
    zero = torch.zeros((), device=dev)

    def init():
        return (torch.full((b, hkv, rep, c), _NEG_INF, device=dev),
                torch.zeros((b, hkv, rep, c), device=dev),
                torch.zeros((b, hkv, rep, c, d), device=dev))

    state = init()
    for s0 in range(0, max_len, span):
        m, l, acc = init()
        for k0 in range(s0, min(s0 + span, max_len), KV_STEP_KEYS):
            pos = torch.arange(k0, min(k0 + KV_STEP_KEYS, s0 + span, max_len),
                               device=dev)
            loaded = (pos[None, :] < lim[:, None])[:, None, :]      # (b,1,n)
            valid = ((pos[None, None, :] >= lo[:, :, None])
                     & (pos[None, None, :] < hi[:, :, None]))     # (b,c,n)
            vm = valid[:, None, None]                              # (b,1,1,c,n)
            kb = torch.where(loaded[..., None], _keys(k_cache, pos, bk,
                                                      page_table)
                             .to(torch.float32), zero)
            vb = torch.where(loaded[..., None], _keys(v_cache, pos, bk,
                                                      page_table)
                             .to(torch.float32), zero)
            sc = torch.einsum("bgrcd,bgkd->bgrck", q5, kb)
            if quant:
                ks = torch.where(loaded, _keys(k_scale, pos, bk, page_table),
                                 zero)
                sc = sc * ks[:, :, None, None, :]
            sc = torch.where(vm, sc * scale_log2, neg)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp2(m - m_new)
            p = torch.where(vm, torch.exp2(sc - m_new[..., None]), zero)
            l = l * alpha + p.sum(dim=-1)
            if quant:
                vs = torch.where(loaded, _keys(v_scale, pos, bk, page_table),
                                 zero)
                p = p * vs[:, :, None, None, :]
            pv = torch.einsum("bgrck,bgkd->bgrcd",
                              p.to(q.dtype).to(torch.float32), vb)
            acc = acc * alpha[..., None] + pv
            m = m_new
        visible = ((lo < hi) & (lo < s0 + span) & (hi > s0))[:, None, None]
        state = fold_split(state, (m, l, acc), visible)
    _, l, acc = state
    out = acc / torch.where(l == 0, torch.ones((), device=dev), l)[..., None]
    return out.reshape(b, hq, c, d).to(q.dtype)


def _check_leaf(t, dtype, device, what: str) -> None:
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous {dtype} on {device}, got "
                         f"{t.dtype} on {t.device}")


def mixed_flash_attention_cuda(q, k_cache, v_cache, lengths, q_lens, *,
                               window=None, scale=None, k_scale=None,
                               v_scale=None, page_table=None,
                               block_kv: int = DEFAULT_BLOCK_KV
                               ) -> torch.Tensor:
    """Launch ``csrc/decode_flash.cu`` on the current stream: the variant
    the operands name (page table: paged; scales: int8 K/V).  Every shape,
    dtype and page size the kernel does not take raises here.  bfloat16
    runs two kernels (the splits, then their fold, into scratch allocated
    here); the launch is counted once, as one call of the kernel.  The
    head dim is checked first, so its refusal shows on any device."""
    b, hq, c, d = q.shape
    if q.dtype in HEAD_DIMS and d not in HEAD_DIMS[q.dtype]:
        raise ValueError(
            f"head_dim {d} in {q.dtype}: the kernel takes "
            + "; ".join(f"{str(t).split('.')[1]} {dims}"
                        for t, dims in HEAD_DIMS.items())
            + (" (float32's K/V tiles at 256 would need 266 KB of shared "
               "memory)" if d == 256 else ""))
    check_activation(q, NAME)
    paged, quant = page_table is not None, k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("k_scale and v_scale come together (int8 K/V)")
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError("caches must be 4-D, k and v alike")
    n_rows, hkv, span, dk = k_cache.shape
    if dk != d:
        raise ValueError(f"cache {tuple(k_cache.shape)} vs q {tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"hq={hq} not a multiple of hkv={hkv}")
    if paged:
        if page_table.dim() != 2 or page_table.shape[0] != b:
            raise ValueError(f"page_table {tuple(page_table.shape)} must be "
                             f"(B={b}, n_pages)")
        if page_table.device != q.device:
            raise ValueError("page_table must be on q's device")
        if span not in PAGE_SIZES:
            raise ValueError(
                f"page size {span}: the paged kernel takes pages of "
                f"{PAGE_SIZES.start} to {PAGE_SIZES.stop - 1} tokens")
        bk, max_len = span, page_table.shape[1] * span
        page_table = page_table.to(torch.int32).contiguous()
    else:
        if n_rows != b:
            raise ValueError(f"cache {tuple(k_cache.shape)} vs q "
                             f"{tuple(q.shape)}")
        bk, max_len = kv_block_size(span, block_kv), span
    kv_dtype = torch.int8 if quant else q.dtype
    _check_leaf(k_cache, kv_dtype, q.device, "k_cache")
    _check_leaf(v_cache, kv_dtype, q.device, "v_cache")
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.shape not in (k_cache.shape[:3], (*k_cache.shape[:3], 1)):
                raise ValueError(f"{name} {tuple(t.shape)} vs cache "
                                 f"{tuple(k_cache.shape)}")
            _check_leaf(t, torch.float32, q.device, name)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    scale = scale if scale is not None else float(1.0 / d ** 0.5)
    q = q.contiguous()
    lengths = _rows(lengths, b, q.device).to(torch.int32).contiguous()
    q_lens = _rows(q_lens, b, q.device).to(torch.int32).contiguous()
    out = torch.empty_like(q)
    span = split_span(bk)
    part_acc = part_ml = None
    slice_c = c
    if q.dtype == torch.bfloat16 and b and c:
        # the kernel's per-split states, f32: (m, l) and acc per query row
        n_split = -(-max_len // span)
        per_query = b * hq * n_split * (d + 2) * 4
        slice_c = max(1, min(c, SPLIT_SCRATCH_BYTES // per_query))
        rows = hq // hkv * slice_c
        part_acc = torch.empty((b, hkv, n_split, rows, d),
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty((b, hkv, n_split, rows, 2),
                              dtype=torch.float32, device=q.device)
    if b:
        def ptr(t):
            return None if t is None else t.data_ptr()
        fn = _build.function("decode_flash", "mixed_flash_launch", _ARGTYPES)
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                ptr(k_scale), ptr(v_scale), ptr(page_table),
                lengths.data_ptr(), q_lens.data_ptr(), out.data_ptr(),
                ptr(part_acc), ptr(part_ml), b, hq, hkv, c, d, max_len, bk,
                span, slice_c, scale, window or 0, DTYPE_CODES[q.dtype],
                _build.stream_ptr(q.device))
        _build.check("decode_flash", rc)
        _build.launches[VARIANTS[(paged, quant)]] += 1
    return out
