"""The grouped expert kernels' work list on the CPU: ``moe_items_torch``,
the plain version of the enumeration every block of
``csrc/moe_experts.cu`` builds from the route's counts, against a Python
enumeration; and the names under which ``chip_smoke.py`` finds the MoE
kernels in a trace."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import moe_experts  # noqa: E402


def _enumerate(counts, bm, strips):
    """(expert, first row, strip) of every item: experts in order, an
    expert's strips in order, its row tiles fastest."""
    out = []
    for e, c in enumerate(counts):
        tiles = -(-c // bm)
        for strip in range(strips):
            for t in range(tiles):
                out.append((e, t * bm, strip))
    return out


def _counts(case, e=40, seed=0):
    rng = np.random.default_rng(seed)
    if case == "random":
        return rng.integers(0, 80, e).tolist()
    if case == "sparse":
        c = np.zeros(e, np.int64)
        c[rng.choice(e, 5, replace=False)] = rng.integers(1, 300, 5)
        return c.tolist()
    if case == "zeros":
        return [0] * e
    if case == "first":
        return [256] + [0] * (e - 1)
    assert case == "last"
    return [0] * (e - 1) + [256]


TILES = sorted(set(moe_experts.GATE_UP_TILES.values())
               | set(moe_experts.DOWN_TILES.values()))


@pytest.mark.parametrize("case", ["random", "sparse", "zeros", "first",
                                  "last"])
@pytest.mark.parametrize("bm,bn", TILES)
@pytest.mark.parametrize("out_f", [512, 1536])
def test_items_match_a_python_enumeration(case, bm, bn, out_f):
    strips = -(-out_f // bn)
    for seed in range(3 if case in ("random", "sparse") else 1):
        counts = _counts(case, seed=seed)
        got = moe_experts.moe_items_torch(torch.tensor(counts), bm, strips)
        assert got.dtype == torch.int32 and got.shape[1] == 3
        assert [tuple(r) for r in got.tolist()] == _enumerate(counts, bm,
                                                               strips)


@pytest.mark.parametrize("experts", [8, 40, 128])
def test_items_cover_every_kept_row_once(experts):
    """Each kept row of each expert, and each output column, falls in
    exactly one item."""
    rng = np.random.default_rng(experts)
    counts = rng.integers(0, 50, experts)
    counts[rng.choice(experts, experts // 3, replace=False)] = 0
    bm = moe_experts.GATE_UP_TILES[2][0]
    strips = 3
    items = moe_experts.moe_items_torch(torch.tensor(counts), bm, strips)
    seen = {}
    for e, t0, strip in items.tolist():
        for r in range(t0, min(t0 + bm, int(counts[e]))):
            seen[(e, r, strip)] = seen.get((e, r, strip), 0) + 1
    want = {(e, r, s) for e in range(experts) for r in range(int(counts[e]))
            for s in range(strips)}
    assert set(seen) == want and set(seen.values()) <= {1}


# the ring kernel's parameters as a trace prints them
_RING_ARGS = ("(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
              "CUtensorMap_st, __nv_bfloat16 const*, int const*, int const*, "
              "int const*, int, int, int, __nv_bfloat16*)")


@pytest.mark.parametrize("name,kernel", [
    ("void repro::moe_grouped_kernel<repro::W4MmaTile<16, 32, 1, 4, 2, 4, 2, "
     "32>, 1, true>(__nv_bfloat16 const*, int const*)", "moe_gate_up_w4a16"),
    ("void repro::moe_grouped_kernel<repro::W4MmaTile<64, 64, 2, 4, 1, 4, 1, "
     "32>, 0, false>(__nv_bfloat16 const*, int const*)", "moe_down_w4a16"),
    # MoeGatedDecode<32>, MoeGatedMid<128>, MoeDecode<64>, MoeMid<32>
    ("void repro::moe_ring_kernel<repro::MoeRing<repro::W4MmaTile<16, 32, 1, "
     "4, 2, 4, 2, 32>, 3, false, 1>, 1, true>" + _RING_ARGS,
     "moe_gate_up_w4a16"),
    ("void repro::moe_ring_kernel<repro::MoeRing<repro::W4MmaTile<64, 64, 2, "
     "4, 1, 4, 2, 128>, 4, true, 2>, 1, true>" + _RING_ARGS,
     "moe_gate_up_w4a16"),
    ("void repro::moe_ring_kernel<repro::MoeRing<repro::W4MmaTile<16, 32, 1, "
     "4, 2, 4, 1, 64>, 4, false, 1>, 0, false>" + _RING_ARGS,
     "moe_down_w4a16"),
    ("void repro::moe_ring_kernel<repro::MoeRing<repro::W4MmaTile<32, 128, 1, "
     "4, 1, 4, 1, 32>, 4, true, 3>, 0, false>" + _RING_ARGS,
     "moe_down_w4a16"),
    ("void repro::moe_route_kernel<float>(float const*, int)", "moe_route"),
    ("void repro::moe_route_kernel<__nv_bfloat16, true>(repro::RouteArgs)",
     "moe_route"),
    ("void repro::moe_combine_kernel<__nv_bfloat16>(int)", "moe_combine"),
    ("void repro::add_rmsnorm_kernel<__nv_bfloat16, 2>(__nv_bfloat16 "
     "const*, int const*)", "combine_add_rmsnorm"),
    ("void repro::add_rmsnorm_kernel<__nv_bfloat16, 1>(__nv_bfloat16 "
     "const*, int const*)", "add_rmsnorm"),
    ("void repro::add_rmsnorm_kernel<__nv_bfloat16, true>(__nv_bfloat16 "
     "const*, float)", "add_rmsnorm"),
    ("void repro::add_rmsnorm_kernel<__nv_bfloat16, 0>(__nv_bfloat16 "
     "const*, int const*)", None),
    ("void repro::dense_mma_kernel<repro::MmaTile<16, 32, 1, 4, 128, 6>, 1, "
     "0, false>(__nv_bfloat16 const*, int)", "router dense_matmul"),
    ("void repro::dense_mma_kernel<repro::MmaTile<16, 32, 1, 4, 128, 6>, 1, "
     "0, true>(__nv_bfloat16 const*, int)", None),
    ("void repro::w4a16_mma_kernel<repro::W4MmaTile<16, 32, 1, 4, 2, 4, 2, "
     "128>, 1>(__nv_bfloat16 const*)", None)])
def test_trace_names_the_moe_kernels(name, kernel):
    """``chip_smoke.moe_kernel_ms`` files a traced kernel under its MoE
    kernel by name, the grid-per-expert and the ring kernels alike, the
    combine in the norm by its template code, the chain it replaced (the
    routers' ``dense_matmul``, ``moe_combine``, the norm with a residual
    add) as a parent tree's trace names it, and kernel 2's gate/up, the
    norm alone and the tied head under none."""
    import types
    import chip_smoke
    cuda = torch.autograd.DeviceType.CUDA
    span = types.SimpleNamespace(start=10.0, end=35.0)
    events = [types.SimpleNamespace(device_type=cuda, name=name,
                                    time_range=span),
              types.SimpleNamespace(device_type=torch.autograd.DeviceType.CPU,
                                    name=name, time_range=span)]
    got = chip_smoke.moe_kernel_ms(
        torch, types.SimpleNamespace(events=lambda: events))
    assert got == ({} if kernel is None else {kernel: (0.025, 1)})


@pytest.mark.parametrize("case,complete", [("all", True), ("renamed", False),
                                           ("lost", False)])
def test_moe_trace_counts_the_launches_a_tick_makes(case, complete):
    """``chip_smoke.moe_trace`` expects each MoE kernel once a layer and
    calls a window complete only when it saw all of them: not when one
    launch of one kernel was lost, and not when a kernel's name went
    unmatched."""
    import types
    import chip_smoke
    layers = 4
    cuda = torch.autograd.DeviceType.CUDA
    span = types.SimpleNamespace(start=0.0, end=10.0)
    names = {"moe_route": "void repro::moe_route_kernel<float>(int)",
             "moe_gate_up_w4a16": "void repro::moe_ring_kernel<X, 1, true>()",
             "moe_down_w4a16": "void repro::moe_ring_kernel<X, 0, false>()",
             "combine_add_rmsnorm":
                 "void repro::add_rmsnorm_kernel<float, 2>(float const*)"}
    events = []
    for kernel, name in names.items():
        n = layers
        if kernel == "moe_down_w4a16" and case == "renamed":
            n = 0                        # matched by nothing
        if kernel == "combine_add_rmsnorm" and case == "lost":
            n = layers - 1
        events += [types.SimpleNamespace(device_type=cuda, name=name,
                                         time_range=span)] * n
    prof = types.SimpleNamespace(events=lambda: events)
    got = chip_smoke.moe_trace(
        torch, prof, types.SimpleNamespace(is_moe=True, n_layers=layers))
    assert got["expected"] == layers and got["complete"] == complete
    assert chip_smoke.moe_trace(
        torch, prof, types.SimpleNamespace(is_moe=False)) is None
