#!/usr/bin/env python3
"""A/B of zamba2-7b's served Mamba2 step on one card: the fused kernel
(``mamba_cell_gated``: the cell and the gated norm, one launch a layer)
against the chain it replaced (``mamba_cell``'s two passes, then
``rmsnorm_gated``), in turns:

    python3 tools/hybrid_ab.py [--order chain fused fused chain] [--repeats 6]
    python3 tools/hybrid_ab.py --layers 81 [--src <tree>/src --tag T]

zamba2-7b is built once (full width and depth, "dense" W4A16, random
weights from seed 0: ``chip_smoke.build_model``).  For each entry of
``--order`` a new engine (``chip_smoke.py`` phase 5's: 4 rows, 512
positions, 64-token chunks) serves phase 5's workload once with the
step's Mamba2 op on that route (its graphs are captured under it); then
its replayed decode-4 tick and widest mixed tick (64 decode steps) are
traced ``--repeats`` times each with the engine's fetch, as
``tools/trace_repeat.py`` traces them, recording each window's busy ms
and the hybrid kernels' in-graph ms and launches.  Only windows that saw
every launch the tick makes count.  Every run's token streams must equal
the first run's, bitwise.  One JSON line per (run, key) and one summary
line per (route, key) (medians over the complete windows of every run of
the route: busy ms and the Mamba2 step's in-graph ms) are printed and
appended to ``chiprun_out/hybrid_ab.jsonl``.

``--layers N`` times the Mamba2 step alone instead, as a decode step
launches it: N layers' operands at zamba2-7b's widths (B = 4, bf16,
random from fixed seeds, each layer its own state, window and weights: 81
layers hold 594 MB of f32 state, past L2), the N steps captured in one
CUDA graph a route and replayed ``--iters`` times between CUDA events
(median ms a replay, and a layer).  Every route's outputs, windows and
states after one replay from the same start are held bitwise equal, and
their SHA-1 recorded, so that ``--src`` (the port of another tree, e.g. a
variant of the kernel, imported in place of this one's; ``chain`` only on
a tree without the fused op) can be compared across runs by ``--tag``.
Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out")
ROUTES = ("chain", "fused")
# the Mamba2 step's traced kernels on each route (``trace_repeat`` names)
STEP_KERNELS = {"fused": ("mamba_cell_gated",),
                "chain": ("mamba_cell conv", "mamba_cell state",
                          "rmsnorm_gated")}


def layer_operands(torch, cs, n_layers, b=4):
    """``n_layers`` Mamba2 layers' step operands at zamba2-7b's widths
    (``chip_smoke.mamba_inputs``) and norm weights, from fixed seeds."""
    g = torch.Generator(device="cuda").manual_seed(34)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    out = []
    for _ in range(n_layers):
        inp = cs.mamba_inputs(torch, randn, b)
        inp["gamma"] = (1 + 0.1 * randn(cs.ZAMBA_DI,
                                        dtype=torch.float32)).to(
            torch.bfloat16)
        out.append(inp)
    return out


def step(ops, name, t, cs):
    """One layer's Mamba2 step on route ``name``: the gated row."""
    args = (t["proj"], t["window"], t["conv_w"], t["conv_b"], t["A_log"],
            t["D"], t["dt_bias"], t["state"], t["gamma"])
    kw = dict(n_state=cs.ZAMBA_N, head_dim=cs.ZAMBA_P)
    if name == "chain":
        return cs.chain_mamba_cell_gated(*args, **kw)
    return ops.mamba_cell_gated(*args, **kw)


def digest(torch, tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def time_layers(torch, cs, args, smi, emit) -> int:
    """``--layers``: the N-layer step graph of each route, timed."""
    import numpy as np
    from repro_torch.kernels import _build, ops
    start = layer_operands(torch, cs, args.layers)
    digests = {}
    for run, name in enumerate(args.order):
        work = [{k: v.clone() for k, v in inp.items()} for inp in start]
        for t in work:                  # warm: builds, counters, caches
            step(ops, name, t, cs)
        for t, inp in zip(work, start):
            for k in ("window", "state"):
                t[k].copy_(inp[k])
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        _build.launches.clear()
        with torch.cuda.graph(graph):
            outs = [step(ops, name, t, cs) for t in work]
        launched = dict(_build.launches)
        graph.replay()
        torch.cuda.synchronize()
        sha = digest(torch, [x for t, o in zip(work, outs)
                             for x in (o, t["window"], t["state"])])
        digests[name] = sha
        ms = []
        for _ in range(args.iters):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            graph.replay()
            e.record()
            e.synchronize()
            ms.append(s.elapsed_time(e))
        med = float(np.median(ms))
        emit({"layers": args.layers, "run": run, "route": name,
              "tag": args.tag, "nvidia_smi": smi, "launches": launched,
              "replay_ms": ms, "median_ms": med,
              "layer_us": med * 1e3 / args.layers, "sha1": sha})
        del graph, outs, work
        torch.cuda.empty_cache()
    if len(set(digests.values())) != 1:
        print(f"FAIL: the routes' outputs differ: {digests}")
        return 1
    return 0


@contextlib.contextmanager
def route(cs, name):
    """The card's ``mamba_cell_gated`` on ``name``'s route (``chain``: the
    cell kernel, then the gated norm kernel, as served before the fused
    kernel; a tree without the fused op serves the chain as it is)."""
    from repro_torch.kernels import ops
    saved = getattr(ops, "mamba_cell_gated_cuda", None)
    if name == "chain" and saved is not None:   # a tree without it: as is
        ops.mamba_cell_gated_cuda = cs.chain_mamba_cell_gated
    try:
        yield
    finally:
        if saved is not None:
            ops.mamba_cell_gated_cuda = saved


def expected(tr, cs, cfg, params, columns, name) -> dict:
    """Launches a tick of ``columns`` steps makes of each traced kernel on
    route ``name``."""
    per = tr.expected_per_tick(cs, cfg, params, columns)
    if name == "chain":
        n = per.pop("mamba_cell_gated")
        for kernel in STEP_KERNELS["chain"]:
            per[kernel] = n
    return per


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--order", nargs="+", choices=ROUTES,
                    default=["chain", "fused", "fused", "chain"])
    ap.add_argument("--repeats", type=int, default=6)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--src", default=None)
    ap.add_argument("--tag", default="change")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import chip_smoke as cs             # build_model, workload; puts ROOT/src
    if args.src is not None:
        sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch
    import trace_repeat as tr
    if not torch.cuda.is_available():
        print("FAIL: needs the card")
        return 1
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import Engine, Request
    _build.build(("mamba_cell", "rmsnorm") if args.layers else
                 _build.KERNEL_SOURCES)
    smi = cs.nvidia_smi("name,power.limit")
    print(smi, flush=True)
    os.makedirs(OUT, exist_ok=True)
    log = os.path.join(OUT, "hybrid_ab.jsonl")

    def emit(row):
        print(json.dumps(row), flush=True)
        with open(log, "a") as fh:
            fh.write(json.dumps(row) + "\n")

    if args.layers:
        return time_layers(torch, cs, args, smi, emit)

    cfg, params = cs.build_model(torch, "zamba2-7b", "dense")
    first_streams = None
    done = {}           # (route, key) -> [(busy ms, step ms)] per window
    for run, name in enumerate(args.order):
        with route(cs, name):
            engine = Engine(cfg, params, batch_size=4,
                            max_len=cs.SERVE_MAX_LEN, chunk_size=64,
                            device="cuda")
            reqs = [Request(rid=i, prompt=p.astype(np.int32),
                            max_new_tokens=cs.SERVE_NEW_TOKENS)
                    for i, p in enumerate(cs.workload(cfg))]
            for r in reqs:
                engine.submit(r)
            _build.launches.clear()
            engine.run()
            streams = [list(r.output) for r in reqs]
            launched = {k: _build.launches[k] for k in
                        ("mamba_cell_gated", "mamba_cell", "rmsnorm_gated")}
            if first_streams is None:
                first_streams = streams
            if streams != first_streams:
                print(f"FAIL: run {run} ({name}): the streams differ from "
                      "run 0's")
                return 1
            rng = np.random.default_rng(10)
            keys = cs.tick_keys(engine)
            mixed = [k for k in keys if k[0] == "mixed"]
            for key, width in [k for k in keys if k[0] == "decode"] \
                    + mixed[-1:]:
                tick = engine._executable(key, width)
                want = expected(tr, cs, cfg, params, width or 1, name)
                host = cs.live_inputs(engine, key, width or engine.batch,
                                      rng)
                served = lambda: engine._fetch(  # noqa: E731
                    *tick(params, engine.cache, **host), False)
                served()
                windows = []
                for _ in range(args.repeats):
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        served()
                        torch.cuda.synchronize()
                    events = [e for e in prof.events() if e.device_type
                              == torch.autograd.DeviceType.CUDA]
                    seen = tr.kernel_ms(torch, events)
                    complete = all(seen.get(k, (0.0, 0))[1] == n
                                   for k, n in want.items())
                    windows.append({
                        "busy_ms": tr.busy_ms(events),
                        "complete": complete,
                        "step_ms": sum(seen.get(k, (0.0, 0))[0]
                                       for k in STEP_KERNELS[name]),
                        "kernel_ms": {k: v[0] for k, v in seen.items()},
                        "launches": {k: v[1] for k, v in seen.items()}})
                label = f"{key}-{width or engine.batch}"
                emit({"run": run, "route": name, "key": label,
                      "tag": args.tag,
                      "nvidia_smi": smi, "expected": want,
                      "served_launches": launched, "windows": windows})
                done.setdefault((name, label), []).extend(
                    (w["busy_ms"], w["step_ms"]) for w in windows
                    if w["complete"])
            del engine, reqs
            torch.cuda.empty_cache()
    for (name, label), vals in sorted(done.items()):
        emit({"summary": True, "route": name, "key": label,
              "tag": args.tag,
              "nvidia_smi": smi, "complete_windows": len(vals),
              "busy_ms": float(np.median([v[0] for v in vals]))
              if vals else None,
              "step_ms": float(np.median([v[1] for v in vals]))
              if vals else None,
              "streams_equal": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
