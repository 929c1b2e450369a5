#!/usr/bin/env python3
"""Profiles the same served tick many times, to see how far
``torch.profiler``'s records of it can be trusted, and sums each hand
kernel's in-graph time over the windows that saw every launch:

    python3 tools/trace_repeat.py [--repeats 12] [--paths dense xlstm-dense]

For each path (full width and depth, random weights from seed 0,
``chip_smoke.py`` phase 5's engine and workload; ``PATHS`` names them:
qwen-7b, xlstm-1.3b, gemma-2b, zamba2-7b and qwen2-vl-7b, each "dense"),
the decode tick and the widest mixed tick are replayed on the same live
inputs ``--repeats`` times, each replay with the engine's fetch under the
profiler as ``chip_smoke.trace_ticks`` does, once as it is and once with a
spin kernel queued ahead of the tick inside the window (``lead_in``: the
profiler is recording before the tick's first launch; the spin is left
out of every sum).  Each window gives its device operations, the
device-to-host copies the profiler saw and, on a transformer path, each
hand kernel's device ms and launches (``KERNEL_NAMES``) against the
launches the tick makes (``chip_smoke.expected_launches``; on the hybrid
``chip_smoke.expected_launches_hybrid`` times the tick's columns, the
fused Mamba2 step counted too).  A window is complete when every counted
kernel shows all of its launches; the row gives the medians of the
complete windows' kernel ms and busy ms.
Beside them, the copies the tick asked for at PyTorch's dispatcher
(``chip_smoke.host_copies``).  One JSON line per (path, key, lead-in) goes
to ``chiprun_out/trace_repeat.jsonl``.  Needs one card; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out")
PATHS = {"dense": ("qwen-7b", "dense"), "xlstm-dense": ("xlstm-1.3b", "dense"),
         "gemma-2b-dense": ("gemma-2b", "dense"),
         "zamba2-dense": ("zamba2-7b", "dense"),
         "qwen2-vl-dense": ("qwen2-vl-7b", "dense")}
# a hand kernel's launch counter (``chip_smoke.expected_launches``) by a
# pattern of its traced name; the W4A16 tile's last template argument is
# its epilogue (0 and 4, the bias: kernel 1; 1 swiglu, 2 geglu: kernel 2's
# gate/up), the norm's its residual add (0: ``rmsnorm``, 1: ``add_rmsnorm``,
# 3: ``rmsnorm_gated``); the fused Mamba2 step, and the cell's two passes
# (the chain it replaced, ``tools/hybrid_ab.py``)
KERNEL_NAMES = (
    ("w4a16_matmul", r"w4a16_mma_kernel<.*, [04]>\("),
    ("ffn_fused_w4a16", r"w4a16_mma_kernel<.*, [12]>\("),
    ("dense_matmul", r"dense_mma_kernel<"),
    ("attention", r"mixed_flash_mma_kernel<"),
    ("attention fold", r"mixed_flash_fold_kernel<"),
    ("add_rmsnorm", r"add_rmsnorm_kernel<[^>]*, 1>\("),
    ("rmsnorm", r"add_rmsnorm_kernel<[^>]*, 0>\("),
    ("rmsnorm_gated", r"add_rmsnorm_kernel<[^>]*, 3>\("),
    ("mamba_cell_gated", r"mamba_cell_gated_kernel<"),
    ("mamba_cell conv", r"mamba_conv_kernel<"),
    ("mamba_cell state", r"mamba_state_kernel<"),
    ("qkv_rope_write", r"qkv_rope_write_kernel<"))


def kernel_ms(torch, events) -> dict:
    """Device ms and launches of each ``KERNEL_NAMES`` kernel among a
    window's device events."""
    import re
    out = {}
    for e in events:
        for kernel, pattern in KERNEL_NAMES:
            if re.search(pattern, e.name):
                ms, n = out.get(kernel, (0.0, 0))
                out[kernel] = (ms + (e.time_range.end - e.time_range.start)
                               / 1e3, n + 1)
                break
    return out


def busy_ms(events) -> float:
    """The union of the events' device intervals, in ms."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def expected_per_tick(cs, cfg, params, columns) -> dict | None:
    """Launches a tick of ``columns`` token columns makes of each
    ``KERNEL_NAMES`` kernel (the attention's variant under its plain
    name, its fold once a launch; the hybrid's mixed tick steps each of
    its columns); None on the xLSTM stack."""
    from repro_torch.kernels.decode_flash import VARIANTS
    if cfg.family == "ssm":
        return None
    if cfg.family == "hybrid":
        per = dict(cs.expected_launches_hybrid(cfg, params, columns))
    else:
        per = dict(cs.expected_launches(cfg, params, 1))
    for name in VARIANTS.values():
        if name in per:
            per["attention"] = per.pop(name)
    per["attention fold"] = per["attention"]
    return per


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=12)
    ap.add_argument("--paths", nargs="+", default=["dense", "xlstm-dense"],
                    choices=sorted(PATHS))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs             # build_model, workload; puts ROOT/src
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs the card")
        return 1
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import Engine, Request
    _build.build()
    smi = cs.nvidia_smi("name,power.limit")
    print(smi, flush=True)
    os.makedirs(OUT, exist_ok=True)
    for path in args.paths:
        arch, strategy = PATHS[path]
        cfg, params = cs.build_model(torch, arch, strategy)
        engine = Engine(cfg, params, batch_size=4, max_len=cs.SERVE_MAX_LEN,
                        chunk_size=64, device="cuda")
        for i, p in enumerate(cs.workload(cfg)):
            engine.submit(Request(rid=i, prompt=p.astype(np.int32),
                                  max_new_tokens=cs.SERVE_NEW_TOKENS))
        engine.run()
        rng = np.random.default_rng(10)
        keys = cs.tick_keys(engine)
        mixed = [k for k in keys if k[0] == "mixed"]
        for name, width in [k for k in keys if k[0] == "decode"] + mixed[-1:]:
            tick = engine._executable(name, width)
            expected = expected_per_tick(cs, cfg, params, width or 1)
            host = cs.live_inputs(engine, name, width or engine.batch, rng)
            served = lambda: engine._fetch(  # noqa: E731
                *tick(params, engine.cache, **host), False)
            for lead_in in (False, True):
                ops, traced, asked, seen, busy = [], [], [], [], []
                for _ in range(args.repeats):
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        if lead_in:
                            torch.cuda._sleep(cs.SPIN_CYCLES)
                        served()
                        torch.cuda.synchronize()
                    events = [e for e in prof.events() if e.device_type
                              == torch.autograd.DeviceType.CUDA
                              and "spin" not in e.name]
                    ops.append(len(events))
                    traced.append(sum("DtoH" in e.name for e in events))
                    asked.append(cs.host_copies(torch, served))
                    seen.append(kernel_ms(torch, events))
                    busy.append(busy_ms(events))
                row = {"path": path, "key": f"{name}-{width or engine.batch}",
                       "lead_in": lead_in, "nvidia_smi": smi,
                       "device_ops": ops, "dtoh_traced": traced,
                       "dtoh_asked": asked, "busy_ms": busy}
                if expected is not None:
                    full = [i for i, k in enumerate(seen) if all(
                        k.get(kernel, (0.0, 0))[1] == n
                        for kernel, n in expected.items())]
                    row["expected"] = expected
                    row["launches_seen"] = [
                        {kernel: n for kernel, (_, n) in k.items()}
                        for k in seen]
                    row["complete"] = len(full)
                    if full:
                        row["kernel_ms"] = {
                            kernel: float(np.median([seen[i][kernel][0]
                                                     for i in full]))
                            for kernel in expected}
                        row["busy_ms_complete"] = float(
                            np.median([busy[i] for i in full]))
                print(json.dumps(row), flush=True)
                with open(os.path.join(OUT, "trace_repeat.jsonl"), "a") as fh:
                    fh.write(json.dumps(row) + "\n")
        del engine, params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
