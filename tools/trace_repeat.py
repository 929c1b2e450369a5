#!/usr/bin/env python3
"""Profiles the same served tick many times, to see how far
``torch.profiler``'s records of it can be trusted:

    python3 tools/trace_repeat.py [--repeats 12]

For qwen-7b "dense" and xlstm-1.3b "dense" (full width and depth, random
weights from seed 0, ``chip_smoke.py`` phase 5's engine and workload), the
decode tick and the widest mixed tick are replayed on the same live inputs
``--repeats`` times, each replay with the engine's fetch under the
profiler as ``chip_smoke.trace_ticks`` does. Each window gives its device
operations and the device-to-host copies the profiler saw; beside them,
the copies the tick asked for at PyTorch's dispatcher
(``chip_smoke.host_copies``). One JSON line per (path, key) goes to
``chiprun_out/trace_repeat.jsonl``. Needs one card; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out")
PATHS = (("dense", "qwen-7b", "dense"), ("xlstm-dense", "xlstm-1.3b", "dense"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=12)
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
    for path, arch, strategy in PATHS:
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
            host = cs.live_inputs(engine, name, width or engine.batch, rng)
            served = lambda: engine._fetch(  # noqa: E731
                *tick(params, engine.cache, **host), False)
            ops, traced, asked = [], [], []
            for _ in range(args.repeats):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    served()
                    torch.cuda.synchronize()
                events = [e for e in prof.events() if e.device_type
                          == torch.autograd.DeviceType.CUDA]
                ops.append(len(events))
                traced.append(sum("DtoH" in e.name for e in events))
                asked.append(cs.host_copies(torch, served))
            row = {"path": path, "key": f"{name}-{width or engine.batch}",
                   "nvidia_smi": smi, "device_ops": ops,
                   "dtoh_traced": traced, "dtoh_asked": asked}
            print(json.dumps(row), flush=True)
            with open(os.path.join(OUT, "trace_repeat.jsonl"), "a") as fh:
                fh.write(json.dumps(row) + "\n")
        del engine, params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
