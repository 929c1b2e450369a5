#!/usr/bin/env python3
"""Times kernels 4 and 5 (the log-scale sparse W4A16 matmul and the sparse
FFN) and the strategy2 prefills of ``chip_smoke.py`` phase 6 (e) with the
port found under ``--src``, so two trees can be compared on one card:

    python3 tools/sparse_ab.py --src checkout/parent/src --tag parent
    python3 tools/sparse_ab.py --tag change

Run the trees in turns (parent, change, change, parent) in one session on
the card.  Kernel times are CUDA events after an L2 flush
(``chip_smoke.Timer``), bf16, at qwen-7b's wo (4096 -> 4096, density 0.5)
and strategy2 FFN (4096 -> 11008 -> 4096: gate/up at 0.25, down
tile_uniform at 0.5), T = 4, 256 and 1024.  The prefills: qwen-7b at full
width and depth under strategy2, the 200-token prompt of phase 5's
workload into the int8 slot cache and into the paged pool, host clock
around ``api.prefill`` and a synchronize, one warm-up and five timed
runs each.  One JSON line per run goes to ``chiprun_out/sparse_ab.jsonl``.
Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="change")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs             # Timer, the workload; puts ROOT/src
    sys.path.insert(0, os.path.abspath(args.src))   # ... behind --src
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs the card")
        return 1
    import repro_torch
    from repro_torch.core.compiler import quantize_model
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.ffn_fused import (
        ffn_gate_up_sparse_cuda, kept_f_tiles)
    from repro_torch.models import api
    print(f"[{args.tag}] repro_torch from {repro_torch.__file__}",
          flush=True)
    _build.build(("w4a16_matmul", "sparse_w4a16", "ffn_fused_sparse",
                  "decode_flash", "rmsnorm", "flash_attention"))
    timer = cs.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    d, f = cs.QWEN_D, cs.QWEN_F
    w = quantize_model({"wo": randn(d, d, dtype=torch.float32) * 0.02,
                        "gate": randn(d, f, dtype=torch.float32) * 0.02,
                        "up": randn(d, f, dtype=torch.float32) * 0.02,
                        "down": randn(f, d, dtype=torch.float32) * 0.02},
                       "strategy2")
    tiles = kept_f_tiles(w["down"])
    out = {"tag": args.tag, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi("name,power.limit"), "ms": {}}
    for t in (4, 256, 1024):
        x = randn(t, d)
        out["ms"][f"wo T={t}"] = timer.ms(
            lambda: ops.sparse_w4a16_matmul(x, w["wo"]), 20)
        out["ms"][f"gate/up T={t}"] = timer.ms(
            lambda: ffn_gate_up_sparse_cuda(x, w["gate"], w["up"], "swiglu",
                                            tiles), 20)
        out["ms"][f"ffn T={t}"] = timer.ms(
            lambda: ops.ffn_w4a16(x, w["gate"], w["up"], w["down"]), 20)
    del w, timer
    torch.cuda.empty_cache()

    cfg, params = cs.build_model(torch, "qwen-7b", "strategy2")
    prompt = cs.workload(cfg)[-1]
    toks = torch.tensor(prompt[None], device="cuda")
    out["prefill_s"] = {}
    for kv, over in cs.KV_PATHS["strategy2"]:
        if kv not in ("int8", "paged"):
            continue
        pcfg = dataclasses.replace(cfg, **{**over, "kv_pool_blocks": 0})
        runs = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.prefill(pcfg, params, {"tokens": toks}, cs.SERVE_MAX_LEN)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        out["prefill_s"][kv] = runs[1:]
    print(json.dumps(out), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "sparse_ab.jsonl"), "a") as fh:
        fh.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
