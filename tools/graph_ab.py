#!/usr/bin/env python3
"""Serves ``chip_smoke.py`` phase 5's workload with the port found under
``--src``, so two trees can be held against each other on one card:

    python3 tools/graph_ab.py --src checkout/parent/src --tag parent
    python3 tools/graph_ab.py --tag change
    python3 tools/graph_ab.py --summary

Run the trees in turns (parent, change, change, parent) in one command on
one card, then ``--summary``.  Paths: qwen-7b "dense" (slot cache),
qwen-7b "strategy2" from a 20-block pool of 16-token pages, and
xlstm-1.3b "dense", at full width and depth with random weights from seed
0.  Each path's engine (``batch_size=4, max_len=512, chunk_size=64``, no
audit) serves the 9 requests (8 prompts of 4-31 tokens and one of 200, 16
new tokens each; the paged run submits the long one first) ``RUNS`` times
in a row: run 0 pays for whatever the tree builds on first use (on a tree
with CUDA graphs, their captures), the later runs are steady.  Each run
records tokens/s (tokens over the run's wall time, host clock ending in a
synchronize), TTFT p50, ITL p50 and the peak ``max_memory_allocated``
(reset before the run), the compile-cache misses and a digest of the
token streams.  One JSON line per (tree run, path) goes to
``chiprun_out/graph_ab.jsonl``; ``--summary`` prints, per path and tree,
the median and the spread (max - min) of each metric over the steady runs
and over run 0, and whether every run's streams were the same.  Needs one
card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out")
LOG = os.path.join(OUT, "graph_ab.jsonl")
RUNS = 3
PATHS = (("dense", "qwen-7b", "dense", {}),
         ("strategy2-paged", "qwen-7b", "strategy2",
          dict(kv_layout="paged", kv_block_size=16, kv_pool_blocks=20)),
         ("xlstm-dense", "xlstm-1.3b", "dense", {}))
METRICS = ("tokens_per_s", "ttft_p50_s", "itl_p50_s", "max_memory_allocated")


def serve_runs(torch, cs, cfg, params) -> list[dict]:
    import numpy as np
    from repro_torch.serving.engine import Engine, Request
    engine = Engine(cfg, params, batch_size=4, max_len=cs.SERVE_MAX_LEN,
                    chunk_size=64, device="cuda")
    prompts = cs.workload(cfg)
    out = []
    for run in range(RUNS):
        reqs = [Request(rid=100 * run + i, prompt=p.astype(np.int32),
                        max_new_tokens=cs.SERVE_NEW_TOKENS)
                for i, p in enumerate(prompts)]
        for r in (reqs[-1:] + reqs[:-1] if engine.paged else reqs):
            engine.submit(r)
        compiles = getattr(engine, "cache_compiles", None)
        misses0 = compiles.misses if compiles is not None else None
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not (done.drained and len(done) == len(reqs)):
            raise SystemExit(f"FAIL: run {run} did not finish every request")
        summary = Engine.summarize(done)
        n_tok = sum(len(r.output) for r in reqs)
        streams = json.dumps([r.output for r in reqs]).encode()
        out.append({
            "run": run, "tokens": n_tok, "wall_s": wall,
            "tokens_per_s": n_tok / wall,
            "ttft_p50_s": summary["ttft_p50_s"],
            "itl_p50_s": summary["itl_p50_s"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "ticks": engine.steps,
            "new_misses": (None if misses0 is None
                           else compiles.misses - misses0),
            "streams_sha1": hashlib.sha1(streams).hexdigest()})
    return out


def summary() -> int:
    import statistics
    with open(LOG) as fh:
        rows = [json.loads(ln) for ln in fh if ln.strip()]
    if not rows:
        raise SystemExit(f"FAIL: no runs in {LOG}")
    print(f"card: {rows[0]['nvidia_smi']}")
    for path, *_ in PATHS:
        digests = set()
        for tag in sorted({r["tag"] for r in rows}):
            runs = [x for r in rows if r["tag"] == tag and r["path"] == path
                    for x in r["runs"]]
            digests |= {x["streams_sha1"] for x in runs}
            for label, sel in (("steady", [x for x in runs if x["run"]]),
                               ("run 0", [x for x in runs if not x["run"]])):
                parts = []
                for m in METRICS:
                    v = [x[m] for x in sel]
                    parts.append(f"{m} {statistics.median(v):.6g} (spread "
                                 f"{max(v) - min(v):.6g}, n={len(v)})")
                print(f"{path} {tag} {label}: " + "; ".join(parts))
        print(f"{path}: every run's streams equal: {len(digests) == 1}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--summary", action="store_true",
                    help="print the medians and spreads of the logged runs")
    args = ap.parse_args()
    if args.summary:
        return summary()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs             # build_model, workload; puts ROOT/src
    sys.path.insert(0, os.path.abspath(args.src))   # ... behind --src
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs the card")
        return 1
    import repro_torch
    from repro_torch.kernels import _build
    print(f"[{args.tag}] repro_torch from {repro_torch.__file__}",
          flush=True)
    _build.build()
    smi = cs.nvidia_smi("name,power.limit")
    os.makedirs(OUT, exist_ok=True)
    for path, arch, strategy, kv in PATHS:
        cfg, params = cs.build_model(torch, arch, strategy)
        cfg = dataclasses.replace(cfg, **kv)
        runs = serve_runs(torch, cs, cfg, params)
        for x in runs:
            print(f"[{args.tag}] {path} run {x['run']}: "
                  f"{x['tokens_per_s']:.1f} tokens/s, TTFT p50 "
                  f"{x['ttft_p50_s'] * 1e3:.1f} ms, ITL p50 "
                  f"{x['itl_p50_s'] * 1e3:.2f} ms, peak "
                  f"{x['max_memory_allocated']} B, {x['ticks']} ticks so "
                  f"far, new misses {x['new_misses']}", flush=True)
        with open(LOG, "a") as fh:
            fh.write(json.dumps({"tag": args.tag, "path": path,
                                 "src": os.path.abspath(args.src),
                                 "nvidia_smi": smi, "runs": runs}) + "\n")
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
