#!/usr/bin/env python3
"""Times the grouped MoE expert kernels (``moe_gate_up_w4a16``,
``moe_down_w4a16``) with the port found under ``--src``, and holds their
outputs against another tree's run, so two trees can be compared on one
card:

    python3 tools/moe_ab.py --src checkout/parent/src --tag parent
    python3 tools/moe_ab.py --tag change --compare parent

Run the trees in turns (parent, change, change, parent) in one command on
one card.  Shapes (``SHAPES``): granite-moe-3b-a800m's experts (d 1536,
d_ff 512, 40 experts, top-8, 32-row groups) at a decode tick (T = 4, four
groups of one), a 4 x 16 and a 4 x 64 chunk, and mixtral-8x22b's (d 6144, d_ff
16384, 8 experts, top-2, 128-row groups) at T = 4; random weights,
activations and router logits from fixed seeds, so both trees see the
same inputs, and both trees' route kernel (the same bits) lays the rows
out.  Kernel times are CUDA events after an L2 flush
(``chip_smoke.Timer``), each beside its byte bound.  With ``--sweep``, on
a tree whose wrappers take ``tile`` and ``blocks``, the kernels are also
timed in every tile configuration and on a grid of one block an SM, and
their rows held bitwise against the launcher's choice.

Each run writes a SHA-1 of every kept row of the hidden and of y per
shape; with ``--compare TAG`` they are held bitwise against the last run
tagged TAG.  ``--trace`` then serves granite-moe-dense (full width and
depth, the dropless factor, random weights from seed 0) once on one
engine and traces its replayed decode-4 and widest mixed tick
(``chip_smoke.trace_ticks``), recording each MoE kernel's in-graph ms and
whether the trace saw every launch.
One JSON line per run goes to ``chiprun_out/moe_ab.jsonl``.  Needs one
card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out")
LOG = os.path.join(OUT, "moe_ab.jsonl")
# (name, model, B, S): the MoE cases of chip_smoke.py phase 3, dropless,
# and a 4 x 16 chunk (the served T = 64 mixed key: ~13 rows an expert)
SHAPES = (("granite T=4", "granite", 4, 1), ("granite 4x16", "granite", 4, 16),
          ("granite 4x64", "granite", 4, 64), ("mixtral T=4", "mixtral", 4, 1))


def digest(t) -> str:
    """SHA-1 of a tensor's bytes (any dtype, bf16 included)."""
    import torch
    raw = t.detach().contiguous().view(-1).view(torch.uint8).cpu()
    return hashlib.sha1(raw.numpy().tobytes()).hexdigest()


def last_run(tag: str) -> dict:
    runs = []
    if os.path.exists(LOG):
        with open(LOG) as fh:
            runs = [json.loads(ln) for ln in fh if ln.strip()]
    runs = [r for r in runs if r.get("tag") == tag]
    if not runs:
        raise SystemExit(f"FAIL: no run tagged {tag!r} in {LOG}")
    return runs[-1]


def trace_granite(torch, cs) -> dict:
    """granite-moe-dense served once (captures), then its decode and widest
    mixed tick traced; the replays' MoE kernel ms and busy ms."""
    import numpy as np
    from repro_torch.serving.engine import Engine, Request
    path = "granite-moe-dense"
    cfg, params = cs.build_model(torch, "granite-moe-3b-a800m", "dense",
                                 **cs.MODEL_OVERRIDES[path])
    engine = Engine(cfg, params, batch_size=4, max_len=cs.SERVE_MAX_LEN,
                    chunk_size=64, device="cuda")
    reqs = [Request(rid=i, prompt=p.astype(np.int32),
                    max_new_tokens=cs.SERVE_NEW_TOKENS)
            for i, p in enumerate(cs.workload(cfg))]
    for r in reqs:
        engine.submit(r)
    engine.run()
    streams = json.dumps([r.output for r in reqs]).encode()
    found = {}
    cs.trace_ticks(torch, engine, params, found, path, strict=False)
    out = {"streams_sha1": hashlib.sha1(streams).hexdigest()}
    for key, row in found["traces"][path].items():
        if key.endswith("-replay"):
            out[key] = {"device_busy_ms": row["device_busy_ms"],
                        "wall_ms": row["wall_ms"],
                        "moe_ms": row["moe_ms"],
                        "moe_expected": row["moe_expected"],
                        "moe_complete": row["moe_complete"]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--compare", default=None,
                    help="tag of an earlier run to hold the outputs against")
    ap.add_argument("--trace", action="store_true",
                    help="also trace granite-moe-dense's replayed ticks")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--sweep", action="store_true",
                    help="also time every tile configuration and a grid of "
                    "one block an SM (trees whose wrappers take them)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs             # Timer, bounds, models; puts ROOT/src
    sys.path.insert(0, os.path.abspath(args.src))   # ... behind --src
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs the card")
        return 1
    import repro_torch
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import moe_experts as mx
    from repro_torch.kernels.moe_route import moe_route_cuda
    print(f"[{args.tag}] repro_torch from {repro_torch.__file__}",
          flush=True)
    _build.build(("moe_experts", "moe_route", "dense_matmul", "w4a16_matmul",
                  "ffn_fused", "rmsnorm", "decode_flash", "kv_write"))
    sweeps = args.sweep and "blocks" in inspect.signature(
        mx.moe_gate_up_cuda).parameters
    timer = cs.Timer(torch)
    out = {"tag": args.tag, "src": os.path.abspath(args.src),
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi("name,power.limit"), "ms": {},
           "bound_ms": {}, "digest": {}, "rel_err": {}}
    weights = {}
    for name, model, b, s in SHAPES:
        d, f, e, k, group = cs.MOE_SHAPES[model]
        if model not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            g = torch.Generator(device="cuda").manual_seed(29)
            weights[model] = (g, cs.moe_weights(
                torch, lambda *sh, dtype=torch.float32: torch.randn(
                    sh, generator=g, device="cuda").to(dtype), d, f, e,
                group))
        g, (router, gate, up, down) = weights[model]
        gx = torch.Generator(device="cuda").manual_seed(b * s + e)
        x = torch.randn(b * s, d, generator=gx,
                        device="cuda").to(torch.bfloat16)
        cap = max(k, s)
        r = moe_route_cuda(ops.dense_matmul(x, router.to(torch.bfloat16)), s,
                           k, cap)
        kept = int(r.counts.sum())
        active = int((r.counts > 0).sum())
        h = mx.moe_gate_up_cuda(x, r, gate, up, "swiglu")
        y = mx.moe_down_cuda(h, r, down)
        torch.cuda.synchronize()
        out["digest"][f"{name} hidden"] = digest(h[:kept])
        out["digest"][f"{name} y"] = digest(y[:kept])
        for what, got, want in (
                ("hidden", h, mx.moe_gate_up_torch(x, r, gate, up, "swiglu")),
                ("y", y, mx.moe_down_torch(h, r, down))):
            err = (got[:kept].float() - want[:kept].float()).abs().max()
            out["rel_err"][f"{name} {what}"] = float(
                err / want[:kept].float().abs().max())
        w_gu = active * (gate.nbytes_model + up.nbytes_model) / e
        w_dn = active * down.nbytes_model / e
        out["bound_ms"][f"{name} gate/up"] = cs.bound(
            x.numel() * 2 + w_gu + kept * f * 2 + kept * 4,
            2 * 2 * kept * d * f, "bfloat16")[0]
        out["bound_ms"][f"{name} down"] = cs.bound(
            kept * f * 2 + w_dn + kept * d * 2, 2 * kept * f * d,
            "bfloat16")[0]
        runs = [("", {})] + ([(" 132 blocks", dict(blocks=132))] if sweeps
                             else [])
        sweep = ({"gate/up": mx.GATE_UP_TILES, "down": mx.DOWN_TILES}
                 if sweeps else {"gate/up": {}, "down": {}})
        for kernel, call, kept_rows in (
                ("gate/up", lambda **kw: mx.moe_gate_up_cuda(
                    x, r, gate, up, "swiglu", **kw), "hidden"),
                ("down", lambda **kw: mx.moe_down_cuda(h, r, down, **kw),
                 "y")):
            for label, kw in runs + [(f" tile {t}", dict(tile=t))
                                     for t in sweep[kernel]]:
                if kw:      # every variant's rows bitwise the default's
                    out["digest"][f"{name} {kept_rows}{label}"] = digest(
                        call(**kw)[:kept])
                out["ms"][f"{name} {kernel}{label}"] = timer.ms(
                    lambda: call(**kw), args.iters)
        print(f"[{args.tag}] {name}: {kept} rows on {active} of {e} experts; "
              + ", ".join(f"{key[len(name) + 1:]} {v:.4f} ms"
                          for key, v in out["ms"].items()
                          if key.startswith(name)), flush=True)
        del h, y, x, r
    weights.clear()
    del timer
    torch.cuda.empty_cache()
    if args.trace:
        out["trace"] = trace_granite(torch, cs)
        for key, row in out["trace"].items():
            if isinstance(row, dict):
                print(f"[{args.tag}] {key}: busy {row['device_busy_ms']:.3f} "
                      "ms; " + ", ".join(
                          f"{k} {ms:.4f} ms ({n} of {row['moe_expected']})"
                          for k, (ms, n) in row["moe_ms"].items())
                      + ("" if row["moe_complete"] else
                         "; the trace lost launches: an undercount"),
                      flush=True)

    ok = all(v <= 1e-2 for v in out["rel_err"].values())
    for key, d in out["digest"].items():
        name, what = key.split(" hidden" if " hidden" in key else " y")[0], (
            "hidden" if " hidden" in key else "y")
        ok = ok and d == out["digest"][f"{name} {what}"]
    if args.compare:
        other = last_run(args.compare)
        same = {key: other["digest"].get(key) == d
                for key, d in out["digest"].items()
                if key.endswith((" hidden", " y"))}
        out["bitwise_equal_to"] = {"tag": args.compare, **same}
        ok = ok and all(same.values())
    out["ok"] = ok
    os.makedirs(OUT, exist_ok=True)
    print(json.dumps(out), flush=True)
    with open(LOG, "a") as fh:
        fh.write(json.dumps(out) + "\n")
    if not ok:
        print(f"FAIL: [{args.tag}] rel errors {out['rel_err']}, compared "
              f"{out.get('bitwise_equal_to')}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
