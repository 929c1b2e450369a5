#!/usr/bin/env python3
"""Times kernel 8 (the sLSTM scan), the mLSTM decode cell and xlstm-1.3b's
bf16 ``forward`` with the port found under ``--src``, and compares their
outputs with another tree's run, so two trees can be held against each
other on one card:

    python3 tools/xlstm_ab.py --src checkout/parent/src --tag parent
    python3 tools/xlstm_ab.py --tag change --compare parent

Run the trees in turns (parent, change, change, parent) in one command on
one card.  Kernel times are CUDA events after an L2 flush
(``chip_smoke.Timer``): the scan at xlstm-1.3b's 4 heads of 512 with bf16
R, one decode step (B=4, L=1, from a lived-in state, row 2 inactive) and a
forward's B=2 x L=512; the cell at B=4, 4 heads of 1024, bf16.  The
forward: xlstm-1.3b at full width and depth ("dense" W4A16, random weights
from seed 0), B=2 x 512 tokens, host clock around ``api.forward`` and a
synchronize, one warm-up and three timed runs.  Every input comes from a
fixed seed, so both trees see the same ones.

Each run writes a digest of every output (the scan's hs and state, the
cell's y, n', m' and C', the forward's logits) and the cell's y itself.
The cell is timed with every row live, as the served path runs it.
With ``--compare TAG`` the run holds its outputs against the last run
tagged TAG: the scan's and the cell's state bitwise, y bitwise or within
``Y_TOL`` of the largest |y|; the logits' equality is recorded.  One JSON
line per run goes to ``chiprun_out/xlstm_ab.jsonl``.  Needs one card;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out")
LOG = os.path.join(OUT, "xlstm_ab.jsonl")
Y_TOL = 1e-2        # the cell's bf16 tolerance in chip_smoke.py phase 3
BITWISE = ("scan decode", "scan forward", "cell n", "cell m", "cell C")


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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--compare", default=None,
                    help="tag of an earlier run to hold the outputs against")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs             # Timer, build_model; puts ROOT/src
    sys.path.insert(0, os.path.abspath(args.src))   # ... behind --src
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs the card")
        return 1
    import repro_torch
    from repro_torch.kernels import _build, ops
    from repro_torch.models import api
    print(f"[{args.tag}] repro_torch from {repro_torch.__file__}",
          flush=True)
    _build.build(("slstm_scan", "mlstm_cell", "w4a16_matmul", "rmsnorm",
                  "dense_matmul"))
    timer = cs.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(21)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    out = {"tag": args.tag, "src": os.path.abspath(args.src),
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi("name,power.limit"), "ms": {},
           "digest": {}}

    def keep(name, *ts):
        """Digest outputs before any timed launch can touch them."""
        hsh = hashlib.sha1()
        for t in ts:
            hsh.update(digest(t).encode())
        out["digest"][name] = hsh.hexdigest()

    # kernel 8 at xlstm-1.3b's sLSTM: 4 heads of 512, bf16 R
    h, dh = cs.XLSTM_H, cs.XLSTM_SLSTM_DH
    r = (randn(h, dh, 4 * dh) * 0.02).to(torch.bfloat16)
    bias = randn(h, 4 * dh) * 0.1
    for what, b, L in (("scan decode", 4, 1), ("scan forward", 2, 512)):
        gx = randn(b, L, h, 4 * dh)
        st = (randn(b, h, dh), randn(b, h, dh).abs() + 0.5, randn(b, h, dh),
              randn(b, h, dh))
        active = torch.tensor([True, True, False, True][:b], device="cuda")
        mine = tuple(t.clone() for t in st)
        hs = ops.slstm_scan(gx, r, bias, mine, active=active)
        keep(what, hs, *mine)
        scratch = tuple(t.clone() for t in st)
        out["ms"][f"{what} B={b} L={L}"] = timer.ms(
            lambda: ops.slstm_scan(gx, r, bias, scratch, active=active),
            20 if L == 1 else 5)

    # the mLSTM cell: B=4, 4 heads of 1024, bf16
    b, dh = 4, cs.XLSTM_MLSTM_DH
    di = h * dh
    xp = randn(b, di, dtype=torch.bfloat16)
    q, k, v = (randn(b, h, dh, dtype=torch.bfloat16) for _ in range(3))
    w_i, w_f = ((randn(di, h) * 0.01).to(torch.bfloat16) for _ in range(2))
    b_i = randn(h) * 0.1
    b_f = 3.0 + randn(h) * 0.1
    C0 = randn(b, h, dh, dh) * 0.1
    n0 = randn(b, h, dh).abs() + 0.5
    m0 = randn(b, h)
    active = torch.tensor([True, False, True, True], device="cuda")
    args_ = (xp, q, k, v, w_i, w_f, b_i, b_f)
    C = C0.clone()
    y, n1, m1 = ops.mlstm_cell(*args_, C, n0, m0, active=active)
    for name, t in (("cell y", y), ("cell n", n1), ("cell m", m1),
                    ("cell C", C)):
        keep(name, t)
    out["ms"]["cell B=4 h=4 dh=1024"] = timer.ms(     # every row live
        lambda: ops.mlstm_cell(*args_, C, n0, m0), 20)
    del C, C0, timer
    torch.cuda.empty_cache()

    # xlstm-1.3b's bf16 forward at B=2 x 512
    cfg, params = cs.build_model(torch, "xlstm-1.3b", "dense")
    toks = torch.tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 512)), device="cuda")
    runs = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = api.forward(cfg, params, {"tokens": toks})
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    out["forward_s"] = runs[1:]
    keep("forward logits", logits)
    os.makedirs(OUT, exist_ok=True)
    torch.save(y.cpu(), os.path.join(OUT, f"xlstm_ab_{args.tag}_y.pt"))

    ok = True
    if args.compare:
        other = last_run(args.compare)
        same = {k: other["digest"].get(k) == d
                for k, d in out["digest"].items()}
        out["bitwise_equal_to"] = {"tag": args.compare, **same}
        y_other = torch.load(os.path.join(
            OUT, f"xlstm_ab_{args.compare}_y.pt"))
        y_rel = float((y.cpu() - y_other).abs().max()
                      / y_other.abs().max().clamp_min(1e-30))
        out["cell_y_rel_err"] = y_rel
        ok = all(same[k] for k in BITWISE) and y_rel <= Y_TOL
        out["ok"] = ok
    print(json.dumps(out), flush=True)
    with open(LOG, "a") as fh:
        fh.write(json.dumps(out) + "\n")
    if not ok:
        print(f"FAIL: outputs differ from the run tagged {args.compare}: "
              f"{out['bitwise_equal_to']}, y rel {out['cell_y_rel_err']}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
