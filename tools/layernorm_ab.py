#!/usr/bin/env python3
"""Holds the port's ``layernorm`` and ``add_layernorm`` kernels bitwise
against an earlier version of ``csrc/layernorm.cu`` on one card, and times
the two side by side:

    git show <rev>:src/repro_torch/kernels/csrc/layernorm.cu \\
        > checkout/layernorm_parent.cu
    python3 tools/layernorm_ab.py --parent checkout/layernorm_parent.cu

The earlier source must export ``layernorm_launch(x, gamma, beta, out,
rows, d, eps, dtype, stream)``.  It is built with the package's nvcc flags,
and so is a probe: the current source with its second pass rounded as a
product then a sum (no FMA), which tells whether the earlier kernel's
``sum += c * c`` was contracted.  At starcoder2-7b's width (4608), bf16 and
f32, 4, 64, 256 and 300 rows (x of mean 1 and spread 3): ``layernorm`` and
``add_layernorm``'s n against the earlier kernel on x (on x + h), bitwise,
and against the probe.  Times (CUDA events after an L2 flush,
``chip_smoke.Timer``) of the earlier and the current ``layernorm`` at 4 and
256 bf16 rows, in turns.  The card's name and power limit, then one JSON
line; details to ``chiprun_out/layernorm_ab.json``.  Exits 1 unless every
case is bitwise.  Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out")
ROWS = (4, 64, 256, 300)
D = 4608
# the current second pass, and the probe's: a product, then a sum
FMA_PASS = "sq = __fmaf_rn(c, c, sq);"
MUL_ADD_PASS = "sq = __fadd_rn(sq, __fmul_rn(c, c));"


def build(src_text: str, name: str, tmp: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    src = os.path.join(tmp, f"{name}.cu")
    with open(src, "w") as fh:
        fh.write(src_text)
    lib = os.path.join(tmp, f"lib{name}.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                    "-I", str(_build.CSRC), "-o", lib, src], check=True,
                   capture_output=True, text=True)
    out = ctypes.CDLL(lib)
    out.layernorm_launch.argtypes = ([ctypes.c_void_p] * 4
                                     + [ctypes.c_int] * 2 + [ctypes.c_float]
                                     + [ctypes.c_int] + [ctypes.c_void_p])
    out.layernorm_launch.restype = ctypes.c_int
    return out


def ffma_count(lib_path: str) -> int | None:
    """FFMA instructions in the library's SASS (None without cuobjdump)."""
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True).stdout
    return sum("FFMA" in ln for ln in sass.splitlines())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="the earlier csrc/layernorm.cu")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs             # Timer, bitwise; puts ROOT/src
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs the card")
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.layernorm import (
        add_layernorm_cuda, layernorm_cuda)
    from repro_torch.kernels.w4a16_matmul import DTYPE_CODES
    _build.build(("layernorm",))
    current = (_build.CSRC / "layernorm.cu").read_text()
    if FMA_PASS not in current:
        print(f"FAIL: {FMA_PASS!r} not in the current source")
        return 1
    tmp = str(_build.BUILD_DIR / "layernorm_ab")
    os.makedirs(tmp, exist_ok=True)
    with open(args.parent) as fh:
        parent = build(fh.read(), "parent", tmp)
    probe = build(current.replace(FMA_PASS, MUL_ADD_PASS), "probe", tmp)
    smi = cs.nvidia_smi("name,power.limit")
    print(f"card: {smi}", flush=True)

    def launch(lib, x, g, b):
        out = torch.empty_like(x)
        rc = lib.layernorm_launch(x.data_ptr(), g.data_ptr(), b.data_ptr(),
                                  out.data_ptr(), x.shape[0], x.shape[1],
                                  1e-5, DTYPE_CODES[x.dtype],
                                  _build.stream_ptr(x.device))
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out

    gen = torch.Generator(device="cuda").manual_seed(25)
    cases, ok = [], True
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for rows in ROWS:
            x = (3 * torch.randn(rows, D, generator=gen, device="cuda") + 1
                 ).to(dtype)
            h = torch.randn(rows, D, generator=gen, device="cuda").to(dtype)
            g = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")
                 ).to(dtype)
            b = (0.1 * torch.randn(D, generator=gen, device="cuda")).to(dtype)
            new = layernorm_cuda(x, g, b)
            _, fused = add_layernorm_cuda(x, h, g, b, keep_sum=False)
            old, old_sum = launch(parent, x, g, b), launch(parent, x + h, g, b)
            alt = launch(probe, x, g, b)
            torch.cuda.synchronize()
            case = {"dtype": dname, "rows": rows, "d": D,
                    "layernorm_bitwise_parent": cs.bitwise(torch, new, old),
                    "add_layernorm_bitwise_parent_on_x_plus_h":
                        cs.bitwise(torch, fused, old_sum),
                    "parent_bitwise_no_fma_probe":
                        cs.bitwise(torch, old, alt),
                    "elements_differing_from_probe":
                        int((old.view(torch.uint8) != alt.view(torch.uint8))
                            .sum())}
            ok &= (case["layernorm_bitwise_parent"]
                   and case["add_layernorm_bitwise_parent_on_x_plus_h"])
            cases.append(case)
            print(json.dumps(case), flush=True)
    timer = cs.Timer(torch)
    times = {}
    for rows in (4, 256):
        x = torch.randn(rows, D, generator=gen, device="cuda").to(
            torch.bfloat16)
        g = torch.ones(D, device="cuda", dtype=torch.bfloat16)
        b = torch.zeros(D, device="cuda", dtype=torch.bfloat16)
        runs = {"parent": [], "change": []}
        for turn in ("parent", "change", "change", "parent"):
            fn = ((lambda: launch(parent, x, g, b)) if turn == "parent"
                  else (lambda: layernorm_cuda(x, g, b)))
            runs[turn].append(timer.ms(fn, 50))
        times[f"bf16 {rows}x{D}"] = runs
        print(f"layernorm bf16 {rows}x{D}: parent {runs['parent']} ms, "
              f"change {runs['change']} ms", flush=True)
    result = {"nvidia_smi": smi, "all_bitwise": ok,
              "parent_ffma": ffma_count(os.path.join(tmp, "libparent.so")),
              "probe_ffma": ffma_count(os.path.join(tmp, "libprobe.so")),
              "cases": cases, "ms": times}
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "layernorm_ab.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps({k: result[k] for k in ("all_bitwise", "parent_ffma",
                                             "probe_ffma")}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
