"""Build and load the hand-written CUDA kernels (route b: nvcc + ctypes).

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

The library lands in ``kernels/build/`` (git-ignored) the first time a
kernel is used; the file name carries a hash of the sources and flags, so
an edited source rebuilds and an unchanged one loads at once.  Nothing here
runs at import time: the CPU tests import every module and never build.

``launches`` counts kernel launches by kernel name.  Each wrapper adds one
exactly where it launches its kernel, so a caller can reset the counter,
drive a path and read which kernels that path went through.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_SOURCES = ("w4a16_matmul", "ffn_fused", "decode_flash", "rmsnorm",
                  "sparse_w4a16", "ffn_fused_sparse", "flash_attention",
                  "slstm_scan", "mlstm_cell", "dense_matmul",
                  "ffn_fused_dense", "layernorm", "kv_write", "moe_route",
                  "moe_experts", "mamba_cell", "flash_attention_bwd",
                  "rmsnorm_bwd", "flash_attention_bwd_sync",
                  "rmsnorm_bwd_serial")

launches: "collections.Counter[str]" = collections.Counter()

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "build on the machine with the card")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=KERNEL_SOURCES) -> dict[str, str]:
    """Compile the named kernels that are not built yet, one ``nvcc`` each,
    all started together.  Returns each kernel's ``-Xptxas -v`` report
    (registers, shared memory, spills); raises if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    reports = {}
    for name in names:
        log = _lib_path(name).with_suffix(".log")
        reports[name] = log.read_text() if log.exists() else ""
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build((name,))
            lib = ctypes.CDLL(str(path))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def prepare(names=KERNEL_SOURCES) -> None:
    """Build and load the named libraries and run their one-time host
    calls (kernel 8's cluster attributes and occupancy query, the
    layernorm bodies' shared-memory opt-in, the route kernels' cluster and
    shared-memory attributes, the Mamba2 step's arrival counters), so that a
    CUDA graph capture that follows starts no ``nvcc``, loads no library
    and makes no such call: inside a capture each wrapper only launches."""
    build(names)
    for name in names:
        library(name)
    if "slstm_scan" in names:
        from repro_torch.kernels import slstm_scan
        for dh in range(slstm_scan.CLUSTER_UNITS,
                        slstm_scan.MAX_CLUSTER * slstm_scan.CLUSTER_UNITS + 1,
                        slstm_scan.CLUSTER_UNITS):
            slstm_scan.cluster_capacity(dh)
    if "layernorm" in names:
        from repro_torch.kernels import layernorm
        layernorm.prepare()
    if "moe_route" in names:
        from repro_torch.kernels import moe_route
        moe_route.prepare()
    if "mamba_cell" in names:
        from repro_torch.kernels import mamba_cell
        mamba_cell.prepare()


def function(name: str, symbol: str, argtypes: list):
    """C entry point ``symbol`` of library ``name`` with its argtypes set
    (pointers and the stream as ``c_void_p``, sizes as ``c_int``)."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn


def check(name: str, rc: int) -> None:
    """Raise if a launch from library ``name`` returned a nonzero
    ``cudaGetLastError()``."""
    if rc != 0:
        msg = library(name).repro_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
