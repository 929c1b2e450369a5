"""Serving launcher of the port:
``python -m repro_torch.launch.serve --full --strategy strategy2``,
``--full --arch starcoder2-7b --strategy strategy2`` (LayerNorm and the
ungated gelu FFN with biases), or ``--full --arch xlstm-1.3b`` for the
xLSTM family.

Builds the model from a seeded ``torch.Generator``, quantizes it with the
port's compiler (``--strategy``: ``none`` (16-bit weights), ``dense``
W4A16, or the log-scale sparse ``strategy1``-``strategy3`` of paper Table
II; the xLSTM takes ``none`` and ``dense``), starts the continuous-batching
engine over a slot cache or, with ``--kv-layout paged``, a shared block
pool (refused for the xLSTM, which has no KV cache), and runs a synthetic
request workload (prompts of 4–32 tokens from
``numpy.random.default_rng(0)``).  Runs on ``cuda`` unless ``--device cpu``
is given; without ``--full`` it serves the reduced ``-smoke``
configuration.
Prints the summary, the scheduler line, the compile-cache line (keys,
hits and misses by kind: on the card each mixed or decode key is one
captured CUDA graph), the pool line of a paged run and each kernel's launch
count.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.compiler import (
    STRATEGIES, quantize_model, quantized_bytes)
from repro_torch.kernels._build import launches
from repro_torch.models import api
from repro_torch.serving.engine import Engine, Request


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen-7b")
    ap.add_argument("--strategy", default="dense", choices=STRATEGIES)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--kv-layout", default="slot", choices=["slot", "paged"],
                    help="paged = shared block pool + per-slot page tables")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="tokens per KV page (paged layout)")
    ap.add_argument("--kv-pool-blocks", type=int, default=0,
                    help="shared-pool blocks (0 = batch * pages per slot)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain "
                         "PyTorch path")
    kv = dict(kv_layout=args.kv_layout, kv_block_size=args.kv_block_size,
              kv_pool_blocks=args.kv_pool_blocks)
    cfg = (get_config(args.arch, **kv) if args.full
           else get_smoke_config(args.arch, **kv))
    if cfg.family == "ssm" and args.kv_layout == "paged":
        raise SystemExit(f"{args.arch} keeps a recurrent state and no KV "
                         "cache: --kv-layout paged does not apply")
    if cfg.family == "ssm" and args.strategy not in ("none", "dense"):
        raise SystemExit(f"{args.arch} is served with --strategy none or "
                         "dense (the log-scale sparse strategies are ported "
                         "for the dense family only)")
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = quantize_model(api.init_params(cfg, gen), args.strategy)
    print(f"arch={cfg.name} packed={quantized_bytes(params) / 1e6:.1f} MB "
          f"strategy={args.strategy} device={args.device}")

    engine = Engine(cfg, params, batch_size=args.batch, max_len=args.max_len,
                    device=args.device)
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(4, 32)))
        engine.submit(Request(rid=rid, prompt=prompt.astype(np.int32),
                              max_new_tokens=args.max_new_tokens))
    launches.clear()
    done = engine.run()
    if not done.drained:
        print(f"NOT drained: truncated={done.truncated} "
              f"in_flight={done.in_flight} queued={done.queued}")
    print("summary:", Engine.summarize(done))
    print(f"scheduler: {engine.steps} ticks, {engine.dispatches} dispatches "
          f"(1 per tick, {engine.mixed_ticks} mixed), slot occupancy "
          f"{engine.slot_occupancy:.2f}")
    print(f"compile cache: {sorted(engine.cache_compiles.keys())} "
          f"({engine.cache_compiles.hits} hits, "
          f"misses by kind {engine.cache_compiles.misses_by_name})")
    if engine.paged:
        print(f"paged KV: {engine.pool_blocks} blocks x "
              f"{engine.block_size} tokens, peak resident "
              f"{engine.peak_resident_tokens} tokens, "
              f"{engine.admission_stalls} admission stalls, "
              f"pool {engine.pool_stats()}")
    print(f"kernel launches: {dict(sorted(launches.items()))}")


if __name__ == "__main__":
    main()
