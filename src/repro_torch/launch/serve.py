"""Serving launcher of the port:
``python -m repro_torch.launch.serve --full --strategy strategy2``,
``--full --arch starcoder2-7b --strategy strategy2`` (LayerNorm and the
ungated gelu FFN with biases), ``--full --arch qwen1.5-4b``, ``qwen3-8b``
(the per-head q/k norm) or ``gemma-2b`` (head dim 256, GeGLU, a tied
head), ``--full --arch granite-moe-3b-a800m`` for the MoE family,
``--full --arch xlstm-1.3b`` for the xLSTM family, ``--full --arch
zamba2-7b`` for the hybrid family (Mamba2 with shared attention blocks),
or ``--full --arch qwen2-vl-7b`` for the vlm family, whose text requests
it serves as the dense family's (M-RoPE with equal id streams; the vision
frontend is a stub, reached through ``api.forward`` only).

Builds the model from a seeded ``torch.Generator``, quantizes it with the
port's compiler (``--strategy``: ``none`` (16-bit weights), ``dense``
W4A16, or the log-scale sparse ``strategy1``-``strategy3`` of paper Table
II; the xLSTM, MoE and hybrid families take ``none`` and ``dense``),
starts the continuous-batching
engine over a slot cache or, with ``--kv-layout paged``, a shared block
pool (refused for the xLSTM, which has no KV cache), and runs a synthetic
request workload (prompts of 4–32 tokens from
``numpy.random.default_rng(0)``; with ``--prefix-cache`` each is prefixed
by a shared ``--system-prompt-len``-token system prompt).  ``--spec``
turns on speculative decoding (``--spec-k`` drafts a row from the
``--drafter``), ``--prefix-cache`` prefix sharing on a paged pool; a
family or layout that cannot take one says so and runs without it.  The
lifecycle knobs: ``--deadline-s`` and ``--priority`` for every request,
``--max-preemptions`` (bounded, lossless preemption), ``--audit-every``,
and ``--chaos`` with its seed and rates (``serving/chaos.py``;
``--chaos-kill-after N`` kills the engine at the top of its Nth tick).
Durability: ``--snapshot-dir`` keeps atomic snapshots (``--snapshot-every``
ticks) and a write-ahead journal there, and ``--restore`` resumes a killed
run from it (in-flight requests resume, no new ones are submitted).  Runs
on ``cuda`` unless ``--device cpu`` is given; without ``--full`` it serves
the reduced ``-smoke`` configuration.
Prints the summary, the scheduler line, the speculation line, the
resilience line (preemptions, deadline misses, quarantined rows, audits,
the chaos counters), the durability line, the compile-cache line (keys,
hits and misses by kind: on the card each mixed,
decode or copy-on-write key is one captured CUDA graph), the pool and
prefix-cache lines of a paged run and each kernel's launch count.
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
from repro_torch.serving.chaos import ChaosConfig, ChaosMonkey, EngineKilled
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
    ap.add_argument("--spec", action="store_true",
                    help="speculative decoding: prompt-lookup drafts "
                         "verified through the mixed dispatch")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max draft tokens per verify row (with --spec)")
    ap.add_argument("--drafter", default="plookup",
                    help="draft proposer registry name (serving/draft.py)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="share cached prompt-prefix KV blocks across "
                         "requests (paged transformer families)")
    ap.add_argument("--system-prompt-len", type=int, default=24,
                    help="shared synthetic system-prompt tokens prepended "
                         "to every request (exercises --prefix-cache)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline in seconds after submit; "
                         "expired requests finish status=deadline_missed "
                         "(queued or mid-flight)")
    ap.add_argument("--priority", type=int, default=0,
                    help="priority of every synthetic request (higher "
                         "admits and keeps first under preemption)")
    ap.add_argument("--max-preemptions", type=int, default=0,
                    help="evict-and-requeue bound per request; 0 disables "
                         "preemption (stall-only admission).  Preemption "
                         "is lossless: the output folds into the prompt "
                         "and, with --prefix-cache, the victim's KV blocks "
                         "are donated so re-admission is a page-table copy")
    ap.add_argument("--audit-every", type=int, default=0,
                    help="run Engine.audit() (allocator partition, "
                         "reservation, page-table coherence) every N "
                         "ticks; 0 disables")
    ap.add_argument("--chaos", action="store_true",
                    help="attach a seeded ChaosMonkey (serving/chaos.py): "
                         "deterministic fault injection into this run")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--chaos-deny-rate", type=float, default=0.05,
                    help="P(reservation denied) per admission attempt")
    ap.add_argument("--chaos-preempt-rate", type=float, default=0.05,
                    help="P(forced preemption) per tick (needs "
                         "--max-preemptions > 0)")
    ap.add_argument("--chaos-nan-rate", type=float, default=0.01,
                    help="P(logits row -> NaN) per advancing row; faulted "
                         "rows quarantine with status=error")
    ap.add_argument("--chaos-kill-after", type=int, default=None,
                    help="simulated process death at the top of the Nth "
                         "tick (recover with --restore)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="durable state root: atomic point-in-time engine "
                         "snapshots plus a write-ahead request journal, "
                         "fsync'd once per tick")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="snapshot every N ticks (0 = only the baseline "
                         "snapshot at startup; needs --snapshot-dir)")
    ap.add_argument("--restore", action="store_true",
                    help="recover the engine from --snapshot-dir (latest "
                         "complete snapshot + journal replay) instead of "
                         "starting fresh; in-flight requests resume and no "
                         "new synthetic requests are submitted")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    if args.restore and not args.snapshot_dir:
        ap.error("--restore requires --snapshot-dir")

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain "
                         "PyTorch path")
    kv = dict(kv_layout=args.kv_layout, kv_block_size=args.kv_block_size,
              kv_pool_blocks=args.kv_pool_blocks)
    cfg = (get_config(args.arch, **kv) if args.full
           else get_smoke_config(args.arch, **kv))
    if cfg.family == "audio":
        raise SystemExit(f"{args.arch} serves requests with audio frames: "
                         "the launcher's audio workload comes in a later "
                         "slice (serve it through Engine with "
                         "Request(frames=...))")
    if cfg.family == "ssm" and args.kv_layout == "paged":
        raise SystemExit(f"{args.arch} keeps a recurrent state and no KV "
                         "cache: --kv-layout paged does not apply")
    if (cfg.family in ("ssm", "moe", "hybrid")
            and args.strategy not in ("none", "dense")):
        raise SystemExit(f"{args.arch} is served with --strategy none or "
                         "dense (the log-scale sparse strategies are ported "
                         "for the dense family only)")
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = quantize_model(api.init_params(cfg, gen), args.strategy)
    print(f"arch={cfg.name} packed={quantized_bytes(params) / 1e6:.1f} MB "
          f"strategy={args.strategy} device={args.device}")

    chaos = (ChaosMonkey(ChaosConfig(
        seed=args.chaos_seed, deny_rate=args.chaos_deny_rate,
        preempt_rate=args.chaos_preempt_rate,
        nan_rate=args.chaos_nan_rate, kill_after=args.chaos_kill_after))
        if args.chaos else None)
    if args.restore:
        engine = Engine.restore(args.snapshot_dir, params, chaos=chaos,
                                device=args.device)
        d = engine.durability_stats()
        live = len(engine._queue) + sum(s.req is not None
                                        for s in engine._slots)
        print(f"restored from {args.snapshot_dir} (epoch {d['epoch']}): "
              f"{live} live requests resume, {d['restored_terminal']} "
              f"already terminal replayed from the journal")
    else:
        engine = Engine(cfg, params, batch_size=args.batch,
                        max_len=args.max_len,
                        spec_k=args.spec_k if args.spec else 0,
                        drafter=args.drafter, prefix_cache=args.prefix_cache,
                        max_preemptions=args.max_preemptions,
                        audit_every=args.audit_every, chaos=chaos,
                        snapshot_dir=args.snapshot_dir,
                        snapshot_every=args.snapshot_every,
                        device=args.device)
    if args.spec and not engine.spec_k:
        print(f"speculation requested but family {cfg.family!r} has no "
              "rewindable sequence dimension — plain decode fallback")
    if args.prefix_cache and not engine.prefix_sharing:
        print(f"prefix cache requested but family {cfg.family!r} / layout "
              f"{cfg.kv_layout!r} cannot share KV blocks — running without")
    if not args.restore:
        rng = np.random.default_rng(0)
        system = rng.integers(
            0, cfg.vocab_size,
            args.system_prompt_len if args.prefix_cache else 0)
        for rid in range(args.requests):
            user = rng.integers(0, cfg.vocab_size, int(rng.integers(4, 32)))
            engine.submit(Request(
                rid=rid,
                prompt=np.concatenate([system, user]).astype(np.int32),
                max_new_tokens=args.max_new_tokens, priority=args.priority,
                deadline_s=args.deadline_s))
    launches.clear()
    try:
        done = engine.run()
    except EngineKilled as e:
        print(f"killed at tick {engine.steps + 1}: {e}"
              + (f" — recover with --restore --snapshot-dir "
                 f"{args.snapshot_dir}" if args.snapshot_dir else ""))
        return
    if not done.drained:
        print(f"NOT drained: truncated={done.truncated} "
              f"stalled={done.stalled} in_flight={done.in_flight} "
              f"queued={done.queued}")
    print("summary:", Engine.summarize(done))
    r = engine.resilience_stats()
    print(f"resilience: {r['preemptions']} preemptions "
          f"(bound {r['max_preemptions']}/req), "
          f"{r['deadline_misses']} deadline misses, "
          f"{r['row_faults']} quarantined rows, {r['audits']} audits"
          + (f", chaos={r['chaos']}" if chaos is not None else ""))
    if args.snapshot_dir:
        d = engine.durability_stats()
        print(f"durability: {d['snapshots_taken']} snapshots under "
              f"{d['snapshot_dir']} (epoch {d['epoch']}, every "
              f"{d['snapshot_every'] or 'startup-only'} ticks), "
              f"journal={'on' if d['journal'] else 'off'} — recover with "
              f"--restore --snapshot-dir {d['snapshot_dir']}")
    print(f"scheduler: {engine.steps} ticks, {engine.dispatches} dispatches "
          f"(1 per tick, {engine.mixed_ticks} mixed), slot occupancy "
          f"{engine.slot_occupancy:.2f}")
    if engine.spec_k:
        s = engine.spec_stats()
        print(f"speculation: K={s['spec_k']} drafter={args.drafter} — "
              f"{s['accepted_tokens']}/{s['draft_tokens']} drafts accepted "
              f"({s['acceptance_rate']:.2f}), "
              f"{s['accepted_per_dispatch']:.2f} accepted tokens/dispatch "
              f"over {s['spec_ticks']} verify ticks, "
              f"{s['rewinds']} rewinds")
    print(f"compile cache: {sorted(engine.cache_compiles.keys())} "
          f"({engine.cache_compiles.hits} hits, "
          f"misses by kind {engine.cache_compiles.misses_by_name})")
    if engine.paged:
        print(f"paged KV: {engine.pool_blocks} blocks x "
              f"{engine.block_size} tokens, peak resident "
              f"{engine.peak_resident_tokens} tokens, peak "
              f"{engine.peak_pool_blocks} blocks in use, "
              f"{engine.admission_stalls} admission stalls, "
              f"pool {engine.pool_stats()}")
    if engine.prefix_sharing:
        p = engine.prefix_stats()
        print(f"prefix cache: {p['hits']} hits "
              f"({p['hit_tokens']} prompt tokens reused), "
              f"{p['shared_blocks']} shared blocks, "
              f"{p['cow_copies']} CoW copies, "
              f"{p['cached_blocks']} cached, {p['evictions']} evicted")
    print(f"kernel launches: {dict(sorted(launches.items()))}")


if __name__ == "__main__":
    main()
