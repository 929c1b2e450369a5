"""Training launcher of the port: ``python -m repro_torch.launch.train --arch
qwen3-8b ...`` (port of ``repro/launch/train.py``, with its flags).

Builds f32 master weights from a seeded ``torch.Generator``, and trains
them with AdamW on a cosine schedule (peak 3e-4, 20 warmup steps) over the
synthetic token stream (``data/pipeline.py``, prefetched on a thread),
inside the fault-tolerant loop: resume from the newest checkpoint in
``--ckpt-dir``, a checkpoint every ``--ckpt-every`` steps and on SIGTERM
(``PreemptionGuard``), and a straggler watchdog.  Prints each step's loss.

Runs on ``cuda`` unless ``--device cpu`` is given.  Without ``--full`` it
trains the reduced ``-smoke`` configuration: in f32 on the CPU, as the
reference does, and in bfloat16 on the card, the type of the backward
kernels (the masters are f32 either way).  The dense family trains; the
others raise (ROADMAP queue 1, item 6a).  ``--full`` trains the published
configuration, which must fit the card: qwen3-8b's 8.2 B parameters need
about 164 GB of f32 masters, moments and gradients, more than one H100
holds.  ``--model-parallel`` above 1 is refused (sharded training: ROADMAP
queue 1, item 7).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticTokens
from repro_torch.optim.adamw import AdamW, cosine_schedule, tree_leaves
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import PreemptionGuard, StragglerWatchdog
from repro_torch.train.trainer import init_train_state, make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--full", action="store_true",
                    help="the published configuration (must fit the card)")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.model_parallel > 1:
        raise SystemExit(f"--model-parallel {args.model_parallel}: sharded "
                         "training is not ported (ROADMAP queue 1, item 7); "
                         "train on one device")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain "
                         "PyTorch path")
    device = torch.device(args.device)

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    cfg = (get_config(args.arch) if args.full
           else get_smoke_config(args.arch, dtype=dtype))
    opt = AdamW(lr=cosine_schedule(3e-4, 20, args.steps))
    params, opt_state = init_train_state(
        cfg, opt, torch.Generator(device=device).manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M device={device} "
          f"dtype={str(cfg.dtype).split('.')[1]}")
    step_fn = make_train_step(cfg, opt, accum_steps=args.accum)

    data = SyntheticTokens(DataConfig(cfg.vocab_size, args.seq, args.batch))
    start = ckpt.latest_step(args.ckpt_dir) or 0
    if start:
        state, _ = ckpt.restore(args.ckpt_dir, start,
                                {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        print(f"resumed from step {start}")

    wd = StragglerWatchdog()
    prefetch = Prefetcher(data.batch, start_step=start)
    try:
        with PreemptionGuard() as guard:
            t0 = time.time()
            for step, batch in prefetch:
                if step >= args.steps:
                    break
                batch = {k: torch.from_numpy(v).to(device)
                         for k, v in batch.items()}
                ts = time.time()
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch, step)
                loss = float(metrics["loss"])       # waits for the step
                wd.observe(time.time() - ts)
                print(f"step {step:5d} loss {loss:.4f} "
                      f"({time.time() - t0:.0f}s)", flush=True)
                if guard.preempted or (step + 1) % args.ckpt_every == 0:
                    ckpt.save(args.ckpt_dir, step + 1,
                              {"params": params, "opt": opt_state})
                    if guard.preempted:
                        print("preempted -> checkpointed, exiting")
                        break
    finally:
        prefetch.close()
    print(f"done; straggler incidents={wd.incidents}")


if __name__ == "__main__":
    main()
