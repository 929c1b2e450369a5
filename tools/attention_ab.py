#!/usr/bin/env python3
"""Holds kernels 3 and 7 of the port found under ``--src`` bitwise against
another tree's run on the same seeded inputs, head dim by head dim, so a
change to their staging can be shown to leave every earlier head dim's
bits alone:

    python3 tools/attention_ab.py --src checkout/parent/src --tag parent
    python3 tools/attention_ab.py --tag change --compare parent

Cases, bf16: kernel 3 in its four variants (slot or paged, fp or int8
K/V; 16-token pages under a scrambled table) at B = 4, MAX 512, decode
(C = 1) and a 64-wide chunk with a dead row, 8 query heads over 2 KV heads
(and over 1 at head dim 256); kernel 7 causal (B = 2, S = 300), windowed
(S = 256, window 64) and without a mask (Sq = 64, Skv = 200), 8 heads over
2.  Head dims 32, 64, 128 and 256, and 112 where the tree's wrappers take
it.  Each run writes the sha256 of every output to one JSON line in
``chiprun_out/attention_ab.jsonl``; ``--compare TAG`` fails unless every
case both runs hold has the same digest as the last run tagged TAG.  Run
the trees in one command on one card.  Needs one card; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out")
HEAD_DIMS = (32, 64, 112, 128, 256)


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().view(-1).view(
        __import__("torch").uint8).cpu().numpy().tobytes()).hexdigest()


def cases(torch, ops, quantize_kv, d):
    """(name, output) of every case at head dim ``d``."""
    g = torch.Generator(device="cuda").manual_seed(d)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    b, s, bs = 4, 512, 16
    hq, hkv = (8, 1) if d == 256 else (8, 2)
    k, v = randn(b, hkv, s, d), randn(b, hkv, s, d)
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    slot = {False: {"k": k.to(bf), "v": v.to(bf)},
            True: {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}}
    n_pages = s // bs
    perm = torch.randperm(b * n_pages + 3, generator=g, device="cuda")
    table = perm[:b * n_pages].reshape(b, n_pages).to(torch.int32)

    def to_pool(t):
        pool = torch.zeros((b * n_pages + 4, hkv, bs, t.shape[-1]),
                           dtype=t.dtype, device="cuda")
        pool[table.long()] = t.reshape(b, hkv, n_pages, bs,
                                       -1).transpose(1, 2)
        return pool
    paged = {q: {n: to_pool(t) for n, t in c.items()}
             for q, c in slot.items()}
    lengths = torch.tensor([37, 200, 5, 511], dtype=torch.int32,
                           device="cuda")
    q64 = randn(b, hq, 64, d).to(bf)
    for c, ql in ((1, [1, 1, 1, 1]), (64, [1, 64, 0, 17])):
        q_lens = torch.tensor(ql, dtype=torch.int32, device="cuda")
        q = q64[:, :, :c].contiguous()
        for is_paged in (False, True):
            for quant in (False, True):
                cache = (paged if is_paged else slot)[quant]
                kw = {"page_table": table} if is_paged else {}
                out = ops.mixed_attention(
                    q, cache["k"], cache["v"], lengths, q_lens,
                    k_scale=cache.get("k_scale"),
                    v_scale=cache.get("v_scale"), **kw)
                yield (f"k3 {'paged' if is_paged else 'slot'}"
                       f"{'-int8' if quant else ''} C={c}", out)
    for name, (bb, sq, skv, causal, window) in (
            ("k7 causal S=300", (2, 300, 300, True, None)),
            ("k7 window 64 S=256", (1, 256, 256, True, 64)),
            ("k7 no mask 64x200", (2, 64, 200, False, None))):
        q = randn(bb, 8, sq, d).to(bf)
        kk = randn(bb, 2, skv, d).to(bf)
        vv = randn(bb, 2, skv, d).to(bf)
        yield name, ops.attention(q, kk, vv, causal=causal, window=window)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", required=True)
    ap.add_argument("--compare", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.decode_flash import HEAD_DIMS as K3_DIMS
    from repro_torch.models.attention import quantize_kv
    _build.build(["decode_flash", "flash_attention"])
    out = {}
    for d in HEAD_DIMS:
        if d not in K3_DIMS[torch.bfloat16]:
            continue
        for name, t in cases(torch, ops, quantize_kv, d):
            torch.cuda.synchronize()
            out[f"d={d} {name}"] = digest(t)
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, "attention_ab.jsonl")
    with open(path, "a") as f:
        f.write(json.dumps({"tag": args.tag, "src": args.src,
                            "digests": out}) + "\n")
    print(f"{args.tag}: {len(out)} cases at head dims "
          f"{sorted({k.split()[0] for k in out})}")
    if args.compare is None:
        return 0
    with open(path) as f:
        runs = [json.loads(ln) for ln in f if ln.strip()]
    ref = [r for r in runs if r["tag"] == args.compare]
    if not ref:
        print(f"no run tagged {args.compare}")
        return 1
    ref = ref[-1]["digests"]
    both = sorted(set(ref) & set(out))
    differ = [k for k in both if ref[k] != out[k]]
    print(f"{args.tag} vs {args.compare}: {len(both)} cases held, "
          f"{len(differ)} differ {differ}")
    return 1 if differ or not both else 0


if __name__ == "__main__":
    sys.exit(main())
