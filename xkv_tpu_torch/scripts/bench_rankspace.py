"""Time the post-RoPE rank-space decode kernels K2, K4 and K6 of one
checkout on the card, at the Llama-3.1-8B xKV-4 layer's shapes.

    python xkv_tpu_torch/scripts/bench_rankspace.py [--root DIR] [--label NAME]

``--root`` names the checkout whose ``xkv_tpu_torch`` is timed (default:
the one holding this file), so two versions of the kernels can be timed in
turns on one card, each process building its own library:

    python xkv_tpu_torch/scripts/bench_rankspace.py --root build/parent --label parent
    python xkv_tpu_torch/scripts/bench_rankspace.py --label change

Run it as a file, not with ``-m``: with ``-m`` the package of the working
directory is imported first. Shapes: b 1, s_p 8192, rank_k 512, rank_v 768,
R 32 (one token, 32 heads) and 128 (ql 4); K2 over bf16 and int8 factors,
K6 over the 8B split (256 int8 + 256 int4 K ranks, 256 + 512 V ranks), K4
over the top-4 of 512-row chunks. The inputs come from one seed, so every
checkout sees the same. Times are ``cuda_time_ms``'s cold-L2 mean of 10
calls of the wrapper (its merge included). Prints one JSON line, with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="checkout whose kernels are timed")
    ap.add_argument("--label", default="", help="name of this run in the output")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from xkv_tpu_torch.compress.quant import pack_int4_pairs
    from xkv_tpu_torch.ops.kernels import rankspace_attention as k2
    from xkv_tpu_torch.scripts.timing import card_line, cuda_time_ms

    if not torch.cuda.is_available():
        raise SystemExit("bench_rankspace: no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    s_p, rk, rv = 8192, 512, 768

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev).to(torch.int8)

    bf = dict(k=torch.randn((1, s_p, rk), generator=gen, device=dev).to(torch.bfloat16),
              v=torch.randn((1, s_p, rv), generator=gen, device=dev).to(torch.bfloat16))
    i8 = dict(k=ints((1, s_p, rk), -127, 128), v=ints((1, s_p, rv), -127, 128))
    mixed = (ints((1, s_p, 256), -127, 128), pack_int4_pairs(ints((1, s_p, 256), -7, 8)),
             ints((1, s_p, 256), -127, 128), pack_int4_pairs(ints((1, s_p, 512), -7, 8)))
    ids = torch.tensor([[0, 5, 11, 15]], dtype=torch.int32, device=dev)
    times = {}
    for R in (32, 128):
        q = (torch.randn((1, R, rk), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        q8 = (q.float() / 73).to(torch.bfloat16)
        times[f"K2 bf16 R{R}"] = cuda_time_ms(lambda: k2.rankspace_kernel(q, bf["k"], bf["v"]))
        times[f"K2 int8 R{R}"] = cuda_time_ms(lambda: k2.rankspace_kernel(q8, i8["k"], i8["v"]))
        times[f"K6 R{R}"] = cuda_time_ms(lambda: k2.mixed_rankspace_kernel(q8, *mixed))
        if R == 32:
            times["K4 bf16 top-4"] = cuda_time_ms(
                lambda: k2.sparse_rankspace_kernel(q, bf["k"], bf["v"], ids, 512))
            times["K4 int8 top-4"] = cuda_time_ms(
                lambda: k2.sparse_rankspace_kernel(q8, i8["k"], i8["v"], ids, 512))
    print(json.dumps({"label": args.label, "root": args.root, "card": card_line(dev),
                      "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
