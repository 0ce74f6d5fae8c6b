"""Serving launcher for the port: one ServeEngine over synthetic prompts.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm-2b \\
        --requests 8 --batch 4 --quant-spec \\
        planes=3,encoding=ent,impl=pallas_fused,act_quant=per_token

It runs the full configuration on the card by default, with random params
drawn from ``--seed``; ``--smoke`` picks the reduced configuration and
``--device cpu`` the CPU.  Prints the run's stats dict (``--json`` for
JSON).  Exit status 1 when a request did not complete.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.engine import QuantSpec
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import POLICIES

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCHS, default="minicpm-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced configuration of --arch")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quant-spec", default=None,
                    help="quantized-GEMM spec, e.g. 'planes=3,encoding=ent,"
                         "impl=pallas_fused,act_quant=per_token' (default: "
                         "the bf16 path)")
    ap.add_argument("--policy", choices=tuple(POLICIES), default="fcfs",
                    help="admission policy")
    ap.add_argument("--json", action="store_true",
                    help="print stats as JSON")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    max_len = args.prompt_len + args.max_tokens + 1
    rng = np.random.default_rng(args.seed)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    args.prompt_len).tolist(),
                    args.max_tokens) for i in range(args.requests)]
    eng = ServeEngine(cfg, args.batch, max_len, seed=args.seed,
                      quant=QuantSpec.parse(args.quant_spec),
                      device=args.device)
    stats = eng.run(reqs, policy=args.policy)
    if eng.plan_stats is not None:
        stats["plan_stats"] = eng.plan_stats
    ok = stats["requests"] == args.requests
    if not ok:
        print(f"serve FAILED: completed {stats['requests']} of "
              f"{args.requests} requests", file=sys.stderr)
    print(json.dumps(stats, indent=1, default=str) if args.json else stats)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
