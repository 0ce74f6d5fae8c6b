"""``python -m repro_torch.analysis`` -- audit the port's checked-in kernel
artifacts with the static analyzers (the reference's
``python -m repro.analysis``).

Three audit stages (all host-side):

1. **autotune cache** -- every entry of the checked-in (or
   ``--cache``-named) autotune cache must parse, and its winning config
   must fit the shared-memory budget for the shape its key names;
2. **config registry** -- for every registered architecture (the port's
   registry holds minicpm-2b), the characteristic decode GEMMs
   (attention/MLP/vocab projections) are priced against the budget per
   dispatch route; pipelined-route overruns surface as *info*
   clamp/fallback suggestions (the route is opt-in per spec),
   dense/sparse overruns are errors;
3. **CI-shape plans** -- real plans are built on ``--device`` for the
   autotuner's CI_SHAPES in both schedule orders and run through the
   schedule verifier, the slot-column walk, and the ``GemmEngine.cost()``
   cross-check.

The reference's fourth stage, the sharded plans, needs the port's
``parallel.plan.shard_plan`` (ROADMAP A9): until then the audit prints
one line saying so.

Exit status 1 when any error-severity diagnostic is found; ``--json``
emits machine-readable findings.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from . import (INFO, Report, check_vmem, crosscheck_cost, verify_plan,
               vmem_budget)

# decode batch the registry audit prices (tokens on the kernel N axis)
AUDIT_TOKENS = 128

SHARDED_STAGE_WAITS = ("sharded plans: not audited -- the stage needs "
                       "parallel.plan.shard_plan, which waits for ROADMAP "
                       "A9 (multi-device)")


def _shape_from_key(key: str):
    try:
        dims = key.split("|", 1)[0].split("x")
        m, k, n = (int(d) for d in dims)
        return m, k, n
    except (ValueError, IndexError):
        return None


def _planes_from_key(key: str) -> int:
    """Digit planes of the plan a cache key's plan part names."""
    part = key.split("|")[1] if "|" in key else "default"
    if part == "default":
        return 4                           # ent/8b default grid
    try:
        from repro_torch.core import encodings as enc
        encbits = part.split(".")[1]       # e.g. "ent8", "bitserial8"
        encoding = encbits.rstrip("0123456789")
        bits = int(encbits[len(encoding):] or 8)
        return enc.num_digits(encoding, bits)
    except Exception:
        return 4


def audit_autotune_cache(report: Report, path: Optional[str] = None,
                         budget: Optional[int] = None) -> None:
    from repro_torch.kernels import autotune

    path = path or autotune.DEFAULT_CACHE_PATH
    try:
        cache = autotune.AutotuneCache.load(path)
    except Exception as e:
        report.add("AUDIT_BAD_ARTIFACT",
                   f"autotune cache {path!r} failed to load: {e}",
                   where=path)
        return
    if not cache.entries:
        report.add("AUDIT_BAD_ARTIFACT",
                   f"autotune cache {path!r} is missing or empty",
                   where=path)
        return
    for key, entry in sorted(cache.entries.items()):
        shape = _shape_from_key(key)
        if shape is None:
            report.add("AUDIT_BAD_ARTIFACT",
                       f"cache key {key!r} does not start with an MxKxN "
                       f"shape", where=path)
            continue
        m, k, n = shape
        check_vmem(entry.get("dispatch") or "dense", m, k, n,
                   block_m=entry["block_m"], block_k=entry["block_k"],
                   block_n=entry["block_n"],
                   n_planes=_planes_from_key(key), budget=budget,
                   report=report)


def audit_config_registry(report: Report,
                          budget: Optional[int] = None) -> None:
    from repro_torch.configs import registry as configs
    from repro_torch.kernels import ops

    for arch in configs.ARCHS:
        try:
            cfg = configs.get_config(arch)
        except Exception as e:
            report.add("AUDIT_BAD_ARTIFACT",
                       f"configs.get_config({arch!r}) failed: {e}",
                       where=arch)
            continue
        # the planned-weight GEMMs a decode step runs: (kernel rows M =
        # output channels, K = input dim), tokens on N
        gemms = {
            "attn": (cfg.d_model, cfg.d_model),
            "mlp_up": (cfg.d_ff, cfg.d_model),
            "mlp_down": (cfg.d_model, cfg.d_ff),
            "vocab": (cfg.vocab_size, cfg.d_model),
        }
        for name, (m, k) in gemms.items():
            n = AUDIT_TOKENS
            bm, bk, bn = ops.select_block_sizes(m, k, n)
            for route in ("dense", "sparse", "pipelined"):
                check_vmem(route, m, k, n, block_m=bm, block_k=bk,
                           block_n=bn, n_planes=4, budget=budget,
                           severity=INFO if route == "pipelined"
                           else "error",
                           where=f"{arch}.{name} {m}x{k}x{n}/{route}",
                           report=report)


def audit_ci_plans(report: Report, device) -> None:
    import numpy as np
    import torch

    from repro_torch.engine.spec import QuantSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels.autotune import CI_SHAPES

    spec = QuantSpec(planes=3)
    rng = np.random.default_rng(0)
    for m, k, n in CI_SHAPES:
        w = torch.from_numpy(
            (rng.standard_t(4, size=(k, m)) * 0.02).astype(np.float32)
        ).to(device)
        for order, impls in (("m_major", ("pallas_fused", "pallas_sparse")),
                             ("k_major", ("pallas_pipelined",))):
            planned, _sw = ops.plan_for(w, spec, order=order, verify=False)
            sub = Report(f"plan {m}x{k}x{n} {order}")
            verify_plan(planned, spec.radix, order, report=sub)
            for impl in impls:
                crosscheck_cost(impl, m, k, n, spec, planned, report=sub)
            report.extend(sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=__doc__.splitlines()[0])
    ap.add_argument("--cache", default=None,
                    help="autotune cache path to audit (default: the "
                         "checked-in cache)")
    ap.add_argument("--budget", type=int, default=None,
                    help="shared-memory budget in bytes (default: "
                         "$REPRO_VMEM_BUDGET or 232448)")
    ap.add_argument("--json", action="store_true",
                    help="emit diagnostics as JSON")
    ap.add_argument("--skip-plans", action="store_true",
                    help="skip the CI-shape plan verification stage")
    ap.add_argument("--device", default="cuda",
                    help="torch device the CI-shape plans are built on "
                         "(default cuda)")
    args = ap.parse_args(argv)

    report = Report("repro_torch.analysis audit")
    audit_autotune_cache(report, path=args.cache, budget=args.budget)
    audit_config_registry(report, budget=args.budget)
    if not args.skip_plans:
        from repro_torch import resolve_device
        audit_ci_plans(report, resolve_device(args.device))
    # stdout carries the JSON document alone under --json
    print(SHARDED_STAGE_WAITS, file=sys.stderr if args.json else sys.stdout)

    if args.json:
        payload = {
            "budget": vmem_budget(args.budget),
            "errors": len(report.errors),
            "warnings": len(report.warnings),
            "diagnostics": [
                {"code": d.code, "severity": d.severity, "step": d.step,
                 "where": d.where, "message": d.message,
                 "suggestion": d.suggestion}
                for d in report.diagnostics],
        }
        json.dump(payload, sys.stdout, indent=1)
        sys.stdout.write("\n")
    else:
        print(report)
    return 1 if report.errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
