"""Serving launcher for the port: a thin CLI over ``repro_torch.serving``
(``repro.launch.serve``'s surface).

It serves the full configuration on the card by default, with random
params drawn once from ``--seed`` and shared by every worker;
``--smoke`` picks the reduced configuration and ``--device cpu`` the
CPU.

Single-engine mode (default):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm-2b \
        --requests 8 --batch 4 --quant-spec \
        planes=3,encoding=ent,impl=pallas_fused,act_quant=per_token

Async multi-tier mode (``--tiers N`` or repeated ``--tier name=spec``):
one continuous-batching worker per QuantSpec tier, requests routed by a
cost-model-driven policy, served under a synthetic arrival process:

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 12 \
        --tiers 2 --arrival poisson --rate 50 --router slo

Crash-recoverable serving: ``--journal`` write-ahead-logs admissions and
committed tokens; after a crash (e.g. the ``crash_server`` chaos fault)
the same command plus ``--resume`` replays the journal, skips requests
it proves complete, and re-enters in-flight ones at their last
committed token:

    PYTHONPATH=src python -m repro_torch.launch.serve --tiers 2 \
        --journal serve.wal --chaos crash_server@s40; \
    PYTHONPATH=src python -m repro_torch.launch.serve --tiers 2 \
        --journal serve.wal --resume --outputs out.json

``--mesh`` (sharded tiers) is not ported: the port serves one device.
Exit status 1 when a request did not complete.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.engine import QuantSpec, engine_names, spec_from_flags
from repro_torch.serving import (AsyncServer, BrownoutPolicy, DONE,
                           FAILOVER_MODES, Request, RequestJournal,
                           ROUTER_POLICIES, ServeEngine, Tier,
                           default_tiers, loadgen, replay_journal,
                           resume_split, validate_summary)
from repro_torch.serving.scheduler import POLICIES

__all__ = ["ServeEngine", "Request", "main"]


def _parse_tier(text: str) -> Tier:
    """``name=<quant-spec-string>`` (spec ``off`` -> unquantized tier)."""
    if "=" not in text:
        raise argparse.ArgumentTypeError(
            f"--tier expects name=<quant-spec>, got {text!r}")
    name, spec_text = text.split("=", 1)
    return Tier(name.strip(), QuantSpec.parse(spec_text))


def _parse_slack(text):
    try:
        lo, hi = (float(s) for s in text.split(":"))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--deadline-slack expects lo:hi seconds, got {text!r}")
    return (lo, hi)


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
                    help="full quantized-GEMM spec, e.g. "
                         "'planes=4,encoding=ent,impl=pallas_fused' "
                         "(the flags below are sugar for its fields)")
    ap.add_argument("--quant-planes", type=int, default=0,
                    help="serve through the BW-decomposed int8 path with "
                         "this many digit planes")
    ap.add_argument("--quant-impl", choices=engine_names(),
                    default="pallas_fused",
                    help="quantized matmul engine (pallas_fused = the "
                         "fused kernel execution path)")
    ap.add_argument("--quant-encoding", default="ent",
                    help="bit-weight encoding (see core.encodings)")
    ap.add_argument("--quant-bits", type=int, default=8)
    # -- async multi-tier server ------------------------------------------
    ap.add_argument("--tiers", type=int, default=0,
                    help="run the async server with the first N default "
                         "quant tiers (fast/balanced/quality ladder); "
                         "0 = single-engine mode")
    ap.add_argument("--tier", action="append", dest="custom_tiers",
                    type=_parse_tier, metavar="NAME=SPEC",
                    help="custom tier (repeatable), e.g. "
                         "fast=planes=2,impl=pallas_fused; implies the "
                         "async server")
    ap.add_argument("--policy", choices=tuple(POLICIES), default="fcfs",
                    help="admission policy of each tier worker's queue")
    ap.add_argument("--router", choices=ROUTER_POLICIES, default="slo",
                    help="tier-routing policy (cost-model driven)")
    ap.add_argument("--arrival", choices=loadgen.ARRIVAL_PATTERNS,
                    default="none", help="synthetic arrival process")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="arrival rate (req/s) for poisson/uniform")
    ap.add_argument("--deadline-slack", type=_parse_slack, default=None,
                    metavar="LO:HI",
                    help="give each request a deadline of arrival + "
                         "U(lo, hi) seconds (drives --policy deadline "
                         "and --router slo)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="device mesh shape of sharded tiers: not ported "
                         "(the port serves one device); raises")
    ap.add_argument("--realtime", action="store_true",
                    help="threaded wall-clock mode (default: deterministic "
                         "virtual-time simulation)")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="arm a fault plan for the run (FaultPlan.parse "
                         "grammar, e.g. 'kill:fast@s3'); equivalent to "
                         "setting REPRO_CHAOS but scoped to this server")
    ap.add_argument("--failover", choices=FAILOVER_MODES,
                    default="restore",
                    help="what a drained request keeps when its tier "
                         "worker dies: 'restore' snapshots decode state "
                         "and migrates committed tokens (bit-exact on a "
                         "same-spec tier), 'restart' regenerates from "
                         "the prompt (the legacy lossy path)")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="write-ahead request journal (JSONL): "
                         "admissions + committed tokens, flushed per "
                         "record, so a crashed run can restart with "
                         "--resume without losing generated tokens")
    ap.add_argument("--resume", action="store_true",
                    help="replay --journal before serving: requests it "
                         "proves complete are not re-served, in-flight "
                         "ones re-enter at their last committed token")
    ap.add_argument("--outputs", default=None, metavar="PATH",
                    help="write {rid: generated tokens} JSON of every "
                         "completed request (including journal-replayed "
                         "completions under --resume)")
    ap.add_argument("--retry-budget", type=int, default=2,
                    help="restarts granted per request after a tier "
                         "worker dies (0 = lose its in-flight requests)")
    ap.add_argument("--retry-backoff", type=float, default=0.0,
                    help="base seconds before a drained request is "
                         "re-routed (doubles per retry; 0 = immediate)")
    ap.add_argument("--brownout", default=None, metavar="[ENTER:EXIT]",
                    nargs="?", const="48:12",
                    help="enable graceful degradation: above ENTER backlog "
                         "tokens per slot the router demotes requests down "
                         "the quality ladder, recovering below EXIT "
                         "(default 48:12)")
    ap.add_argument("--step-time-scale", type=float, default=None,
                    help="virtual-mode multiplier on the hwmodel step-time "
                         "estimates (default 5e4 with --smoke, 1 at full "
                         "width: smoke models are tiny, so unscaled "
                         "estimates serve any load without queueing, and "
                         "5e4 creates visible contention at smoke scale)")
    ap.add_argument("--json", action="store_true",
                    help="print stats as JSON")
    ap.add_argument("--out", default=None,
                    help="also write the stats JSON to this file")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable repro_torch.obs tracing and write a Chrome "
                         "trace-event JSON (chrome://tracing / Perfetto) "
                         "of the run to PATH")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write the repro_torch.obs metrics-registry snapshot "
                         "JSON to PATH after the run")
    args = ap.parse_args(argv)
    if args.resume and not args.journal:
        ap.error("--resume requires --journal PATH")

    from repro_torch import obs, resolve_device
    device = resolve_device(args.device)
    if args.trace:
        obs.enable(clear_events=True)

    cfg = get_config(args.arch, smoke=args.smoke)
    step_time_scale = args.step_time_scale
    if step_time_scale is None:
        step_time_scale = 5e4 if args.smoke else 1.0
    max_len = args.prompt_len + args.max_tokens + 1
    # --batch sets the decode-slot count of every tier worker too
    tiers = tuple(dataclasses.replace(t, batch=args.batch)
                  for t in args.custom_tiers or ()) or \
        (default_tiers(args.tiers, batch=args.batch) if args.tiers else None)
    if args.mesh is not None:
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded tiers need the multi-device port "
            f"(ROADMAP queue A9); the port serves one device")

    if tiers is None:
        # -- single-engine mode (the historical surface) -------------------
        if args.journal or args.outputs:
            print("--journal/--resume/--outputs ignored in single-engine "
                  "mode (use --tiers/--tier)", file=sys.stderr)
        rng = np.random.default_rng(args.seed)
        reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                        args.prompt_len).tolist(),
                        args.max_tokens) for i in range(args.requests)]
        spec = spec_from_flags(args.quant_spec, args.quant_planes,
                               args.quant_impl, args.quant_encoding,
                               args.quant_bits)
        eng = ServeEngine(cfg, args.batch, max_len, seed=args.seed,
                          quant=spec, device=device)
        stats = eng.run(reqs, policy=args.policy)
        stats["device"] = str(device)
        if eng.plan_stats is not None:
            stats["plan_stats"] = eng.plan_stats
        ok = stats["requests"] == args.requests
        if not ok:
            print(f"serve FAILED: completed {stats['requests']} of "
                  f"{args.requests} requests", file=sys.stderr)
    else:
        # -- async multi-tier mode -----------------------------------------
        reqs = loadgen.synthesize(
            cfg.vocab_size, args.requests,
            prompt_len=(max(args.prompt_len // 2, 1), args.prompt_len),
            max_tokens=(max(args.max_tokens // 2, 1), args.max_tokens),
            pattern=args.arrival, rate=args.rate,
            deadline_slack=args.deadline_slack, seed=args.seed)
        brownout = None
        if args.brownout is not None:
            try:
                enter_s, exit_s = args.brownout.split(":")
                brownout = BrownoutPolicy(enter=float(enter_s),
                                          exit=float(exit_s))
            except ValueError as e:
                ap.error(f"--brownout expects ENTER:EXIT pressures "
                         f"({e})")
        # -- journal / resume (crash recovery) -----------------------------
        journal, replayed = None, {}
        if args.resume:
            rep = replay_journal(args.journal)
            if rep.seed != args.seed:
                ap.error(f"--resume: journal was written with seed "
                         f"{rep.seed}, this run regenerates the load "
                         f"with seed {args.seed}")
            reqs, replayed = resume_split(rep, reqs)
            journal = RequestJournal(args.journal, resume=True,
                                     seed=args.seed)
            journal.seed_from(rep)
            print(f"[journal] replayed {rep.records} record(s) "
                  f"({rep.truncated} truncated): "
                  f"{len(replayed)} complete, "
                  f"{sum(1 for r in reqs if r.out)} in flight, "
                  f"{len(reqs)} to serve", file=sys.stderr)
        elif args.journal:
            try:
                journal = RequestJournal(args.journal, seed=args.seed)
            except FileExistsError as e:
                ap.error(str(e))

        server = AsyncServer(cfg, tiers=tiers, max_len=max_len,
                             seed=args.seed, admission=args.policy,
                             router=args.router,
                             step_time_scale=step_time_scale,
                             chaos=args.chaos,
                             retry_budget=args.retry_budget,
                             retry_backoff=args.retry_backoff,
                             brownout=brownout,
                             failover=args.failover, journal=journal,
                             device=device)
        from repro_torch.chaos import ServerCrashed
        try:
            stats = server.run(reqs, realtime=args.realtime)
        except ServerCrashed as e:
            if journal is not None:
                journal.close()
                print(f"serve CRASHED: {e} — journal flushed to "
                      f"{args.journal}; restart with --resume to keep "
                      f"committed tokens", file=sys.stderr)
            else:
                print(f"serve CRASHED: {e} (no --journal: in-flight "
                      f"work is lost)", file=sys.stderr)
            return 1
        finally:
            if journal is not None:
                journal.close()
        validate_summary(stats)
        if args.outputs:
            outs = dict(replayed)
            outs.update({r.rid: list(r.out) for r in reqs
                         if r.state == DONE})
            with open(args.outputs, "w") as f:
                json.dump({str(k): v for k, v in sorted(outs.items())},
                          f, indent=1)
        # requests lost to an exhausted retry budget (or total tier loss)
        # are a failure even though they are accounted as rejected;
        # journal-replayed completions count toward the resumed total
        ok = (stats["completed"] + stats["rejected"] + len(replayed)
              == args.requests
              and stats["completed"] + len(replayed) > 0
              and stats["failover"]["lost"] == 0)
        if not ok:
            print(f"serve FAILED: {stats['completed']} completed + "
                  f"{stats['rejected']} rejected + {len(replayed)} "
                  f"replayed of {args.requests} requests "
                  f"({stats['failover']['lost']} lost to failover)",
                  file=sys.stderr)

    print(json.dumps(stats, indent=1, default=str) if args.json else stats)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(stats, f, indent=1, default=str)
    if args.trace:
        obs.save(args.trace)
        print(f"[obs] trace written to {args.trace} "
              f"({len(obs.trace_events())} events)", file=sys.stderr)
    if args.metrics:
        with open(args.metrics, "w") as f:
            json.dump(obs.snapshot(), f, indent=1)
        print(f"[obs] metrics snapshot written to {args.metrics}",
              file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
