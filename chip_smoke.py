#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. The card: prints ``nvidia-smi``'s name and power limit; no CUDA device
   is a failure.
2. Build: compiles the kernel source ``src/repro_torch/kernels/csrc/
   bw_gemm.cu`` with nvcc and prints the build seconds and ptxas' register
   and spill report of each kernel instantiation.
3. Kernels against their plain versions, at the main path's shapes
   (M, K_pad) in {(2304, 2304), (5760, 2304), (2304, 5888)}, N in {1, 4},
   on seeded weights planned at planes=3 and masks with a False block over
   non-zero digits.  bw_gemm (int32) and bw_gemm_fused without an
   activation must be bit-identical to the plain versions; with an
   activation within rtol 1e-5, atol 1e-6 (the card's expf/tanhf against
   torch's own kernels, and gelu's 1 + tanh cancellation for negative
   inputs).  Each case is timed with CUDA events after a warm-up: the
   kernel, the plain version, and torch._int_mm on the undecomposed int8
   weight as a yardstick the port never calls.
4. The path: ServeEngine on the full-width minicpm-2b config (all 40
   layers), params from a seeded torch.Generator, 8 seeded prompts of 8-24
   tokens, batch 4, 16 new tokens, max_len 64, served through
   impl=pallas_fused, impl=pallas and the plain impl=planes oracle on the
   same params.  The three must emit the same tokens, and each kernel's
   launch count -- zeroed just before each run, read just after -- must
   be 7 * layers * steps on its own route and 0 elsewhere.  torch.profiler
   then traces three more decode steps of each route: device time per
   step, the kernels' share of it, and the device's busy share of the step
   time measured without the profiler.

The kernels line gives, per kernel, one layer's seven launches at N=4
(four 2304x2304, two 5760x2304 and one 2304x5888 products): ``ms`` the
kernel, ``plain_ms`` the plain version, ``library_ms`` torch._int_mm,
``bound_ms`` the larger of the bytes they must move at 3.35 TB/s and their
int8 operations at 1979 TOP/s (H100 SXM data sheet), counted from this
run's masks (live plane blocks only) and the operands each timed call
passes (bw_gemm: digits, activations, mask, int32 output; bw_gemm_fused:
those, the two scale vectors and a float32 output; it is timed without a
bias).  The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM, data sheet
INT8_OPS_PER_S = 1979e12             # H100 SXM dense int8, data sheet
PATH_SHAPES = ((2304, 2304, 4), (5760, 2304, 2), (2304, 5888, 1))
ACT_RTOL, ACT_ATOL = 1e-5, 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def cuda_ms(fn, iters: int = 24, warmup: int = 3) -> float:
    """Mean device ms of one fn(i) call, by a CUDA event pair around each.

    The host issues a small kernel more slowly than the card runs it, so
    events around a loop of launches would time the host.  Each call is
    instead queued behind a sleep kernel (four times the host's measured
    issue time, at <= 1 GHz), so its start event fires only when the card
    reaches it, and the pair times the device alone.
    """
    import torch
    for i in range(warmup):
        t0 = time.perf_counter()
        fn(i)
        host_s = time.perf_counter() - t0
    cycles = int(4e9 * host_s) + 100_000
    torch.cuda.synchronize()
    pairs = []
    for i in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn(i)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def cold_copies(t, total_bytes: float = 150e6):
    """Copies of ``t`` that together exceed the 50 MB L2 three times over,
    so a timing loop cycling through them reads device memory, as the
    serving path (whose 40 layers hold distinct weights) does."""
    return [t.clone() for _ in range(max(2, -(-int(total_bytes)
                                              // t.nbytes)))]


def kernel_cases(dev, log):
    """Phase 3: both kernels against their plain versions, timed."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import bw_gemm as bwk
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(1234)
    per_kernel = {"bw_gemm_fused": [], "bw_gemm": []}
    err = {"bw_gemm_fused": 0.0, "bw_gemm": 0.0}
    for m, k, per_layer in PATH_SHAPES:
        w = torch.randn((k, m), generator=gen, device=dev)
        qw, sw = quant.quantize_to_planes(w, 3, axis=0)
        planned = ops.plan_operand(qw.t(), "ent", 128, 256)
        digits, mask = planned.digits, planned.mask.clone()
        k_pad = digits.shape[2]
        # a False block over non-zero digits in each of planes 0..2
        for p in range(3):
            kk = p % mask.shape[2]
            if not bool(digits[p, :128, 256 * kk:256 * (kk + 1)].any()):
                raise AssertionError(f"plane {p} block (0, {kk}) is empty")
            mask[p, 0, kk] = False
        scale = ops._channel_rows(sw.reshape(-1), m, digits.shape[1],
                                  planned.row_perm)
        wq_pad = torch.zeros((digits.shape[1], k_pad), dtype=torch.int8,
                             device=dev)
        wq_pad[:m, :k] = qw.t()
        bias = torch.randn((digits.shape[1], 1), generator=gen, device=dev)
        for n in (1, 4):
            x = torch.randn((n, k), generator=gen, device=dev)
            qx, sx = quant.quantize_to_planes(x, 3, axis=-1)
            b = torch.zeros((n, k_pad), dtype=torch.int8, device=dev)
            b[:, :k] = qx
            sx_cols = sx.reshape(1, -1).contiguous()
            kw = dict(block_m=128, block_k=256, radix=4)
            nnz = int(mask.sum())
            m_pad = digits.shape[1]
            live_bytes = nnz * 128 * 256
            ops_n = 2 * live_bytes * n
            # bytes each timed call moves: live digits, activations, mask,
            # the output; bw_gemm_fused also reads scale [M] and scale_n [N]
            moved = {"bw_gemm": live_bytes + b.numel() + mask.numel()
                     + 4 * m_pad * n}
            moved["bw_gemm_fused"] = moved["bw_gemm"] + 4 * (m_pad + n)

            got = bwk.bw_gemm(digits, b, mask, **kw)
            want = bwk.bw_gemm_plain(digits, b, mask, **kw)
            torch.cuda.synchronize()
            err["bw_gemm"] = max(err["bw_gemm"],
                                 float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"bw_gemm != plain at M={m} K={k_pad} "
                                     f"N={n}")
            for act in (None, "silu", "gelu", "relu2"):
                args = (digits, b, mask, scale, bias if act else None,
                        sx_cols)
                got = bwk.bw_gemm_fused(*args, activation=act, **kw)
                want = bwk.bw_gemm_fused_plain(*args, activation=act, **kw)
                torch.cuda.synchronize()
                diff = float((got - want).abs().max())
                err["bw_gemm_fused"] = max(err["bw_gemm_fused"], diff)
                if act is None:
                    ok = torch.equal(got, want)
                else:
                    ok = bool(torch.all((got - want).abs()
                                        <= ACT_ATOL + ACT_RTOL * want.abs()))
                if not ok:
                    raise AssertionError(
                        f"bw_gemm_fused[{act}] != plain at M={m} "
                        f"K={k_pad} N={n}: max |diff| {diff}")

            # timing, L2-cold: kernel, plain version, torch._int_mm
            b8 = torch.zeros((8, k_pad), dtype=torch.int8, device=dev)
            b8[:n] = b
            wq_cold = cold_copies(wq_pad)
            try:
                torch._int_mm(wq_pad, b8.t())
                lib_ms = cuda_ms(lambda i: torch._int_mm(
                    wq_cold[i % len(wq_cold)], b8.t()))
            except RuntimeError as e:
                log(f"  torch._int_mm unavailable at M={m} K={k_pad}: {e}")
                lib_ms = None
            del wq_cold
            d_cold = cold_copies(digits)
            for name, fn, plain in (
                    ("bw_gemm_fused",
                     lambda i: bwk.bw_gemm_fused(
                         d_cold[i % len(d_cold)], b, mask, scale, None,
                         sx_cols, **kw),
                     lambda i: bwk.bw_gemm_fused_plain(
                         digits, b, mask, scale, None, sx_cols, **kw)),
                    ("bw_gemm",
                     lambda i: bwk.bw_gemm(d_cold[i % len(d_cold)], b, mask,
                                           **kw),
                     lambda i: bwk.bw_gemm_plain(digits, b, mask, **kw))):
                row = {"m": m_pad, "k_pad": k_pad, "n": n,
                       "per_layer": per_layer,
                       "ms": cuda_ms(fn), "plain_ms": cuda_ms(plain, 5, 1),
                       "library_ms": lib_ms,
                       "bytes": moved[name], "ops": ops_n,
                       "live_blocks": nnz, "blocks": mask.numel()}
                row["bound_ms"] = 1e3 * max(row["bytes"] / HBM_BYTES_PER_S,
                                            row["ops"] / INT8_OPS_PER_S)
                per_kernel[name].append(row)
                log(f"  {name:14s} M={row['m']:5d} K={k_pad:5d} N={n}  "
                    f"kernel {row['ms']:.4f} ms  plain "
                    f"{row['plain_ms']:.4f} ms  _int_mm "
                    f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms"
                    f"  bound {row['bound_ms']:.4f} ms")
            del d_cold
    return per_kernel, err


def profile_steps(eng, dev, steps: int = 3) -> dict:
    """torch.profiler over ``steps`` decode steps of a served engine: the
    device time per step (kernel events only; the CPU ops that launched
    them would count it twice), each bw_gemm kernel's part of it, and the
    costliest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def one_step():
        logits, _ = eng.api.decode_step(
            eng.params, torch.as_tensor(eng.slots.cur, device=dev),
            torch.as_tensor(eng.slots.pos, device=dev), eng.state, eng.cfg)
        torch.argmax(logits[:, -1, :], dim=-1).cpu()

    def dev_us(evt):
        return (getattr(evt, "self_device_time_total", None)
                or getattr(evt, "self_cuda_time_total", 0) or 0)

    with torch.no_grad():
        one_step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                one_step()
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    total_us = sum(dev_us(e) for e in kernels)
    kern_us = {k: sum(dev_us(e) for e in kernels if k in e.key)
               for k in ("bw_gemm_fused_kernel", "bw_gemm_i32_kernel")}
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    return {"steps": steps,
            "device_ms_per_step": total_us / 1e3 / steps,
            "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
            "kernel_ms_per_step": {k: v / 1e3 / steps
                                   for k, v in kern_us.items()},
            "top_kernels": [(e.key[:90], dev_us(e) / 1e3 / steps,
                             e.count / steps) for e in top]}


def serve(cfg, params, spec_text, prompts, dev):
    import torch
    from repro_torch.engine import QuantSpec
    from repro_torch.kernels import bw_gemm as bwk
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import ServeRequest

    t0 = time.perf_counter()
    eng = ServeEngine(cfg, 4, 64, quant=QuantSpec.parse(spec_text),
                      params=params, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reqs = [ServeRequest(i, list(p), 16) for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    bwk.bw_gemm.launches = 0
    bwk.bw_gemm_fused.launches = 0
    stats = eng.run(reqs)
    launches = {"bw_gemm": bwk.bw_gemm.launches,
                "bw_gemm_fused": bwk.bw_gemm_fused.launches}
    stats.update(setup_s=setup_s, launches=launches,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 ms_per_step=1e3 * stats["wall_s"] / stats["engine_steps"],
                 plan_stats=eng.plan_stats)
    # one more decode step: the logits are finite and of the right shape
    with torch.no_grad():
        logits, _ = eng.api.decode_step(
            eng.params, torch.as_tensor(eng.slots.cur, device=dev),
            torch.as_tensor(eng.slots.pos, device=dev), eng.state, eng.cfg)
    if tuple(logits.shape) != (4, 1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{spec_text}: bad logits "
                             f"{tuple(logits.shape)}")
    try:
        prof = profile_steps(eng, dev)
        prof["device_busy_share"] = \
            prof["device_ms_per_step"] / stats["ms_per_step"]
        stats["profile"] = prof
    except (RuntimeError, AttributeError) as e:   # tracer unavailable
        stats["profile"] = {"error": repr(e)}
    tokens = [r.out for r in reqs]
    del eng, logits
    torch.cuda.empty_cache()
    return tokens, stats


def main() -> int:
    print(card_line(), flush=True)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.configs.minicpm_2b import CONFIG
    from repro_torch.kernels import _build
    from repro_torch.kernels import bw_gemm as bwk
    from repro_torch.models.api import get_api

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build ------------------------------------------------------------
    for name in _build.SOURCES:
        t0 = time.perf_counter()
        _build.load(name)
        log(f"[build] {name}: {time.perf_counter() - t0:.1f} s")
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if any(w in line for w in ("Function properties", "registers",
                                       "spill")):
                log(f"  {line.strip()}")

    # -- 3. kernels against their plain versions -----------------------------
    log("[kernels] bit-exact and timed against the plain versions")
    per_kernel, err = kernel_cases(dev, log)

    # -- 4. the path at full width -------------------------------------------
    cfg = CONFIG
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size,
                            int(rng.integers(8, 25))).tolist()
               for _ in range(8)]
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = get_api(cfg).init(gen, cfg, dev)
    torch.cuda.synchronize()
    log(f"[path] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}; params "
        f"{cfg.param_count() / 1e9:.3f} B in "
        f"{time.perf_counter() - t0:.1f} s")
    base = "planes=3,encoding=ent,act_quant=per_token,impl="
    runs = {}
    for impl in ("pallas_fused", "pallas", "planes"):
        tokens, stats = serve(cfg, params, base + impl, prompts, dev)
        runs[impl] = {"tokens": tokens, "stats": stats}
        log(f"[path] impl={impl}: {stats['generated_tokens']} tokens in "
            f"{stats['engine_steps']} steps, {stats['tok_per_s']:.2f} "
            f"tok/s, {stats['ms_per_step']:.3f} ms/step, peak "
            f"{stats['peak_mem_gb']:.2f} GB, set-up {stats['setup_s']:.1f} s,"
            f" launches {stats['launches']}  ({kind})")
        log(f"[profile] impl={impl}: {json.dumps(stats['profile'])}")
    for impl in ("pallas", "planes"):
        if runs[impl]["tokens"] != runs["pallas_fused"]["tokens"]:
            raise AssertionError(f"impl={impl} tokens differ from "
                                 f"impl=pallas_fused")
    if any(len(t) != 16 for t in runs["planes"]["tokens"]):
        raise AssertionError("a request did not generate 16 tokens")
    for impl, kern in (("pallas_fused", "bw_gemm_fused"),
                       ("pallas", "bw_gemm")):
        st = runs[impl]["stats"]
        want = 7 * cfg.n_layers * st["engine_steps"]
        got = st["launches"]
        other = "bw_gemm" if kern == "bw_gemm_fused" else "bw_gemm_fused"
        if got[kern] != want or got[other] != 0:
            raise AssertionError(f"impl={impl}: launches {got}, expected "
                                 f"{kern}={want} and {other}=0")
    if any(runs["planes"]["stats"]["launches"].values()):
        raise AssertionError("the plain oracle route launched a kernel")
    log("[path] pallas_fused, pallas and planes emit the same tokens")

    # -- the kernels line ----------------------------------------------------
    replaces = {"bw_gemm_fused": "src/repro/kernels/bw_gemm.py:215",
                "bw_gemm": "src/repro/kernels/bw_gemm.py:140"}
    route = {"bw_gemm_fused": "pallas_fused", "bw_gemm": "pallas"}
    kernels = []
    for name in ("bw_gemm_fused", "bw_gemm"):
        rows = [r for r in per_kernel[name] if r["n"] == 4]

        def layer_sum(key, rows=rows):
            vals = [r[key] for r in rows]
            if any(v is None for v in vals):
                return None
            return sum(v * r["per_layer"] for v, r in zip(vals, rows))
        layer_bytes = layer_sum("bytes")
        layer_ops = layer_sum("ops")
        bytes_ms = 1e3 * layer_bytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * layer_ops / INT8_OPS_PER_S
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bw_gemm.cu",
            "replaces": replaces[name],
            "launches": runs[route[name]]["stats"]["launches"][name],
            "max_abs_err": err[name],
            "ms": layer_sum("ms"), "plain_ms": layer_sum("plain_ms"),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": layer_sum("library_ms")})
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
