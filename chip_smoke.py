#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--rival-wide QUANT_GEMM_CU ...]

Phases (any failure exits non-zero and prints no result line):

1. The card: prints ``nvidia-smi``'s name and power limit; no CUDA device
   is a failure.
2. Build: compiles the kernel sources under ``src/repro_torch/kernels/
   csrc/`` -- ``bw_gemm.cu``, ``bw_gemm_sparse.cu``, ``encode.cu`` and
   ``quant_gemm.cu`` -- with nvcc, one process a library, all started
   together, and prints the build seconds and ptxas' register and spill
   report of each kernel instantiation; a spill in any is a failure.
3. Kernels against their plain versions, at the main path's shapes
   (M, K_pad) in {(2304, 2304), (5760, 2304), (2304, 5888)}.  First
   ``floor_ms``, the timing method's own floor (``cuda_ms`` of an empty
   launch), and per shape ``stream_ms``, a PyTorch reduction over as many
   L2-cold bytes as the live digit planes (a reading of what the card
   streams at that size, not a bound).
   Dense (B1 bw_gemm_fused, B2 bw_gemm), N in {1, 2, 3, 4, 8, 512}, timed
   at N in {1, 4, 512}: seeded weights planned at planes=3, masks with a
   False block over non-zero digits; torch.profiler must see exactly one
   device operation per B1 and per B2 call at every N (one session).
   B2's edges: weights planned at planes 2, 3 and 4 and bit-serially,
   digits of 2, 3, 4 and 8 planes (masks with a False block over
   non-zero digits), a ragged 2311 x 2320 weight through ops.bw_gemm
   against the exact product, 80 x 128 blocks and two calls in a row, at
   N in {1, 3, 4, 8}.
   Sparse (B3 bw_gemm_sparse_fused, B4 bw_gemm_sparse) and pipelined (B5
   bw_gemm_sparse_fused_pipelined, B6 bw_gemm_sparse_pipelined), N in
   {1, 2, 3, 4, 8}: seeded weights at planes=2, schedules in both orders
   built from masks with a False block over non-zero digits, and from a
   mask with an all-empty row block as well (a sentinel); then, at N=3,
   an all-sentinel mask and a schedule shorter than the grid, at N=4 a
   planes=3 (density 0.75) plan and two calls in a row on one stream
   with different activations.  The cases must split some m-block row's
   entries across CTAs (bw_gemm.pipelined_ranges over the grid).  B4/B3
   against their plain versions, B6/B5 on both orders against the same
   plain versions and bit for bit against B4/B3.  torch.profiler must see
   exactly one device operation per B3 and per B4 call, and one (a
   pipelined_kernel) per B5 and per B6 call, on both orders; the
   wrapper's shared-memory layout must equal the library's over a grid of
   block shapes and widths.  B1 is timed on the same planes=2 plans and
   masks, the bar for B3, and held bit-identical to B3 there.  The edges
   of B1-B4's work split, at N in {1, 2, 3, 4, 8}: runs of very different
   lengths (a 92-entry run and a sentinel-only m-block, so some B3/B4
   CTAs search for their run), zero-weight padding, block_k 16 (runs of
   up to 576 entries) and block_m 24; B1-B4 against their plain
   versions, B3 == B1 and B4 == B2 on the mask the schedule was built
   from.  B7 ent_encode: uniform int8 and planes=3 weights at the three
   shapes and at 768 x 4096, the 256 int8 values tiled, and a 768 x 4096
   zero input with one non-zero byte planted in most plan blocks (in the
   block's last 16-byte chunk, which the CTA's last warp encodes in its
   last pass; values whose top live plane changes from block to block),
   at blocks 128 x 256 (the plans'), 128 x 128 (the reference's
   default), 24 x 16 and 128 x 1024 (a CTA loops over four passes);
   digits and mask must be bit-identical, and torch.profiler must see
   exactly one device operation a call; timed at 128 x 256.  B9
   quant_gemm and B8 quant_gemm_fused, T in {1, 2, 3, 4, 8, 16, 17, 64,
   512}, each in both orientations (the weight as A [M, K] with T token columns B [K, T], as
   the planned path calls B9, and T token rows A [T, K] with the weight
   as B [K, M], as the serving path calls B8), at the three shapes and a
   ragged one (M 2311, K 2320): both epilogue axes, with and without a
   bias, under every activation, and in bfloat16; two calls in a row on
   one stream with different operands (at T=4 and T=512); torch.profiler must see
   exactly one device operation per B8 and per B9 call at every width,
   and the wrapper's work split (quant_gemm._layout) must equal the
   library's over a grid of shapes and grids.  At T=512 one layer's
   seven calls are logged beside torch._int_mm, ``floor_ms`` and the
   bound; each ``--rival-wide QUANT_GEMM_CU`` names another design's
   source whose wide kernel meets stream-K (as the designs this one
   replaced did), which is built, held to the same plain versions and
   timed beside them.  Integer results, and
   fused results without an activation, must be bit-identical to the
   plain versions; with an activation within rtol 1e-5, atol 1e-6 (the
   card's expf/tanhf against torch's own kernels, and gelu's 1 + tanh
   cancellation for negative inputs).
   Each kernel is timed L2-cold (``cuda_ms``, the median of 24 calls),
   with its plain version, and torch._int_mm on the undecomposed int8
   weight as a yardstick the port never calls; B3/B4 on m_major
   schedules, B5/B6 on k_major ones, as they serve; B8 on axis 'n'
   without a bias.
4. The path: ServeEngine on the full-width minicpm-2b config (all 40
   layers), params from a seeded torch.Generator, 8 seeded prompts of 8-24
   tokens, batch 4, 16 new tokens, max_len 64, on the same params: at
   planes=3 through impl=pallas_fused, impl=pallas and the plain
   impl=planes oracle, and at planes=2 (the fast tier) through
   impl=pallas_fused, impl=pallas_sparse and impl=pallas_pipelined.  The
   routes of a plane budget must emit the same tokens, and each kernel's
   launch count -- every count zeroed just before each run, read just
   after -- must be 7 * layers * steps on its own route and 0 elsewhere.
   torch.profiler then traces three more decode steps of each route:
   device time per step, the kernels' share of it, the route kernel's
   time and device operations a step (one a call: 7 * layers), and the
   device's busy share of the step time measured without the profiler.
5. The kernel-level API on every dense weight of the same params (7 * 40
   = 280), one weight at a time, at the main path's planes=3 spec: the
   plan with ``ops.plan_operand(encode_impl="kernel")`` (B7) must equal
   the oracle's in digits, mask, schedule and permutations;
   ``ops.quant_gemm(qw.T, xq.T)`` (B9) must equal ``ops.bw_gemm(plan,
   xq.T)`` (B2) and ``ops.quant_gemm_fused(xq, qw, s).T`` (B8) must equal
   ``ops.bw_gemm_fused(plan, xq.T, s)`` (B1) bit for bit, for seeded
   per-token int8 activations xq [4, K]; a second pass with silu holds B8
   against B1 within the tolerance above.  Every count is zeroed first;
   the plain pass must launch B7, B9, B8, B2 and B1 280 times each and the
   silu pass B8 and B1 280 times each, every other kernel 0.  Logs the
   host seconds to plan the 280 weights with each encoder.

The kernels line gives, per kernel, one layer's seven launches at N=4
(four 2304x2304, two 5760x2304 and one 2304x5888 products; B7: one
encode of each plan shape; B8/B9 at T=4 in phase 5's orientations):
``ms`` the kernel, ``plain_ms`` the plain version, ``library_ms``
torch._int_mm (B7: null, no single PyTorch call encodes), ``bound_ms``
the larger of the bytes they must move at 3.35 TB/s and their int8
operations at 1979 TOP/s (H100 SXM data sheet), counted from this run's
masks and schedules (live plane blocks only) and the operands each timed
call passes: the live digits, the activations, the mask (dense) or the
schedule (sparse, pipelined), the output (int32, or float32 when fused)
and, when fused, the scale vectors; fused kernels are timed without a
bias.  ``floor_ms`` is phase 3's timing floor, one call's (``ms`` holds
seven).  B7 moves its input and four digit planes and the mask; B8/B9
their two int8 operands and the output (B8: and its scale).  A line
before it gives B1, B2, B8 and B9 at N=512.  ``launches`` is the count
on the kernel's own route: pallas_fused at planes=3 for B1, pallas for
B2, pallas_sparse for B3 and pallas_pipelined for B5.  B4 and B6, the
unfused twins, serve no engine; after the pallas_sparse and
pallas_pipelined runs, every planned weight of the served model goes
once through planned_dense_apply(fused=False) on the engine's sparse
route (B4 on its m_major plans, B6 on the k_major ones), held
bit-identical to the dense route (B2) on the same record, and their
counts are read from that pass.  B7-B9 serve no engine either: their
counts are phase 5's plain pass.  The last line is
``{"ok": true, "device": {...}}``.
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
DENSE_NS = (1, 2, 3, 4, 8, 512)      # phase 3's widths for B1/B2
TIMED_NS = (1, 4, 512)               # ... of which timed
ACT_RTOL, ACT_ATOL = 1e-5, 1e-6
QUANT_TS = (1, 2, 3, 4, 8, 16, 17, 64, 512)   # phase 3's widths for B8/B9
# M, K of no tile but 16 (per_layer 0: checked, not timed)
RAGGED_SHAPE = (2311, 2320, 0)
# B7's block shapes: the plans', the reference's default, a small odd one,
# and one a CTA takes in four passes (csrc/encode.cu ent_threads)
ENCODE_BLOCKS = ((128, 256), (128, 128), (24, 16), (128, 1024))
# the bytes planted one a block in B7's sparse case, block after block:
# top live planes 0, 1, 1, 2, 2, 3, 3, 3, 3, and an empty block
ENCODE_PLANTED = (1, -3, 4, -12, 16, -48, 64, -128, 127, 0)


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
    """Median device ms of one fn(i) call, by a CUDA event pair around each.

    The host issues a small kernel more slowly than the card runs it, so
    events around a loop of launches would time the host.  Each call is
    instead queued behind a sleep kernel (eight times the slowest warm-up
    call's host time, at <= 2 GHz), so its start event fires only when
    the card reaches it, and the pair times the device alone.  The median
    of the pairs leaves out a pair whose call the host issued late all
    the same.
    """
    import torch
    host_s = 0.0
    for i in range(warmup):
        t0 = time.perf_counter()
        fn(i)
        host_s = max(host_s, time.perf_counter() - t0)
    cycles = int(16e9 * host_s) + 100_000
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
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


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
    one_op = []                   # (what, call, kernel) at the first shape
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
        live_ms = stream_ms(digits, 3)
        log(f"  stream_ms M={digits.shape[1]} K={k_pad} planes=3: "
            f"{live_ms:.5f} ms (float32 sum over {3 * digits[0].numel()} "
            f"L2-cold bytes)")
        for n in DENSE_NS:
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
            if m == PATH_SHAPES[0][0] and k == PATH_SHAPES[0][1]:
                one_op += [
                    (f"bw_gemm_fused N={n}",
                     lambda d=digits, b=b, mk=mask, s=scale, sx=sx_cols:
                     bwk.bw_gemm_fused(d, b, mk, s, None, sx, **kw),
                     "bw_gemm_fused_kernel"),
                    (f"bw_gemm N={n}",
                     lambda d=digits, b=b, mk=mask: bwk.bw_gemm(d, b, mk,
                                                                **kw),
                     "bw_gemm_i32_kernel")]
            if n not in TIMED_NS:
                continue

            # timing, L2-cold: kernel, plain version, torch._int_mm
            b8 = torch.zeros((max(8, n), k_pad), dtype=torch.int8,
                             device=dev)
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
                       "library_ms": lib_ms, "stream_ms": live_ms,
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
    counts = one_device_op_each(one_op)
    log(f"  bw_gemm, bw_gemm_fused: one device operation a call at N in "
        f"{DENSE_NS}: {len(one_op)} calls, {json.dumps(counts)}")
    return per_kernel, err


SPARSE = ("bw_gemm_sparse_fused", "bw_gemm_sparse",
          "bw_gemm_sparse_fused_pipelined", "bw_gemm_sparse_pipelined")
BASELINE = ("ent_encode", "quant_gemm_fused", "quant_gemm")
KERNELS = ("bw_gemm_fused", "bw_gemm") + SPARSE + BASELINE


def kernel_fns() -> dict:
    """Kernel name -> its wrapper, which carries the ``launches`` count."""
    from repro_torch.kernels import bw_gemm as bwk
    from repro_torch.kernels import encode, quant_gemm
    fns = {name: getattr(bwk, name) for name in KERNELS[:-3]}
    fns.update(ent_encode=encode.ent_encode,
               quant_gemm_fused=quant_gemm.quant_gemm_fused,
               quant_gemm=quant_gemm.quant_gemm)
    return fns


def zero_counts() -> None:
    for fn in kernel_fns().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_fns().items()}


SPARSE_NS = (1, 2, 3, 4, 8)          # phase 3's widths for B3-B6
B1_PLANES2 = "bw_gemm_fused on the planes=2 plan"   # the bar for B3
ACTS = (None, "silu", "gelu", "relu2")


def split_rows(sched, n: int, ctas: int) -> int:
    """m-block rows of a pipelined call whose live entries fall in more
    than one CTA's range (bw_gemm.pipelined_ranges)."""
    from repro_torch.kernels import bw_gemm as bwk
    s = sched.cpu()
    steps = s.shape[0]
    owner = {}
    for c, (lo, hi) in enumerate(bwk.pipelined_ranges(
            bwk.pipelined_work(steps, n), ctas)):
        for f in range(lo, hi):
            row, weight = int(s[f % steps, 1]), int(s[f % steps, 3])
            if weight:
                owner.setdefault((f // steps, row), set()).add(c)
    return sum(len(cs) > 1 for cs in owner.values())


def device_ops(fn, least: int = 1, tries: int = 10) -> dict:
    """Name -> count of the device operations (kernels, memsets, copies)
    that one fn() call queues, by torch.profiler: fn() runs once in a
    warm-up step and once in the active step, and only the active step
    counts (the tracer has been seen to miss a session's first launches,
    every time, once torch._int_mm has run).  A trace that holds fewer
    than ``least`` device events is taken again, up to ``tries`` times:
    the tracer has also been seen to drop the first 26 of 36 launches of
    an active step.  A trace with more events is returned as it is."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    seen = {}

    def active_step(prof):            # the step's own annotation aside
        seen.update({e.key[:60]: e.count for e in prof.key_averages()
                     if str(getattr(e, "device_type", "")).endswith("CUDA")
                     and not e.key.startswith("ProfilerStep")})

    for attempt in range(tries):
        time.sleep(0.25 * attempt)
        seen.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=active_step) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        if sum(seen.values()) >= least:
            break
        log(f"  device_ops: trace {attempt + 1} held "
            f"{sum(seen.values())} of at least {least} device events, "
            f"taken again")
    return seen


def one_device_op(what: str, call, kernel: str) -> dict:
    """torch.profiler's device operations of one call(); exactly one, a
    ``kernel``, or AssertionError."""
    seen = device_ops(call)
    if sum(seen.values()) != 1 or not all(kernel in key for key in seen):
        raise AssertionError(f"{what}: {seen} device operations a call, "
                             f"expected one {kernel}")
    return seen


def one_device_op_each(checks) -> dict:
    """torch.profiler over every call of ``checks`` ((what, call, kernel)
    triples), each call once (device_ops): the device operations must be
    exactly one ``kernel`` a call -- every operation a kernel the checks
    name, and each kernel as many times as calls name it -- or
    AssertionError.  Returns kernel -> count."""
    import collections
    want = collections.Counter(kernel for _, _, kernel in checks)

    def every_call():
        for _, call, _ in checks:
            call()

    got = collections.Counter()
    for key, count in device_ops(every_call, least=len(checks)).items():
        names = [kernel for kernel in want if kernel in key]
        if len(names) != 1:
            raise AssertionError(f"{checks[0][0]} ... {checks[-1][0]}: "
                                 f"device operation {key!r} x{count}, "
                                 f"expected only {sorted(want)}")
        got[names[0]] += count
    if got != want:
        raise AssertionError(f"{checks[0][0]} ... {checks[-1][0]}: device "
                             f"operations {dict(got)} for {len(checks)} "
                             f"calls, expected one a call: {dict(want)}")
    return dict(got)


def floor_ms() -> float:
    """The timing method's own floor: ``cuda_ms`` of an empty launch (a
    sleep kernel of 0 cycles)."""
    import torch
    return cuda_ms(lambda i: torch.cuda._sleep(0))


def stream_ms(digits, planes: int) -> float:
    """What the card streams at a kernel's size: a PyTorch reduction over
    as many L2-cold bytes as the live digit planes (digits[:planes]) --
    a reading, not a bound.  The bytes are summed as float32, which torch
    reduces without widening them (an int32 sum widens to int64 and runs
    at about half the rate)."""
    import torch
    cold = cold_copies(digits[:planes].contiguous().view(torch.float32))
    ms = cuda_ms(lambda i: cold[i % len(cold)].sum())
    del cold
    return ms


def layout_agreement() -> int:
    """The pipelined kernels' shared-memory layout as the wrapper computes
    it (bw_gemm._pipelined_layout) against the library's own
    (bw_gemm_sparse_pipelined_layout), over a grid of block shapes and
    widths: both must accept and refuse the same cases, with the same
    layout.  Returns the number of cases."""
    from repro_torch.kernels import bw_gemm as bwk
    cases = 0
    for n in (1, 2, 3, 4, 8, 16):
        for bm in (8, 16, 24, 64, 128, 256, 384, 512, 1024, 2048, 4096):
            for bk in (16, 32, 48, 128, 256, 384, 512, 1024, 2048, 4096,
                       8192):
                try:
                    want = bwk._pipelined_layout(n, bm, bk)
                except ValueError:
                    want = None
                got = bwk.pipelined_layout_of_kernel(n, bm, bk)
                if got != want:
                    raise AssertionError(
                        f"pipelined layout at N={n} block_m={bm} "
                        f"block_k={bk}: kernel {got}, wrapper {want}")
                cases += 1
    return cases


def quant_layout_agreement() -> int:
    """B8/B9's work split as the wrapper computes it (quant_gemm._layout)
    against the library's own (quant_gemm_layout), over a grid of shapes,
    designs and grids: both must accept and refuse the same cases, with
    the same layout.  Returns the number of cases."""
    from repro_torch.kernels import quant_gemm as qg
    cases = 0
    dims = (1, 3, 4, 16, 17, 64, 2304, 2311)
    for m in dims:
        for n in dims:
            for k in (16, 48, 2304, 2320, 5888):
                grids = {1, 7, 132, 270, 288, 576}
                for design in range(len(qg.DESIGNS) + 1):
                    for ctas in sorted(grids | {qg.launch_plan(
                            m, n, k, 132)["ctas"]}):
                        try:
                            want = qg._layout(m, n, k, design, ctas)
                        except ValueError:
                            want = None
                        got = qg.layout_of_kernel(m, n, k, design, ctas)
                        if got != want:
                            raise AssertionError(
                                f"quant_gemm layout at m={m} n={n} k={k} "
                                f"design={design} ctas={ctas}: kernel "
                                f"{got}, wrapper {want}")
                        cases += 1
    return cases


def sparse_cases(dev, log):
    """Phase 3, B3-B6: B4 and B3 against their plain versions on m_major
    schedules; B6 and B5 on both orders against the same plain versions
    and bit for bit against B4 and B3; timed."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import bw_gemm as bwk
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(4321)
    per_kernel = {name: [] for name in SPARSE + (B1_PLANES2,)}
    err = dict.fromkeys(SPARSE, 0.0)
    kw = dict(block_m=128, block_k=256)
    cases = 0

    def check(name, got, want, exact, what):
        torch.cuda.synchronize()
        diff = float((got - want).abs().max())
        err[name] = max(err[name], diff)
        ok = torch.equal(got, want) if exact else bool(torch.all(
            (got - want).abs() <= ACT_ATOL + ACT_RTOL * want.abs()))
        if not ok:
            raise AssertionError(f"{name} != {what}: max |diff| {diff}")

    def schedules(mask):
        return tuple(torch.from_numpy(ops.build_schedule(mask, 4, order)).to(
            dev) for order in ops.SCHEDULE_ORDERS)

    def hold(where, digits, b, scheds, scale, bias, sx_cols):
        """B3-B6 on one operand pair, every activation."""
        nonlocal cases
        sm = scheds[0]
        want = bwk.bw_gemm_sparse_plain(digits, b, sm, **kw)
        b4 = bwk.bw_gemm_sparse(digits, b, sm, **kw)
        check("bw_gemm_sparse", b4, want, True, f"plain at {where}")
        for order, sched in zip(ops.SCHEDULE_ORDERS, scheds):
            b6 = bwk.bw_gemm_sparse_pipelined(digits, b, sched, **kw)
            check("bw_gemm_sparse_pipelined", b6, want, True,
                  f"plain at {where} {order}")
            check("bw_gemm_sparse_pipelined", b6, b4, True,
                  f"bw_gemm_sparse at {where} {order}")
        for act in ACTS:
            args = (scale, bias if act else None, sx_cols)
            want = bwk.bw_gemm_sparse_fused_plain(
                digits, b, sm, *args, activation=act, **kw)
            b3 = bwk.bw_gemm_sparse_fused(digits, b, sm, *args,
                                          activation=act, **kw)
            check("bw_gemm_sparse_fused", b3, want, act is None,
                  f"plain at {where} act={act}")
            for order, sched in zip(ops.SCHEDULE_ORDERS, scheds):
                b5 = bwk.bw_gemm_sparse_fused_pipelined(
                    digits, b, sched, *args, activation=act, **kw)
                check("bw_gemm_sparse_fused_pipelined", b5, want,
                      act is None, f"plain at {where} {order} act={act}")
                check("bw_gemm_sparse_fused_pipelined", b5, b3, True,
                      f"bw_gemm_sparse_fused at {where} {order} "
                      f"act={act}")
        cases += 1

    def activations(n, k, k_pad, planes):
        x = torch.randn((n, k), generator=gen, device=dev)
        qx, sx = quant.quantize_to_planes(x, planes, axis=-1)
        b = torch.zeros((n, k_pad), dtype=torch.int8, device=dev)
        b[:, :k] = qx
        return b, sx.reshape(1, -1).contiguous()

    def plan(m, k, planes):
        w = torch.randn((k, m), generator=gen, device=dev)
        qw, sw = quant.quantize_to_planes(w, planes, axis=0)
        planned = ops.plan_operand(qw.t(), "ent", 128, 256)
        m_pad = planned.digits.shape[1]
        scale = ops._channel_rows(sw.reshape(-1), m, m_pad, planned.row_perm)
        return qw, planned, scale

    grids = {(n, fused): bwk._pipelined_ctas(dev, n, 128, 256, fused)
             for n in SPARSE_NS for fused in (False, True)}
    for n in SPARSE_NS:
        lay = bwk.pipelined_layout_of_kernel(n, 128, 256)
        log(f"  pipelined layout at N={n}, blocks 128 x 256: {lay}; grid "
            f"B6 {grids[n, False]} CTAs, B5 {grids[n, True]} CTAs")
    log(f"  pipelined layout: wrapper == kernel on "
        f"{layout_agreement()} (N, block_m, block_k) cases")
    split_seen = {}
    for m, k, per_layer in PATH_SHAPES:
        qw, planned, scale = plan(m, k, 2)
        digits = planned.digits
        m_pad, k_pad = digits.shape[1], digits.shape[2]
        masked = planned.mask.clone()
        # a False block over non-zero digits in planes 0 and 1
        for p in range(2):
            kk = p % masked.shape[2]
            if not bool(digits[p, :128, 256 * kk:256 * (kk + 1)].any()):
                raise AssertionError(f"plane {p} block (0, {kk}) is empty")
            masked[p, 0, kk] = False
        sentinel = masked.clone()
        sentinel[:, 1, :] = False              # row block 1: a sentinel
        bias = torch.randn((m_pad, 1), generator=gen, device=dev)
        wq_pad = torch.zeros((m_pad, k_pad), dtype=torch.int8, device=dev)
        wq_pad[:m, :k] = qw.t()
        timed = {}
        for n in SPARSE_NS:
            b, sx_cols = activations(n, k, k_pad, 2)
            for mask_name, mask in (("masked", masked),
                                    ("sentinel", sentinel)):
                scheds = schedules(mask)
                hold(f"M={m_pad} K={k_pad} N={n} {mask_name}", digits, b,
                     scheds, scale, bias, sx_cols)
                for order, sched in zip(ops.SCHEDULE_ORDERS, scheds):
                    split_seen[order] = split_seen.get(order, 0) + split_rows(
                        sched, n, grids[n, True])
                if mask_name == "masked":
                    timed[n] = (b, sx_cols, scheds)
        # an all-sentinel mask; a schedule shorter than the grid (a few
        # live blocks); two calls in a row on one stream
        empty = torch.zeros_like(masked)
        few = torch.zeros_like(masked)
        few[0, ::5, 0] = True
        few[1, -1, -1] = True
        b3n, sx3 = activations(3, k, k_pad, 2)
        for name, mask in (("all-sentinel", empty), ("short", few)):
            scheds = schedules(mask)
            if name == "short" and not all(
                    s.shape[0] < grids[3, f] for s in scheds
                    for f in (False, True)):
                raise AssertionError(
                    f"the short schedule ({scheds[0].shape[0]} entries) is "
                    f"not shorter than the grid")
            hold(f"M={m_pad} K={k_pad} N=3 {name} (L={scheds[0].shape[0]})",
                 digits, b3n, scheds, scale, bias, sx3)
        b_a, sx_a = timed[4][:2]
        b_b, sx_b = activations(4, k, k_pad, 2)
        sm, sk = timed[4][2]
        for order, sched in zip(ops.SCHEDULE_ORDERS, (sm, sk)):
            r6 = [bwk.bw_gemm_sparse_pipelined(digits, bb, sched, **kw)
                  for bb in (b_a, b_b)]
            r5 = [bwk.bw_gemm_sparse_fused_pipelined(
                digits, bb, sched, scale, bias, sx, activation="silu", **kw)
                for bb, sx in ((b_a, sx_a), (b_b, sx_b))]
            for i, (bb, sx) in enumerate(((b_a, sx_a), (b_b, sx_b))):
                what = f"call {i + 1} of two in a row at M={m_pad} {order}"
                check("bw_gemm_sparse_pipelined", r6[i],
                      bwk.bw_gemm_sparse(digits, bb, sm, **kw), True, what)
                check("bw_gemm_sparse_fused_pipelined", r5[i],
                      bwk.bw_gemm_sparse_fused(digits, bb, sm, scale, bias,
                                               sx, activation="silu", **kw),
                      True, what)
        cases += 1
        # planes=3: density 0.75, both orders
        _, planned3, scale3 = plan(m, k, 3)
        b43, sx43 = activations(4, k, k_pad, 3)
        hold(f"M={m_pad} K={k_pad} N=4 planes=3", planned3.digits, b43,
             schedules(planned3.mask), scale3, bias, sx43)
        del planned3

        # one device operation a call: B3 and B4, and B5 and B6 on both
        # orders
        if m == PATH_SHAPES[0][0] and k == PATH_SHAPES[0][1]:
            b, sx_cols, scheds = timed[4]
            for name, kern, call in (
                    ("bw_gemm_sparse_fused", "sparse_fused_kernel",
                     lambda: bwk.bw_gemm_sparse_fused(
                         digits, b, scheds[0], scale, bias, sx_cols,
                         activation="silu", **kw)),
                    ("bw_gemm_sparse", "sparse_i32_kernel",
                     lambda: bwk.bw_gemm_sparse(digits, b, scheds[0],
                                                **kw))):
                log(f"  {name}: device operations a call "
                    f"{one_device_op(name, call, kern)}")
            for order, sched in zip(ops.SCHEDULE_ORDERS, scheds):
                for name, call in (
                        ("bw_gemm_sparse_pipelined",
                         lambda: bwk.bw_gemm_sparse_pipelined(
                             digits, b, sched, **kw)),
                        ("bw_gemm_sparse_fused_pipelined",
                         lambda: bwk.bw_gemm_sparse_fused_pipelined(
                             digits, b, sched, scale, bias, sx_cols,
                             activation="silu", **kw))):
                    ops_seen = one_device_op(f"{name} on {order}", call,
                                             "pipelined_kernel")
                    log(f"  {name} {order}: device operations a call "
                        f"{ops_seen}")

        # timing, L2-cold, on the masked case's schedules; B1 on the same
        # plan and mask (planes 2-3 masked off) as the bar for B3
        live_ms = stream_ms(digits, 2)
        log(f"  stream_ms M={m_pad} K={k_pad} planes=2: {live_ms:.5f} ms "
            f"(float32 sum over {2 * digits[0].numel()} L2-cold bytes)")
        for n in (1, 4):
            b, sx_cols, (sm, sk) = timed[n]
            if not torch.equal(
                    bwk.bw_gemm_fused(digits, b, masked, scale, None,
                                      sx_cols, **kw),
                    bwk.bw_gemm_sparse_fused(digits, b, sm, scale, None,
                                             sx_cols, **kw)):
                raise AssertionError(f"bw_gemm_fused != bw_gemm_sparse_fused"
                                     f" on one planes=2 plan at M={m_pad} "
                                     f"N={n}")
            b8 = torch.zeros((8, k_pad), dtype=torch.int8, device=dev)
            b8[:n] = b
            wq_cold = cold_copies(wq_pad)
            lib_ms = cuda_ms(lambda i: torch._int_mm(
                wq_cold[i % len(wq_cold)], b8.t()))
            del wq_cold
            d_cold = cold_copies(digits)
            nnz = int(masked.sum())
            live_bytes = nnz * 128 * 256
            for name, sched in (("bw_gemm_sparse_fused", sm),
                                ("bw_gemm_sparse", sm),
                                ("bw_gemm_sparse_fused_pipelined", sk),
                                ("bw_gemm_sparse_pipelined", sk),
                                (B1_PLANES2, masked)):
                fused = "fused" in name
                args = (scale, None, sx_cols) if fused else ()
                kname = "bw_gemm_fused" if name == B1_PLANES2 else name
                kern = getattr(bwk, kname)
                plain = getattr(bwk, kname + "_plain")
                # bytes the call moves: live digits, activations, schedule
                # (B1: mask), the output, and the two scale vectors when
                # fused
                aux = sched.numel() * (1 if name == B1_PLANES2 else 4)
                moved = (live_bytes + b.numel() + aux
                         + 4 * m_pad * n + (4 * (m_pad + n) if fused else 0))
                row = {"m": m_pad, "k_pad": k_pad, "n": n,
                       "per_layer": per_layer,
                       "ms": cuda_ms(lambda i: kern(
                           d_cold[i % len(d_cold)], b, sched, *args, **kw)),
                       "plain_ms": cuda_ms(lambda i: plain(
                           digits, b, sched, *args, **kw), 5, 1),
                       "library_ms": lib_ms, "stream_ms": live_ms,
                       "bytes": moved,
                       "ops": 2 * live_bytes * n, "live_blocks": nnz,
                       "steps": int(sched.shape[0]),
                       "blocks": masked.numel()}
                row["bound_ms"] = 1e3 * max(row["bytes"] / HBM_BYTES_PER_S,
                                            row["ops"] / INT8_OPS_PER_S)
                per_kernel[name].append(row)
                log(f"  {name:30s} M={m_pad:5d} K={k_pad:5d} N={n}  kernel "
                    f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
                    f"_int_mm {lib_ms:.4f} ms  bound "
                    f"{row['bound_ms']:.4f} ms")
            del d_cold
    if not all(split_seen.get(order) for order in ops.SCHEDULE_ORDERS):
        raise AssertionError(f"no case split an m-block row's entries "
                             f"across CTAs: {split_seen}")
    log(f"  B3-B6: {cases} cases bit-exact (B5 == B3, B6 == B4 on both "
        f"orders); m-block rows split across CTAs, summed over the main "
        f"cases: {split_seen}")
    return per_kernel, err


def window_misses(sched, mblks: int) -> int:
    """m-blocks whose B3/B4 CTAs miss the first window of the schedule
    (bw_gemm.schedule_window) and search for their run instead."""
    from repro_torch.kernels import bw_gemm as bwk
    rows = sched[:, 1].tolist()
    misses = 0
    for mblk in range(mblks):
        start, width = bwk.schedule_window(len(rows), mblks, mblk)
        misses += not (width > 0 and (start == 0 or rows[start] < mblk) and (
            start + width == len(rows) or rows[start + width - 1] > mblk))
    return misses


def walk_cases(dev, log) -> int:
    """Phase 3, the edges of B1-B4's work split (csrc/bw_gemm.cu,
    csrc/bw_gemm_sparse.cu):
    runs of very different lengths (a 92-entry run, a sentinel-only
    m-block, so B3/B4 windows miss and CTAs search), zero-weight padding,
    block_k 16 (576-entry runs: several passes of the block list), and
    block_m 24.  At N in {1, 2, 3, 4, 8}: B2, B1 (every activation), B4
    and B3 against their plain versions, and B3 == B1, B4 == B2 bit for
    bit on the mask the schedule was built from.  Returns the cases."""
    import torch
    from repro_torch.kernels import bw_gemm as bwk
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(1618)

    def digits_of(m, k, planes):
        d = torch.randint(-2, 3, (4, m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        d[planes:] = 0
        return d

    skew = torch.rand((4, 6, 23), generator=gen, device=dev) < 0.15
    skew[:, 0] = True                   # a 92-entry run
    skew[:, 2] = False                  # a sentinel-only m-block
    uniform = torch.rand((4, 5, 9), generator=gen, device=dev) < 0.5
    uniform[2:] = False
    long_runs = torch.rand((4, 2, 144), generator=gen, device=dev) < 0.9
    small = torch.rand((4, 3, 2), generator=gen, device=dev) < 0.7
    # (what, digits, mask, block_m, block_k, extra zero-weight entries)
    setups = [("skewed 768 x 5888", digits_of(768, 5888, 4), skew, 128, 256,
               0),
              ("padded 640 x 2304", digits_of(640, 2304, 2), uniform, 128,
               256, 37),
              ("block_k 16, 256 x 2304", digits_of(256, 2304, 4), long_runs,
               128, 16, 0),
              ("block_m 24, 72 x 512", digits_of(72, 512, 3), small, 24, 256,
               0)]
    cases = 0
    for what, digits, mask, bm, bk, pad in setups:
        m, k = digits.shape[1:]
        sched = ops.build_schedule(mask, 4, "m_major")
        if pad:
            sched = ops.pad_schedule(sched, sched.shape[0] + pad)
        misses = window_misses(sched, mask.shape[1])
        sched = torch.from_numpy(sched).to(dev)
        kw = dict(block_m=bm, block_k=bk)
        scale = torch.rand((m, 1), generator=gen, device=dev) * 1e-2
        bias = torch.randn((m, 1), generator=gen, device=dev)
        for n in SPARSE_NS:
            b = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                              dtype=torch.int8)
            sx = torch.rand((1, n), generator=gen, device=dev) * 1e-1
            where = f"{what} N={n}"
            b2 = bwk.bw_gemm(digits, b, mask, **kw)
            b4 = bwk.bw_gemm_sparse(digits, b, sched, **kw)
            torch.cuda.synchronize()
            for name, got, want in (
                    ("bw_gemm", b2, bwk.bw_gemm_plain(digits, b, mask, **kw)),
                    ("bw_gemm_sparse", b4, bwk.bw_gemm_sparse_plain(
                        digits, b, sched, **kw)),
                    ("bw_gemm_sparse == bw_gemm", b4, b2)):
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} != plain at {where}")
            for act in ACTS:
                args = (scale, bias if act else None, sx)
                b1 = bwk.bw_gemm_fused(digits, b, mask, *args,
                                       activation=act, **kw)
                b3 = bwk.bw_gemm_sparse_fused(digits, b, sched, *args,
                                              activation=act, **kw)
                torch.cuda.synchronize()
                for name, got, want in (
                        ("bw_gemm_fused", b1, bwk.bw_gemm_fused_plain(
                            digits, b, mask, *args, activation=act, **kw)),
                        ("bw_gemm_sparse_fused", b3,
                         bwk.bw_gemm_sparse_fused_plain(
                             digits, b, sched, *args, activation=act,
                             **kw))):
                    ok = torch.equal(got, want) if act is None else bool(
                        torch.all((got - want).abs()
                                  <= ACT_ATOL + ACT_RTOL * want.abs()))
                    if not ok:
                        raise AssertionError(f"{name}[{act}] != plain at "
                                             f"{where}")
                if not torch.equal(b3, b1):
                    raise AssertionError(f"bw_gemm_sparse_fused[{act}] != "
                                         f"bw_gemm_fused at {where}")
            cases += 1
        log(f"  walk edges, {what}: {int(mask.sum())} live blocks, schedule "
            f"{sched.shape[0]} entries, {misses} of {mask.shape[1]} m-blocks "
            f"search past the first window; B1-B4 == plain, B3 == B1, "
            f"B4 == B2 at N in {SPARSE_NS}")
    return cases


def dense_edge_cases(dev, log) -> int:
    """Phase 3, B2 (bw_gemm, csrc/bw_gemm.cu) at the edges: weights
    planned at planes 2, 3 and 4 and bit-serially (8 planes, radix 2), and
    digits of exactly 2, 3, 4 and 8 planes, each with a False block over
    non-zero digits, at N in {1, 3, 4, 8}; a ragged 2311 x 2320 weight
    through ops.bw_gemm against the exact product, and 80 x 128 blocks on
    2320 x 2304; two calls in a row on one stream.  Every result
    bit-identical to the plain version.  Returns the cases."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import bw_gemm as bwk
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref

    gen = torch.Generator(device=dev).manual_seed(3141)
    cases = 0

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def hold(what, digits, mask, bm, bk, radix):
        nonlocal cases
        kw = dict(block_m=bm, block_k=bk, radix=radix)
        for n in (1, 3, 4, 8):
            b = int8(n, digits.shape[2])
            got = bwk.bw_gemm(digits, b, mask, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, bwk.bw_gemm_plain(digits, b, mask,
                                                      **kw)):
                raise AssertionError(f"bw_gemm != plain on {what} at "
                                     f"N={n}")
            cases += 1

    m, k = 2304, 2304
    w = torch.randn((k, m), generator=gen, device=dev)
    for planes, encoding in ((2, "ent"), (3, "ent"), (4, "ent"),
                             (4, "bitserial")):
        qw, _ = quant.quantize_to_planes(w, planes, axis=0)
        pl = ops.plan_operand(qw.t(), encoding, 128, 256)
        mask = pl.mask.clone()
        if not bool(pl.digits[0, :128, :256].any()):
            raise AssertionError(f"{encoding} planes={planes}: plane 0 "
                                 f"block (0, 0) is empty")
        mask[0, 0, 0] = False
        hold(f"{encoding} plan at planes={planes} "
             f"({pl.digits.shape[0]} digit planes)", pl.digits, mask, 128,
             256, 2 if encoding == "bitserial" else 4)
    for bw_n in (2, 3, 4, 8):
        lo, hi = (-1, 2) if bw_n == 8 else (-2, 3)
        digits = torch.randint(lo, hi, (bw_n, 640, 2304), generator=gen,
                               device=dev, dtype=torch.int8)
        mask = torch.rand((bw_n, 5, 9), generator=gen, device=dev) < 0.6
        mask[0, 0, 0] = False
        hold(f"{bw_n} digit planes", digits, mask, 128, 256,
             2 if bw_n == 8 else 4)
    # ragged: the ops layer pads a 2311 x 2320 weight to the blocks
    wq = int8(2311, 2320)
    pl = ops.plan_operand(wq, "ent", 128, 256)
    for n in (1, 4, 8):
        x = int8(2320, n)
        got = ops.bw_gemm(pl, x)
        if not torch.equal(got, kref.quant_gemm_ref(wq, x)):
            raise AssertionError(f"ops.bw_gemm != the exact product on a "
                                 f"ragged 2311 x 2320 weight at N={n}")
        cases += 1
    digits = torch.randint(-2, 3, (4, 2320, 2304), generator=gen,
                           device=dev, dtype=torch.int8)
    mask = torch.rand((4, 29, 18), generator=gen, device=dev) < 0.6
    mask[0, 0, 0] = False
    hold("2320 x 2304 at blocks 80 x 128", digits, mask, 80, 128, 4)
    # two calls in a row on one stream, different activations, one sync
    digits, mask = pl.digits, pl.mask
    kw = dict(block_m=128, block_k=256, radix=4)
    for n in (4, 8):
        bs = [int8(n, digits.shape[2]) for _ in range(2)]
        outs = [bwk.bw_gemm(digits, b, mask, **kw) for b in bs]
        torch.cuda.synchronize()
        for i, (b, got) in enumerate(zip(bs, outs)):
            if not torch.equal(got, bwk.bw_gemm_plain(digits, b, mask,
                                                      **kw)):
                raise AssertionError(f"bw_gemm call {i + 1} of two in a "
                                     f"row != plain at N={n}")
        cases += 1
    log(f"  bw_gemm edges: {cases} cases bit-identical to the plain "
        f"version (plans at planes 2, 3, 4 and bit-serial, 2-8 digit "
        f"planes, ragged, 80 x 128 blocks, two in a row)")
    return cases


def rival_wide(source, log):
    """Another design's B8/B9 source (``--rival-wide``: a quant_gemm.cu
    whose wide kernel meets its CTAs stream-K, in arrival counters and
    partial slots passed after ``out``, as the design this one replaced
    did), built like the shipped one and returned as call(a, b, out,
    scale=None), which launches its wide kernel on its own plan: its
    layout's tiles and K units, as many CTAs as fit the SMs by its shared
    memory, zeroed counters and slots of up to 128 x 256 int32 a CTA and
    tile.  Checked and timed beside the shipped wide kernel at T=512; no
    wrapper launches it."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import quant_gemm as qg
    source = Path(source).resolve()
    lib_path = _build.BUILD_DIR / f"librival-{source.stat().st_mtime_ns}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                          str(_build.CSRC), "-o", str(lib_path), str(source)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on the rival {source}:\n"
                           f"{res.stdout}{res.stderr}")
    log(f"  rival wide design {source} built in "
        f"{time.perf_counter() - t0:.1f} s")
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.quant_gemm_i32.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.quant_gemm_fused.argtypes = [p] * 7 + [i] * 8 + [p]
    lib.quant_gemm_layout.argtypes = [i] * 5 + [p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    work = {}

    def call(a, b, out, scale=None):
        m, k = a.shape
        n = b.shape[1]
        lay = (ctypes.c_int * 5)()
        if lib.quant_gemm_layout(m, n, k, qg.WIDE, 1, lay) != 0:
            raise RuntimeError(f"rival refuses wide at {m}x{n}x{k}")
        tiles, units, smem = lay[1], lay[2], lay[4]
        ctas = min(tiles * units, sms * max(1, 232448 // (smem + 1024)))
        if (tiles, ctas) not in work:
            work[tiles, ctas] = (
                torch.zeros(tiles, dtype=torch.int32, device=a.device),
                torch.empty(2 * ctas * 128 * 256, dtype=torch.int32,
                            device=a.device))
        counters, slots = (t.data_ptr() for t in work[tiles, ctas])
        stream = torch.cuda.current_stream().cuda_stream
        if scale is None:
            err = lib.quant_gemm_i32(a.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), counters, slots, m, n,
                                     k, qg.WIDE, ctas, stream)
        else:
            err = lib.quant_gemm_fused(a.data_ptr(), b.data_ptr(),
                                       scale.data_ptr(), None, out.data_ptr(),
                                       counters, slots, m, n, k, qg.WIDE,
                                       ctas, 1, 0, 0, stream)
        if err != 0:
            raise RuntimeError(f"rival launch failed with CUDA error {err}")
        return out

    return call


def baseline_cases(dev, log, rival_sources=()):
    """Phase 3, B7-B9: against their plain versions, timed; at T=512 a
    rival wide design beside B8/B9's shipped one (rival_wide)."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import encode
    from repro_torch.kernels import quant_gemm as qg

    gen = torch.Generator(device=dev).manual_seed(2718)
    per_kernel = {name: [] for name in BASELINE}
    err = dict.fromkeys(BASELINE, 0.0)
    wide_ms = {"quant_gemm": 0.0, "quant_gemm_fused": 0.0}
    wide_bound = dict(wide_ms)
    wide_lib = 0.0
    rivals = {str(src): rival_wide(src, log) for src in rival_sources}
    on_rival = {src: dict(wide_ms) for src in rivals}

    def int8(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def check(name, got, want, exact, what):
        torch.cuda.synchronize()
        diff = float((got.float() - want.float()).abs().max())
        err[name] = max(err[name], diff)
        ok = torch.equal(got, want) if exact else bool(torch.all(
            (got - want).abs() <= ACT_ATOL + ACT_RTOL * want.abs()))
        if not ok:
            raise AssertionError(f"{name} != {what}: max |diff| {diff}")

    def row(name, ms, plain_ms, lib_ms, moved, ops_n, **shape):
        r = dict(shape, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                 bytes=moved, ops=ops_n)
        r["bound_ms"] = 1e3 * max(moved / HBM_BYTES_PER_S,
                                  ops_n / INT8_OPS_PER_S)
        per_kernel[name].append(r)
        lib = "-" if lib_ms is None else f"{lib_ms:.4f}"
        log(f"  {name:16s} {shape}  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  _int_mm {lib} ms  bound "
            f"{r['bound_ms']:.4f} ms")

    # B7 ent_encode at the plan shapes: uniform int8, and a seeded weight
    # on the planes=3 grid (plane 3 empty), and the 256 int8 values, at
    # every block shape of ENCODE_BLOCKS, and a byte planted a block where
    # only the last warp's flags can set the mask; one device operation a
    # call; timed at the plans' blocks
    kw7 = dict(block_m=128, block_k=256)
    every = torch.arange(-128, 128, dtype=torch.int8,
                         device=dev).repeat(384).reshape(384, 256)
    cases = [("all 256 int8 values", every)]
    for m, k, per_layer in PATH_SHAPES + ((768, 4096, 0),):
        w = torch.randn((m, k), generator=gen, device=dev)
        cases += [(f"uniform {m}x{k}", int8(m, k)),
                  (f"planes=3 {m}x{k}",
                   quant.quantize_to_planes(w, 3, axis=1)[0].contiguous())]
    def planted(bm, bk, m=768, k=4096):
        """Zeros, and in block (i, j) the byte ENCODE_PLANTED[(i * kb +
        j) % 10] in the block's last row and last 16-byte chunk, at
        column (i * kb + j) % 16 of it."""
        x = torch.zeros((m, k), dtype=torch.int8, device=dev)
        kb = k // bk
        i = torch.arange(m // bm, device=dev)[:, None]
        j = torch.arange(kb, device=dev)[None, :]
        at = (i * kb + j).expand(m // bm, kb)
        vals = torch.tensor(ENCODE_PLANTED, dtype=torch.int8, device=dev)
        x[i * bm + bm - 1, j * bk + bk - 16 + at % 16] = \
            vals[at % len(ENCODE_PLANTED)]
        return x

    checks = []
    for bm, bk in ENCODE_BLOCKS:
        blocks = dict(block_m=bm, block_k=bk)
        for what, x in cases + [("one byte a block, in the last warp's "
                                 "last chunk", planted(bm, bk))]:
            if x.shape[0] % bm or x.shape[1] % bk:
                continue
            d, mask = encode.ent_encode(x, **blocks)
            dp, mp = encode.ent_encode_plain(x, **blocks)
            where = f"{what}, blocks {bm} x {bk}"
            check("ent_encode", d, dp, True, f"plain digits on {where}")
            check("ent_encode", mask, mp, True, f"plain mask on {where}")
            planes = mp.flatten(1)
            if what.startswith("one byte") and (
                    bool(planes.all(1).any()) or not bool(planes.any(1).all())):
                raise AssertionError(f"ent_encode: the planted mask on "
                                     f"{where} has a full or empty plane")
            checks.append((f"ent_encode {where}",
                           lambda x=x, blocks=blocks: encode.ent_encode(
                               x, **blocks), "ent_encode_kernel"))
    counts = one_device_op_each(checks)
    log(f"  ent_encode: bit-identical to the plain version on "
        f"{len(checks)} (input, blocks) cases, blocks {ENCODE_BLOCKS}; "
        f"one device operation a call: {json.dumps(counts)}")
    for m, k, per_layer in PATH_SHAPES:
        x = cases[[c[0] for c in cases].index(f"planes=3 {m}x{k}")][1]
        x_cold = cold_copies(x)
        row("ent_encode",
            cuda_ms(lambda i: encode.ent_encode(x_cold[i % len(x_cold)],
                                                **kw7)),
            cuda_ms(lambda i: encode.ent_encode_plain(x, **kw7), 5, 1), None,
            5 * m * k + 4 * (m // 128) * (k // 256), 0, m=m, k_pad=k,
            n=None, per_layer=per_layer)
        del x_cold

    # B9 quant_gemm and B8 quant_gemm_fused at every width T, each in both
    # orientations: the weight as A [M, K] with T token columns B [K, T]
    # (B9 as the planned path calls it) and T token rows A [T, K] with the
    # weight as B [K, M] (B8 as the serving path calls it); a ragged shape
    # as well (M and K multiples of no tile but 16)
    def orientations(w, wt, x, xt):
        return (("weight as A", w, xt), ("weight as B", x, wt))

    def whole(a, b):
        """Blocks of the reference's contract that divide any shape."""
        return dict(block_m=a.shape[0], block_n=b.shape[1], block_k=16)

    for m, k, per_layer in PATH_SHAPES + (RAGGED_SHAPE,):
        w = int8(m, k)                     # the weight's rows [M, K]
        wt = w.t().contiguous()            # [K, M]
        for t in QUANT_TS:
            x = int8(t, k)
            xt = x.t().contiguous()
            for orient, a, b in orientations(w, wt, x, xt):
                where = f"M={m} K={k} T={t} {orient}"
                blocks = whole(a, b)
                check("quant_gemm", qg.quant_gemm(a, b, **blocks),
                      qg.quant_gemm_plain(a, b, **blocks), True,
                      f"plain at {where}")
                for axis in ("n", "m"):
                    shape = ((1, b.shape[1]) if axis == "n"
                             else (a.shape[0], 1))
                    scale = torch.rand(shape, generator=gen,
                                       device=dev) * 1e-3
                    bias = torch.randn(shape, generator=gen, device=dev)
                    for act in ACTS:
                        for bb in (None, bias):
                            fkw = dict(blocks, activation=act,
                                       epilogue_axis=axis)
                            check("quant_gemm_fused",
                                  qg.quant_gemm_fused(a, b, scale, bb, **fkw),
                                  qg.quant_gemm_fused_plain(a, b, scale, bb,
                                                            **fkw),
                                  act is None, f"plain at {where} "
                                  f"axis={axis} act={act} "
                                  f"bias={bb is not None}")
                    bkw = dict(blocks, epilogue_axis=axis,
                               out_dtype=torch.bfloat16)
                    check("quant_gemm_fused",
                          qg.quant_gemm_fused(a, b, scale, bias, **bkw),
                          qg.quant_gemm_fused_plain(a, b, scale, bias, **bkw),
                          True, f"plain at {where} axis={axis} bf16")
            if per_layer == 0 or t not in (4, 512):
                continue
            # timing, L2-cold on the weight: B9 (weight as A), B8 (weight
            # as B, axis 'n', no bias), their plain versions, torch._int_mm
            # on the same product
            kw9 = dict(block_m=128, block_n=min(t, 128), block_k=256)
            kw8 = dict(block_m=min(t, 128), block_n=128, block_k=256)
            xpad = torch.zeros((max(8, t), k), dtype=torch.int8, device=dev)
            xpad[:t] = x
            w_cold = cold_copies(w)
            where = f"M={m} K={k} T={t}"
            try:
                torch._int_mm(w, xpad.t())
                lib_ms = cuda_ms(lambda i: torch._int_mm(
                    w_cold[i % len(w_cold)], xpad.t()))
            except RuntimeError as e:
                log(f"  torch._int_mm unavailable at {where}: {e}")
                lib_ms = None
            shape = dict(m=m, k_pad=k, n=t, per_layer=per_layer)
            wt_cold = cold_copies(wt)
            scale = torch.rand((1, m), generator=gen, device=dev)
            b9 = (lambda i: qg.quant_gemm(w_cold[i % len(w_cold)], xt, **kw9))
            b8 = (lambda i: qg.quant_gemm_fused(
                x, wt_cold[i % len(wt_cold)], scale, **kw8))
            row("quant_gemm", cuda_ms(b9),
                cuda_ms(lambda i: qg.quant_gemm_plain(w, xt, **kw9), 5, 1),
                lib_ms, m * k + k * t + 4 * m * t, 2 * m * t * k, **shape)
            row("quant_gemm_fused", cuda_ms(b8),
                cuda_ms(lambda i: qg.quant_gemm_fused_plain(
                    x, wt, scale, **kw8), 5, 1),
                lib_ms, t * k + k * m + 4 * t * m + 4 * m, 2 * m * t * k,
                **shape)
            for src, rival in rivals.items() if t == 512 else ():
                # a rival wide design: checked and timed the same way,
                # beside the shipped one, on its own plan
                o9 = torch.empty((m, t), dtype=torch.int32, device=dev)
                o8 = torch.empty((t, m), dtype=torch.float32, device=dev)
                r9 = (lambda i: rival(w_cold[i % len(w_cold)], xt, o9))
                r8 = (lambda i: rival(x, wt_cold[i % len(wt_cold)], o8,
                                      scale))
                check("quant_gemm", r9(0), qg.quant_gemm_plain(
                    w_cold[0], xt, **kw9), True, f"plain, {src}, at {where}")
                check("quant_gemm_fused", r8(0), qg.quant_gemm_fused_plain(
                    x, wt_cold[0], scale, **kw8), True,
                    f"plain, {src}, at {where}")
                for name, call in (("quant_gemm", r9),
                                   ("quant_gemm_fused", r8)):
                    on_rival[src][name] += cuda_ms(call) * per_layer
            if t == 512:
                for name in wide_ms:
                    wide_ms[name] += per_kernel[name][-1]["ms"] * per_layer
                    wide_bound[name] += (per_kernel[name][-1]["bound_ms"]
                                         * per_layer)
                wide_lib += (lib_ms or 0.0) * per_layer
            del w_cold, wt_cold
    log(f"  wide kernel, one layer's seven calls at T=512 (ms): shipped "
        f"{json.dumps(wide_ms)}, rivals {json.dumps(on_rival)}, _int_mm "
        f"{wide_lib:.5f}, floor_ms {7 * floor_ms():.5f}, bound "
        f"{json.dumps(wide_bound)}")
    log(f"  quant_gemm, quant_gemm_fused: bit-identical to the plain "
        f"versions (with an activation within tolerance) at T in "
        f"{QUANT_TS}, both orientations, shapes {PATH_SHAPES} and ragged "
        f"{RAGGED_SHAPE[:2]}, both epilogue axes, with and without bias, "
        f"float32 and bfloat16")

    # two calls in a row on one stream, different operands, one sync:
    # neither result may depend on the other call
    m, k, _ = PATH_SHAPES[0]
    w = int8(m, k)
    wt = w.t().contiguous()
    scale = torch.rand((1, m), generator=gen, device=dev)
    for t in (4, 512):
        calls = []
        for _ in range(2):
            x = int8(t, k)
            xt = x.t().contiguous()
            sm = scale.t().contiguous()
            calls.append((x, xt,
                          qg.quant_gemm(w, xt, **whole(w, xt)),
                          qg.quant_gemm(x, wt, **whole(x, wt)),
                          qg.quant_gemm_fused(x, wt, scale, **whole(x, wt)),
                          qg.quant_gemm_fused(w, xt, sm, epilogue_axis="m",
                                              **whole(w, xt))))
        for i, (x, xt, g9a, g9b, g8b, g8a) in enumerate(calls):
            what = f"plain, call {i + 1} of two in a row at T={t}"
            check("quant_gemm", g9a,
                  qg.quant_gemm_plain(w, xt, **whole(w, xt)), True, what)
            check("quant_gemm", g9b,
                  qg.quant_gemm_plain(x, wt, **whole(x, wt)), True, what)
            check("quant_gemm_fused", g8b, qg.quant_gemm_fused_plain(
                x, wt, scale, **whole(x, wt)), True, what)
            check("quant_gemm_fused", g8a, qg.quant_gemm_fused_plain(
                w, xt, scale.t().contiguous(), epilogue_axis="m",
                **whole(w, xt)), True, what)

    # one device operation a call at every width (torch.profiler, one
    # session over every call)
    symbol = ("quant_rows_kernel", "quant_cols_kernel", "quant_wide_kernel")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    checks = []
    for t in QUANT_TS:
        x = int8(t, k)
        xt = x.t().contiguous()
        for orient, a, b in orientations(w, wt, x, xt):
            kern = symbol[qg.launch_plan(a.shape[0], b.shape[1], k,
                                         sms)["design"]]
            s = torch.rand((1, b.shape[1]), generator=gen, device=dev)
            kw = whole(a, b)
            where = f"M={m} K={k} T={t} {orient}"
            checks += [
                (f"quant_gemm {where}",
                 lambda a=a, b=b, kw=kw: qg.quant_gemm(a, b, **kw), kern),
                (f"quant_gemm_fused {where}",
                 lambda a=a, b=b, s=s, kw=kw: qg.quant_gemm_fused(a, b, s,
                                                                  **kw),
                 kern)]
    counts = one_device_op_each(checks)
    log(f"  quant_gemm, quant_gemm_fused: one device operation a call at "
        f"T in {QUANT_TS}, both orientations: {len(checks)} calls, "
        f"{json.dumps(counts)}")
    log(f"  quant_gemm layout: wrapper == library in "
        f"{quant_layout_agreement()} cases")
    return per_kernel, err


def kernel_api_pass(params, dev, log) -> dict:
    """Phase 5: the kernel-level ops API on every dense weight of the
    served model at the main path's planes=3 spec, one weight at a time.

    Per weight: the plan with encode_impl='kernel' (B7) equals the
    oracle's; B9 on the planned orientation equals B2 on the plan, and B8
    on the serving orientation equals B1, bit for bit (then both again
    with silu).  Returns the launch counts of the plain pass and of the
    silu pass, and the host seconds spent planning with each encoder."""
    import torch
    from repro_torch.core import quant
    from repro_torch.engine import QuantSpec
    from repro_torch.kernels import ops

    spec = QuantSpec.parse("planes=3,encoding=ent,act_quant=per_token,"
                           "impl=pallas_fused")

    def walk(node, out):
        if isinstance(node, list):
            for v in node:
                walk(v, out)
        elif isinstance(node, dict):
            w = node.get("w")
            if isinstance(w, torch.Tensor) and w.dim() == 2:
                out.append(w)
            for v in node.values():
                walk(v, out)
        return out
    weights = walk(params, [])
    gen = torch.Generator(device=dev).manual_seed(314)
    plan_s = {"kernel": 0.0, "ref": 0.0}
    passes = {"plain": dict.fromkeys(KERNELS, 0),
              "silu": dict.fromkeys(KERNELS, 0)}
    silu_diff = 0.0
    silu_equal = True

    def tally(which, before):
        for name, count in read_counts().items():
            passes[which][name] += count - before[name]

    zero_counts()
    for idx, w in enumerate(weights):
        k, n = w.shape
        qw, sw = quant.quantize_for_spec(w.to(torch.float32), spec, axis=0)
        bm, bk, _ = ops.select_block_sizes(n, k, 128, spec)
        before = read_counts()
        plans = {}
        # alternate which encoder plans first, so neither always finds
        # the weight in L2
        for impl in (("kernel", "ref") if idx % 2 == 0 else ("ref",
                                                             "kernel")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plans[impl] = ops.plan_operand(qw.t(), spec.encoding, bm, bk,
                                           encode_impl=impl, bits=spec.bits)
            torch.cuda.synchronize()
            plan_s[impl] += time.perf_counter() - t0
        planned = plans["kernel"]
        for field in ("digits", "mask", "schedule", "row_perm", "inv_perm"):
            if not torch.equal(getattr(planned, field),
                               getattr(plans["ref"], field)):
                raise AssertionError(f"weight {idx} {tuple(w.shape)}: "
                                     f"kernel-encoded plan's {field} != "
                                     f"the oracle's")
        del plans
        x = torch.randn((4, k), generator=gen, device=dev)
        xq, _ = quant.quantize_for_spec(x, spec, axis=-1)     # per token
        # B8 has no per-token axis: its scale is sw times the per-tensor
        # activation scale of the same x (the check is the identity of
        # the two kernels)
        _, sx = quant.quantize_for_spec(x, spec)
        s = (sw.reshape(-1) * sx).contiguous()
        got9 = ops.quant_gemm(qw.t(), xq.t())
        got2 = ops.bw_gemm(planned, xq.t())
        got8 = ops.quant_gemm_fused(xq, qw, s).t()
        got1 = ops.bw_gemm_fused(planned, xq.t(), s)
        torch.cuda.synchronize()
        if not torch.equal(got9, got2):
            raise AssertionError(f"weight {idx} {tuple(w.shape)}: "
                                 f"quant_gemm != bw_gemm")
        if not torch.equal(got8, got1):
            raise AssertionError(f"weight {idx} {tuple(w.shape)}: "
                                 f"quant_gemm_fused != bw_gemm_fused")
        tally("plain", before)
        before = read_counts()
        got8 = ops.quant_gemm_fused(xq, qw, s, activation="silu").t()
        got1 = ops.bw_gemm_fused(planned, xq.t(), s, activation="silu")
        torch.cuda.synchronize()
        tally("silu", before)
        silu_diff = max(silu_diff, float((got8 - got1).abs().max()))
        silu_equal = silu_equal and torch.equal(got8, got1)
        if not bool(torch.all((got8 - got1).abs()
                              <= ACT_ATOL + ACT_RTOL * got1.abs())):
            raise AssertionError(f"weight {idx} {tuple(w.shape)}: silu "
                                 f"quant_gemm_fused != bw_gemm_fused")
        del planned, got9, got2, got8, got1
    return {"weights": len(weights), "launches": passes,
            "plan_s": plan_s, "silu_max_abs_diff": silu_diff,
            "silu_bit_identical": silu_equal}


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
               for k in set(SYMBOLS.values())}
    kern_calls = {k: sum(e.count for e in kernels if k in e.key)
                  for k in set(SYMBOLS.values())}
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    return {"steps": steps,
            "device_ms_per_step": total_us / 1e3 / steps,
            "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
            "kernel_ms_per_step": {k: v / 1e3 / steps
                                   for k, v in kern_us.items()},
            "kernel_ops_per_step": {k: v / steps
                                    for k, v in kern_calls.items()},
            "top_kernels": [(e.key[:90], dev_us(e) / 1e3 / steps,
                             e.count / steps) for e in top]}


# served kernel -> its CUDA symbol in profiler events
SYMBOLS = {"bw_gemm_fused": "bw_gemm_fused_kernel",
           "bw_gemm": "bw_gemm_i32_kernel",
           "bw_gemm_sparse_fused": "sparse_fused_kernel",
           "bw_gemm_sparse": "sparse_i32_kernel",
           "bw_gemm_sparse_fused_pipelined": "pipelined_kernel"}


def serve(cfg, params, spec_text, prompts, dev):
    import torch
    from repro_torch.engine import QuantSpec
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.request import ServeRequest

    t0 = time.perf_counter()
    eng = ServeEngine(cfg, 4, 64, quant=QuantSpec.parse(spec_text),
                      params=params, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reqs = [ServeRequest(i, list(p), 16) for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    stats = eng.run(reqs)
    launches = read_counts()
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
    if spec_text.endswith(("pallas_sparse", "pallas_pipelined")):
        stats["unfused"] = unfused_routes(eng, dev)
    del eng, logits
    torch.cuda.empty_cache()
    return tokens, stats


def unfused_routes(eng, dev) -> dict:
    """B4 / B6, the unfused twins, on a served engine's planned weights:
    every weight's record through planned_dense_apply(fused=False) on the
    engine's sparse route (dispatch 'sparse' on m_major plans, 'pipelined'
    on k_major ones), held bit-identical to the dense route (B2) on the
    same record and batch-4 activations.  Returns the launch counts."""
    import torch
    from repro_torch.kernels import ops

    order = "k_major" if eng.spec.impl == "pallas_pipelined" else "m_major"
    route = "pipelined" if order == "k_major" else "sparse"
    gen = torch.Generator(device=dev).manual_seed(99)

    # records is passed down, not closed over: the recursive closure's
    # reference cycle must not keep the engine's plans alive
    def walk(node, records):
        if isinstance(node, list):
            for v in node:
                walk(v, records)
        elif isinstance(node, dict):
            if "w_plan" in node:
                records.append((node["w_plan"], node["w"].shape))
            for key, v in node.items():
                if key != "w_plan":
                    walk(v, records)
        return records
    records = walk(eng.params, [])
    outs = []
    zero_counts()
    for plan, (k, n_out) in records:
        x = torch.randn((4, k), generator=gen, device=dev)
        outs.append((plan, x, n_out, ops.planned_dense_apply(
            plan, x, eng.spec, n_out, fused=False, dispatch=route,
            order=order)))
    launches = read_counts()
    for plan, x, n_out, got in outs:
        want = ops.planned_dense_apply(plan, x, eng.spec, n_out,
                                       fused=False, dispatch="dense")
        if not torch.equal(got, want):
            raise AssertionError(f"unfused {route} route != dense route")
    return {"route": route, "weights": len(records), "launches": launches}


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rival-wide", metavar="QUANT_GEMM_CU",
                        action="append", default=[],
                        help="another design's csrc/quant_gemm.cu (its wide "
                             "kernel meeting stream-K), checked and timed "
                             "beside the shipped wide B8/B9 kernel at T=512 "
                             "(phase 3); may be given more than once")
    args = parser.parse_args(argv)
    print(card_line(), flush=True)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.configs.minicpm_2b import CONFIG
    from repro_torch.kernels import _build
    from repro_torch.models.api import get_api

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build: one nvcc per source, all started together ----------------
    t0 = time.perf_counter()
    _build.load_all()
    log(f"[build] {', '.join(_build.SOURCES)}: "
        f"{time.perf_counter() - t0:.1f} s")
    spills = []
    for name in _build.SOURCES:
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if any(w in line for w in ("Function properties", "registers",
                                       "spill")):
                log(f"  {line.strip()}")
            if "spill" in line and not line.strip().endswith(
                    "0 bytes spill stores, 0 bytes spill loads"):
                spills.append(f"{name}: {line.strip()}")
    if spills:
        raise AssertionError(f"ptxas reports spills: {spills}")

    # -- 3. kernels against their plain versions -----------------------------
    log("[kernels] bit-exact and timed against the plain versions")
    floor = floor_ms()
    log(f"  floor_ms {floor:.5f}: cuda_ms of an empty launch")
    per_kernel, err = kernel_cases(dev, log)
    for rows, errs in (sparse_cases(dev, log),
                       baseline_cases(dev, log, args.rival_wide)):
        per_kernel.update(rows)
        err.update(errs)
    log(f"  B1-B4 walk edges: {walk_cases(dev, log)} cases")
    dense_edge_cases(dev, log)

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
    # (plane budget, impl) -> the kernel its run must launch, or None
    routes = {(3, "pallas_fused"): "bw_gemm_fused", (3, "pallas"): "bw_gemm",
              (3, "planes"): None, (2, "pallas_fused"): "bw_gemm_fused",
              (2, "pallas_sparse"): "bw_gemm_sparse_fused",
              (2, "pallas_pipelined"): "bw_gemm_sparse_fused_pipelined"}
    runs = {}
    for (planes, impl), kern in routes.items():
        spec = f"planes={planes},encoding=ent,act_quant=per_token,impl={impl}"
        tokens, stats = serve(cfg, params, spec, prompts, dev)
        runs[planes, impl] = {"tokens": tokens, "stats": stats}
        log(f"[path] planes={planes} impl={impl}: "
            f"{stats['generated_tokens']} tokens in "
            f"{stats['engine_steps']} steps, {stats['tok_per_s']:.2f} "
            f"tok/s, {stats['ms_per_step']:.3f} ms/step, peak "
            f"{stats['peak_mem_gb']:.2f} GB, set-up {stats['setup_s']:.1f} s,"
            f" launches {stats['launches']}  ({kind})")
        log(f"[profile] planes={planes} impl={impl}: "
            f"{json.dumps(stats['profile'])}")
        per_step = stats["profile"].get("kernel_ms_per_step", {})
        if kern in SYMBOLS and SYMBOLS[kern] in per_step:
            ops_step = stats["profile"]["kernel_ops_per_step"][SYMBOLS[kern]]
            log(f"[profile] planes={planes} impl={impl}: {kern} "
                f"{per_step[SYMBOLS[kern]]:.3f} ms a step, "
                f"{1e3 * per_step[SYMBOLS[kern]] / (7 * cfg.n_layers):.2f} "
                f"us a launch; {ops_step:g} of its device operations a "
                f"step for {7 * cfg.n_layers} calls  ({kind})")
        if "unfused" in stats:
            log(f"[path] planes={planes} impl={impl} unfused route: "
                f"{json.dumps(stats['unfused'])}")
        want = 7 * cfg.n_layers * stats["engine_steps"]
        expect = {name: want if name == kern else 0 for name in KERNELS}
        if stats["launches"] != expect:
            raise AssertionError(f"planes={planes} impl={impl}: launches "
                                 f"{stats['launches']}, expected {expect}")
        if any(len(t) != 16 for t in tokens):
            raise AssertionError(f"planes={planes} impl={impl}: a request "
                                 f"did not generate 16 tokens")
    for planes, impl in routes:
        base = runs[planes, "pallas_fused"]["tokens"]
        if runs[planes, impl]["tokens"] != base:
            raise AssertionError(f"planes={planes} impl={impl} tokens "
                                 f"differ from impl=pallas_fused")
    for impl, kern in (("pallas_sparse", "bw_gemm_sparse"),
                       ("pallas_pipelined", "bw_gemm_sparse_pipelined")):
        unfused = runs[2, impl]["stats"]["unfused"]
        expect = {name: unfused["weights"] if name == kern else 0
                  for name in KERNELS}
        if unfused["launches"] != expect:
            raise AssertionError(f"{impl} unfused route: launches "
                                 f"{unfused['launches']}, expected {expect}")
    log("[path] planes=3: pallas_fused, pallas and planes emit the same "
        "tokens; planes=2: pallas_fused, pallas_sparse and pallas_pipelined"
        " emit the same tokens")

    # -- 5. the kernel-level API on every weight of the model ----------------
    t0 = time.perf_counter()
    api = kernel_api_pass(params, dev, log)
    api_s = time.perf_counter() - t0
    n_w = api["weights"]
    if n_w != 7 * cfg.n_layers:
        raise AssertionError(f"kernel API pass: {n_w} weights, expected "
                             f"{7 * cfg.n_layers}")
    expect = {"plain": {name: n_w if name in ("ent_encode", "quant_gemm",
                                              "quant_gemm_fused", "bw_gemm",
                                              "bw_gemm_fused") else 0
                        for name in KERNELS},
              "silu": {name: n_w if name in ("quant_gemm_fused",
                                             "bw_gemm_fused") else 0
                       for name in KERNELS}}
    if api["launches"] != expect:
        raise AssertionError(f"kernel API pass: launches {api['launches']},"
                             f" expected {expect}")
    log(f"[api] {n_w} weights in {api_s:.1f} s: kernel-encoded plans equal "
        f"the oracle's; quant_gemm == bw_gemm and quant_gemm_fused == "
        f"bw_gemm_fused bit for bit; with silu max |diff| "
        f"{api['silu_max_abs_diff']} (bit-identical: "
        f"{api['silu_bit_identical']}); host s to plan all {n_w}: "
        f"encode_impl=kernel {api['plan_s']['kernel']:.3f}, ref "
        f"{api['plan_s']['ref']:.3f} (both sort rows by the oracle's "
        f"digits: the kernel replaces one of two encodes a weight); "
        f"launches {json.dumps(api['launches'])}  ({kind})")

    # -- the kernels line ----------------------------------------------------
    replaces = {"bw_gemm_fused": "src/repro/kernels/bw_gemm.py:215",
                "bw_gemm": "src/repro/kernels/bw_gemm.py:140",
                "bw_gemm_sparse_fused": "src/repro/kernels/bw_gemm.py:393",
                "bw_gemm_sparse": "src/repro/kernels/bw_gemm.py:316",
                "bw_gemm_sparse_fused_pipelined":
                    "src/repro/kernels/bw_gemm.py:678",
                "bw_gemm_sparse_pipelined":
                    "src/repro/kernels/bw_gemm.py:583",
                "ent_encode": "src/repro/kernels/encode.py:46",
                "quant_gemm_fused": "src/repro/kernels/quant_gemm.py:80",
                "quant_gemm": "src/repro/kernels/quant_gemm.py:33"}
    launches = {"bw_gemm_fused": runs[3, "pallas_fused"],
                "bw_gemm": runs[3, "pallas"],
                "bw_gemm_sparse_fused": runs[2, "pallas_sparse"],
                "bw_gemm_sparse_fused_pipelined": runs[2, "pallas_pipelined"]}
    unfused = {"bw_gemm_sparse": runs[2, "pallas_sparse"],
               "bw_gemm_sparse_pipelined": runs[2, "pallas_pipelined"]}
    def layer_sums(name, n):
        """One layer's seven calls of a kernel at N=n (B7: its one row a
        shape), summed per key; None where a call has no number."""
        rows = [r for r in per_kernel[name] if r["n"] in (n, None)]
        out = {}
        for key in ("ms", "plain_ms", "library_ms", "bytes", "ops"):
            vals = [r[key] for r in rows]
            out[key] = None if any(v is None for v in vals) else sum(
                v * r["per_layer"] for v, r in zip(vals, rows))
        return out

    wide = {}
    for name in ("bw_gemm_fused", "bw_gemm", "quant_gemm_fused",
                 "quant_gemm"):
        sums = layer_sums(name, 512)
        sums["bound_ms"] = 1e3 * max(sums["bytes"] / HBM_BYTES_PER_S,
                                     sums["ops"] / INT8_OPS_PER_S)
        wide[name] = sums
    log(f"[kernels] one layer's seven calls at N=512: {json.dumps(wide)}")
    bar = {name: layer_sums(name, 4)["ms"]
           for name in (B1_PLANES2, "bw_gemm_sparse_fused")}
    stream = {name: sum(r["stream_ms"] * r["per_layer"]
                        for r in per_kernel[name] if r["n"] == 4)
              for name in ("bw_gemm_fused", "bw_gemm_sparse_fused")}
    log(f"[kernels] one layer's seven calls at N=4 on the planes=2 plan: "
        f"bw_gemm_fused {bar[B1_PLANES2]:.4f} ms, bw_gemm_sparse_fused "
        f"{bar['bw_gemm_sparse_fused']:.4f} ms; stream_ms of the live "
        f"digits: planes=3 {stream['bw_gemm_fused']:.4f}, planes=2 "
        f"{stream['bw_gemm_sparse_fused']:.4f}; floor_ms x 7 "
        f"{7 * floor:.4f}  ({kind})")
    kernels = []
    for name in KERNELS:
        sums = layer_sums(name, 4)
        bytes_ms = 1e3 * sums["bytes"] / HBM_BYTES_PER_S
        ops_ms = 1e3 * sums["ops"] / INT8_OPS_PER_S
        if name in launches:
            count = launches[name]["stats"]["launches"][name]
        elif name in unfused:
            count = unfused[name]["stats"]["unfused"]["launches"][name]
        else:
            count = api["launches"]["plain"][name]
        source = {"bw_gemm_fused": "bw_gemm.cu", "bw_gemm": "bw_gemm.cu",
                  "ent_encode": "encode.cu",
                  "quant_gemm_fused": "quant_gemm.cu",
                  "quant_gemm": "quant_gemm.cu"}.get(name,
                                                     "bw_gemm_sparse.cu")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces[name], "launches": count,
            "max_abs_err": err[name],
            "ms": sums["ms"], "plain_ms": sums["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": sums["library_ms"], "floor_ms": floor})
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
