"""Measured autotuner for the bw_gemm kernel path (the reference's
``repro.kernels.autotune``).

``select_block_sizes``' static table guesses block shapes from (M, K, N)
thresholds; this module measures instead: it sweeps ``(block_m, block_k,
block_n, dispatch, schedule order, pipelined)`` candidates on the port's
kernel routes, times them, and persists the winners to a JSON cache keyed
by

    (M, K, N) x spec.plan_key() x measuring backend x density-bucket

Every key (and entry) carries the **measuring backend** of the device the
sweep ran on: ``interpret`` on the CPU, where the kernels' plain versions
stand in for them as interpret mode stands in for Pallas in the reference
(so CPU keys equal the reference's), and ``torch.cuda.get_device_name``
on a card (e.g. ``NVIDIA H100 80GB HBM3``).  Lookups only see entries
measured on the backend of the device they plan or run on.  Entries
without a backend tag fail validation and loading (format version 2, the
reference's).

The cache backs the two dispatch seams of the execution path:

- ``ops.select_block_sizes`` consults the shape-level entry for tuned
  block sizes and falls back to the static table on a miss (with an
  ``AutotuneCacheMissWarning`` when the cache was explicitly configured
  through ``REPRO_AUTOTUNE_CACHE``, never a crash);
- ``ops.planned_dense_apply``'s ``dispatch='auto'`` consults the
  density-bucket entry for a measured sparse/dense winner and falls back
  to the ``SPARSE_DENSITY_THRESHOLD`` heuristic.

The default cache (``autotune_cache.json`` next to this module) is a copy
of the reference's 20 ``interpret`` entries, which cover the CI shapes:
on the CPU the port plans those shapes with the reference's blocks, and
on a card every lookup misses, so the static table and the threshold
decide.  Card-measured winners go to a file the caller names (``--cache``,
or ``REPRO_AUTOTUNE_CACHE``, which makes the cache strict).  Sweep with::

    PYTHONPATH=src python -m repro_torch.kernels.autotune --sweep \\
        --cache tuned.json [--device cpu]

and validate with::

    PYTHONPATH=src python -m repro_torch.kernels.autotune --validate

A candidate is timed on the CPU by wall clock (best of ``iters``), as in
the reference; on the card by device time: each call is queued behind a
sleep kernel between a CUDA event pair, and the median pair is kept, with
the digit planes cycled through copies that together exceed the L2 (host
wall time would rank every route about equal: a call's launch costs about
as much as the kernel).
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
import warnings
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import chaos as _chaos
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.calibrate import get_calibrator

__all__ = ["AutotuneCache", "AutotuneCacheMissWarning", "get_cache",
           "set_cache", "reset_cache", "cache_key", "density_bucket",
           "candidate_configs", "autotune_gemm", "current_backend",
           "validate", "CI_SHAPES", "ROUTE_CANDIDATES",
           "DEFAULT_CACHE_PATH", "ENV_VAR"]

ENV_VAR = "REPRO_AUTOTUNE_CACHE"
DEFAULT_CACHE_PATH = os.path.join(os.path.dirname(__file__),
                                  "autotune_cache.json")
# v2: backend-tagged keys/entries + (order, pipelined) config knobs
CACHE_FORMAT_VERSION = 2

# Upper edges of the plane-block density buckets a measurement is filed
# under (density = nnz plane-blocks / total plane-blocks of the plan).
DENSITY_BUCKETS = (0.1, 0.25, 0.5, 0.75, 1.0)

# (M, K, N) GEMM shapes the reference's CI lanes exercise (M = kernel rows
# = output channels of the planned weight; N = tokens).  The checked-in
# cache must cover these -- `--validate` asserts it.
CI_SHAPES = (
    (256, 256, 128),    # kernel.bw_gemm_sparse density sweep
    (192, 256, 128),    # kernel.bw_gemm_fused / quantized_dense plan
)

# The CPU's backend tag: the plain versions stand in for the kernels there
INTERPRET = "interpret"


class AutotuneCacheMissWarning(UserWarning):
    """An explicitly configured autotune cache had no entry for a shape;
    the static block-size table was used instead."""


# pre-bound obs counters (see repro_torch.obs.metrics.GLOSSARY)
_M_HITS = obs_metrics.get_registry().counter(
    "repro_autotune_cache_hits_total")
_M_MISSES = obs_metrics.get_registry().counter(
    "repro_autotune_cache_misses_total")
_M_MISS_WARNINGS = obs_metrics.get_registry().counter(
    "repro_autotune_miss_warnings_total")
_M_VMEM_REJECTED = obs_metrics.get_registry().counter(
    "repro_autotune_vmem_rejected_total")
_M_LOAD_ERRORS = obs_metrics.get_registry().counter(
    "repro_autotune_cache_load_errors_total")

# dispatch route -> the GemmEngine impl whose cost model prices it (the
# calibration pairing key)
ROUTE_IMPLS = {"dense": "pallas_fused", "sparse": "pallas_sparse",
               "pipelined": "pallas_pipelined"}


def current_backend(device=None) -> str:
    """The measuring-backend tag of ``device`` (None: the CPU).

    ``interpret`` on the CPU, where the kernels' plain versions run (the
    reference's tag for its interpret mode, so CPU keys equal its keys);
    the card's name (``torch.cuda.get_device_name``) on a CUDA device, so
    distinct cards carry distinct entries.
    """
    if device is None:
        return INTERPRET
    dev = device if isinstance(device, torch.device) else \
        torch.device(device)
    if dev.type != "cuda":
        return INTERPRET
    return _card_name(torch.cuda.current_device() if dev.index is None
                      else dev.index)


@functools.lru_cache(maxsize=None)
def _card_name(index: int) -> str:
    # one device-name query per card and process: the dispatch seam asks
    # for the tag on every 'auto' call
    return torch.cuda.get_device_name(index)


def density_bucket(density: float) -> float:
    """File a measured plane-block density under its bucket's upper edge."""
    for edge in DENSITY_BUCKETS:
        if density <= edge:
            return edge
    return DENSITY_BUCKETS[-1]


def _plan_part(plan_key) -> str:
    if plan_key is None:
        return "default"
    planes, encoding, bits, bm, bk = plan_key
    part = f"p{planes}.{encoding}{bits}"
    if bm or bk:
        part += f".bm{bm}.bk{bk}"
    return part


def cache_key(m: int, k: int, n: int, spec=None,
              density: Optional[float] = None,
              backend: Optional[str] = None) -> str:
    """Cache key: shape x spec plan fields x measuring backend x optional
    density bucket.  backend=None: the CPU's tag, ``interpret``."""
    return _lookup_keys(
        m, k, n, None if spec is None else spec.plan_key(),
        None if density is None else density_bucket(float(density)),
        backend or current_backend())[0]


@functools.lru_cache(maxsize=4096)
def _lookup_keys(m, k, n, plan_key, bucket, backend) -> Tuple[str, ...]:
    """A lookup's keys, density bucket's first (cache_key's format),
    formatted once per (shape, spec, bucket, backend): the dispatch seam
    looks up on every 'auto' call."""
    shape = f"{m}x{k}x{n}|{_plan_part(plan_key)}|{backend}"
    return ((f"{shape}|d{bucket}",) if bucket is not None else ()) + \
        (shape,)


class AutotuneCache:
    """JSON-backed winner store for the measured block-size sweep.

    strict=True (the cache path came from ``REPRO_AUTOTUNE_CACHE``) warns
    once per key on a lookup miss; the implicit default cache stays quiet
    so untuned shapes fall back to the static table silently.
    """

    def __init__(self, path: Optional[str] = None, strict: bool = False):
        self.path = path
        self.strict = strict
        self.entries: Dict[str, dict] = {}
        self._warned: set = set()
        self.hits = 0
        self.misses = 0

    def stats(self) -> dict:
        return {"entries": len(self.entries), "hits": self.hits,
                "misses": self.misses}

    @classmethod
    def load(cls, path: str, strict: bool = False,
             on_error: str = "raise") -> "AutotuneCache":
        """Load a cache file.

        on_error="raise" (default) propagates parse/validation errors:
        ``--validate`` depends on a corrupt cache *failing*.
        on_error="fallback", the runtime policy of ``get_cache``, turns a
        corrupt, truncated, or partially written file into an *empty*
        cache: one ``AutotuneCacheMissWarning`` plus the
        ``repro_autotune_cache_load_errors_total`` counter, and every
        lookup falls back to the static block-size table.  A bad cache
        file must never take serving down.
        """
        if on_error not in ("raise", "fallback"):
            raise ValueError(f"on_error must be 'raise' or 'fallback', "
                             f"got {on_error!r}")
        cache = cls(path, strict=strict)
        if not path or not os.path.exists(path):
            return cache
        try:
            with open(path) as f:
                text = f.read()
            if _chaos.enabled():
                text = _chaos.corrupt_if_due("autotune.load", text)
            payload = json.loads(text)
            version = payload.get("version")
            if version != CACHE_FORMAT_VERSION:
                raise ValueError(
                    f"autotune cache {path!r} has format version "
                    f"{version!r}; this build reads {CACHE_FORMAT_VERSION}")
            entries = payload.get("entries", {})
            for key, entry in entries.items():
                cache._check_entry(key, entry)
        except (ValueError, OSError, AttributeError) as e:
            # json.JSONDecodeError is a ValueError subclass
            if on_error == "raise":
                raise
            _M_LOAD_ERRORS.inc()
            warnings.warn(
                f"autotune cache {path!r} failed to load ({e}); using "
                f"the static block-size table instead",
                AutotuneCacheMissWarning, stacklevel=2)
            return cls(path, strict=strict)
        cache.entries = dict(entries)
        return cache

    @staticmethod
    def _check_entry(key: str, entry: dict) -> None:
        for field in ("block_m", "block_k", "block_n"):
            v = entry.get(field)
            if not isinstance(v, int) or v <= 0 or v % 128:
                raise ValueError(
                    f"autotune cache entry {key!r}: {field}={v!r} is not a "
                    f"positive multiple of 128")
        if entry.get("dispatch") not in (None, "sparse", "dense",
                                         "pipelined"):
            raise ValueError(f"autotune cache entry {key!r}: bad dispatch "
                             f"{entry.get('dispatch')!r}")
        if entry.get("order") not in (None, "m_major", "k_major"):
            raise ValueError(f"autotune cache entry {key!r}: bad order "
                             f"{entry.get('order')!r}")
        backend = entry.get("backend")
        if not isinstance(backend, str) or not backend:
            raise ValueError(
                f"autotune cache entry {key!r} is missing its measuring-"
                f"backend tag (re-measure with --sweep; one cache file "
                f"carries CPU and card entries side by side)")

    def lookup(self, m: int, k: int, n: int, spec=None,
               density: Optional[float] = None, *,
               device=None) -> Optional[dict]:
        """Best entry for a GEMM *measured on the backend of* ``device``
        (None: the CPU): the density-bucket key when a density is given
        (falling back to the shape-level key), else the shape key."""
        keys = _lookup_keys(
            m, k, n, None if spec is None else spec.plan_key(),
            None if density is None else density_bucket(float(density)),
            current_backend(device))
        for key in keys:
            hit = self.entries.get(key)
            if hit is not None:
                self.hits += 1
                _M_HITS.inc()
                return hit
        self.misses += 1
        _M_MISSES.inc()
        if self.strict and self.entries and keys[-1] not in self._warned:
            self._warned.add(keys[-1])
            _M_MISS_WARNINGS.inc()
            warnings.warn(
                f"autotune cache {self.path!r} has no entry for "
                f"{keys[-1]!r}; falling back to the static block table",
                AutotuneCacheMissWarning, stacklevel=3)
        return None

    def record(self, m: int, k: int, n: int, spec, config: dict,
               density: Optional[float] = None,
               backend: Optional[str] = None) -> None:
        backend = backend or current_backend()
        config = dict(config, backend=config.get("backend") or backend)
        self.entries[cache_key(m, k, n, spec, backend=backend)] = \
            dict(config)
        if density is not None:
            self.entries[cache_key(m, k, n, spec, density,
                                   backend=backend)] = dict(config)

    def coverage(self, shapes: Iterable[Tuple[int, int, int]], spec=None,
                 backend: Optional[str] = None) -> \
            List[Tuple[int, int, int]]:
        """Shapes with no shape-level entry for ``backend``."""
        return [s for s in shapes
                if cache_key(*s, spec=spec, backend=backend)
                not in self.entries]

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("no cache path to save to")
        payload = {"version": CACHE_FORMAT_VERSION,
                   "entries": {k: self.entries[k]
                               for k in sorted(self.entries)}}
        # write-then-rename: a reader (or a crash) mid-save sees either
        # the old complete file or the new complete file, never a torn one
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path


_CACHE: Optional[AutotuneCache] = None
_CACHE_SOURCE: Optional[Tuple[str, bool]] = None
_CACHE_PINNED = False


def get_cache() -> AutotuneCache:
    """Process-wide cache honoring ``REPRO_AUTOTUNE_CACHE`` (explicit path
    => strict miss warnings); defaults to the checked-in cache.  A cache
    installed with set_cache() stays pinned until reset_cache()."""
    global _CACHE, _CACHE_SOURCE
    if _CACHE_PINNED:
        return _CACHE
    env = os.environ.get(ENV_VAR)
    source = (env or DEFAULT_CACHE_PATH, env is not None)
    if _CACHE is None or _CACHE_SOURCE != source:
        # runtime resolution never raises on a bad file: a corrupt cache
        # degrades to the static block table, it does not stop serving
        _CACHE = AutotuneCache.load(source[0], strict=source[1],
                                    on_error="fallback")
        _CACHE_SOURCE = source
    return _CACHE


def set_cache(cache: Optional[AutotuneCache]) -> None:
    """Pin a cache instance (tests / in-process tuning runs); pass None
    (or call reset_cache) to return to env/default resolution."""
    global _CACHE, _CACHE_SOURCE, _CACHE_PINNED
    _CACHE = cache
    _CACHE_SOURCE = None
    _CACHE_PINNED = cache is not None


def reset_cache() -> None:
    """Drop the process-wide cache so the next get_cache() reloads."""
    set_cache(None)


# ---------------------------------------------------------------------------
# Measured sweep
# ---------------------------------------------------------------------------

# (dispatch, order, pipelined) route combos the sweep measures per block
# shape: dense B1 (the mask), sparse B3 (m_major only) and pipelined B5 on
# both schedule orders.
ROUTE_CANDIDATES = (
    ("dense", "m_major", False),
    ("sparse", "m_major", False),
    ("pipelined", "m_major", True),
    ("pipelined", "k_major", True),
)


def candidate_configs(m: int, k: int, n: int) -> List[dict]:
    """Candidate (block_m, block_k, block_n, dispatch, order, pipelined)
    points, the reference's: blocks are multiples of 128 and never exceed
    the padded problem dims by more than one block.  (The port's kernels
    take every column of a call, so block_n prices nothing here.)"""
    def sizes(dim, options=(128, 256, 512)):
        limit = -(-dim // 128) * 128      # dim rounded up to 128
        picked = [s for s in options if s <= limit]
        return picked or [128]

    out = []
    for bm in sizes(m, (128, 256)):
        for bk in sizes(k):
            for bn in sizes(n, (128, 256)):
                for dispatch, order, pipelined in ROUTE_CANDIDATES:
                    out.append({"block_m": bm, "block_k": bk, "block_n": bn,
                                "dispatch": dispatch, "order": order,
                                "pipelined": pipelined})
    return out


def _wall_seconds(fn, iters: int, warmup: int = 1) -> float:
    """Best-of-``iters`` host seconds of ``fn(i)`` (warm-up excluded)."""
    for i in range(warmup):
        fn(i)
    best = float("inf")
    for i in range(iters):
        t0 = time.perf_counter()
        fn(i)
        best = min(best, time.perf_counter() - t0)
    return best


def _device_seconds(fn, iters: int, warmup: int = 3) -> float:
    """Median device seconds of one ``fn(i)`` call on the card.

    The same method as ``chip_smoke.py``'s ``cuda_ms`` (which returns ms);
    the two copies must stay in step.

    The host issues a small kernel more slowly than the card runs it, so
    each call is queued behind a sleep kernel (eight times the slowest
    warm-up call's host time, at <= 2 GHz) and timed by a CUDA event pair
    that fires only when the card reaches it; the median pair leaves out
    one the host issued late all the same.
    """
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
    return times[len(times) // 2] / 1e3


# copies of the digit planes a timed call cycles through on the card: more
# bytes than the L2 (50 MB on an H100) three times over, so each call
# reads device memory, as serving 40 layers of distinct weights does
# (chip_smoke.py's ``cold_copies`` is the same; keep the two in step)
_COLD_BYTES = 150e6


def _cold_copies(t: torch.Tensor) -> List[torch.Tensor]:
    return [t.clone() for _ in range(max(2, -(-int(_COLD_BYTES)
                                              // max(t.nbytes, 1))))]


def _synthetic_weight(m: int, k: int, spec, rng) -> torch.Tensor:
    """int8 [M, K]: student-t weights quantized on the spec's grid (the
    reference's synthetic LLM-like multiplicand)."""
    from repro_torch.core import quant as quantlib
    w = torch.from_numpy(
        (rng.standard_t(4, size=(k, m)) * 0.02).astype(np.float32))
    if spec is not None:
        qw, _ = quantlib.quantize_for_spec(w, spec, axis=0)
    else:
        qw, _ = quantlib.quantize_to_planes(w, planes=3, axis=0)
    return qw.t().to(torch.int8)


def autotune_gemm(m: int, k: int, n: int, spec=None, a=None, b=None, *,
                  cache: Optional[AutotuneCache] = None, iters: int = 3,
                  seed: int = 0, device=None,
                  on_measure: Optional[Callable[[dict, float], None]] = None
                  ) -> dict:
    """Measure every candidate config on a real (planned) GEMM and record
    the winner.

    a: optional int8 [M, K] multiplicand (synthesized LLM-like -- student-t
    weights quantized on the spec's grid -- when omitted).  b: optional
    int8 [K, N].  device: where the candidates run (default ``cuda``; the
    CPU runs the kernels' plain versions and is timed by wall clock).
    on_measure: called with (config, seconds) for each candidate timed.
    Returns the winning config (with its measured microseconds and the
    plan's density proxy); the winner is recorded in ``cache`` under the
    device's backend tag.
    """
    from repro_torch import resolve_device
    from repro_torch.core import encodings as enc
    from repro_torch.engine.spec import QuantSpec
    from repro_torch.engine import get_engine
    from repro_torch import analysis
    from . import bw_gemm as _bw
    from . import ops

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    spec = QuantSpec.coerce(spec) if spec is not None else None
    rng = np.random.default_rng(seed)
    if a is None:
        a = _synthetic_weight(m, k, spec, rng)
    if b is None:
        b = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    a = torch.as_tensor(a).to(device=dev, dtype=torch.int8)
    b = torch.as_tensor(b).to(device=dev, dtype=torch.int8)
    encoding = spec.encoding if spec is not None else "ent"
    bits = spec.bits if spec is not None else 8
    radix = enc.radix(encoding)
    backend = current_backend(dev)

    # hard shared-memory gate: candidates a CTA cannot hold (or whose
    # blocks a kernel refuses) are never launched; the filter never
    # empties the pool
    all_configs = candidate_configs(m, k, n)
    candidates, _ = analysis.filter_vmem_configs(
        m, k, n, all_configs, n_planes=enc.num_digits(encoding, bits))
    _M_VMEM_REJECTED.inc(len(all_configs) - len(candidates))
    # calibration: pair each candidate's measured seconds with the
    # impl's cost-model prediction for the same (shape, spec, density)
    calibrator = get_calibrator()
    cal_spec = spec if spec is not None else QuantSpec(planes=3)
    sweep_sp = obs_trace.span("autotune.sweep", m=m, k=k, n=n,
                              candidates=len(candidates),
                              vmem_rejected=len(all_configs)
                              - len(candidates))
    results = []
    with sweep_sp:
        for config in candidates:
            bm, bk = config["block_m"], config["block_k"]
            planned = ops.plan_operand(a, encoding=encoding, block_m=bm,
                                       block_k=bk, bits=bits,
                                       order=config["order"])
            m_pad = planned.digits.shape[1]
            # the kernels' operands, as planned_dense_apply builds them:
            # token rows [N, K_pad] and unit scales [M_pad, 1]
            bt = ops._pad_to(b.t(), bk, 1).contiguous()
            scale = torch.ones((m_pad, 1), dtype=torch.float32, device=dev)
            digits = _cold_copies(planned.digits) if on_card \
                else [planned.digits]
            blocks = dict(block_m=bm, block_k=bk)
            dispatch = config["dispatch"]

            def fn(i, planned=planned, digits=digits, bt=bt, scale=scale,
                   blocks=blocks, dispatch=dispatch):
                d = digits[i % len(digits)]
                if dispatch == "dense":
                    return _bw.bw_gemm_fused(d, bt, planned.mask, scale,
                                             radix=radix, **blocks)
                run = _bw.bw_gemm_sparse_fused if dispatch == "sparse" \
                    else _bw.bw_gemm_sparse_fused_pipelined
                return run(d, bt, planned.schedule, scale, **blocks)

            with obs_trace.span("autotune.measure", **config):
                secs = _device_seconds(fn, max(iters, 1)) if on_card \
                    else _wall_seconds(fn, iters)
            del digits
            if on_measure is not None:
                on_measure(config, secs)
            # file the measurement under the same schedule-length proxy
            # (L / mask.numel(), sentinels included) that
            # planned_dense_apply's 'auto' dispatch computes at lookup time
            proxy = planned.schedule.shape[0] / max(planned.mask.numel(), 1)
            results.append((secs, config, proxy))
            impl = ROUTE_IMPLS[dispatch]
            # serving orientation: tokens on M, output channels on N --
            # the transpose of this sweep's (m=rows, n=tokens)
            predicted = get_engine(impl).predict_seconds(
                n, k, m, cal_spec, plan=planned)
            if predicted > 0 and secs > 0:
                calibrator.record(impl, predicted, secs, shape=(m, k, n),
                                  density=planned.density(),
                                  source="autotune")
    secs, config, density = min(results, key=lambda r: r[0])
    winner = dict(config, us=round(secs * 1e6), density=round(density, 4),
                  candidates=len(results),
                  vmem_rejected=len(all_configs) - len(candidates),
                  backend=backend)
    cache = cache if cache is not None else get_cache()
    cache.record(m, k, n, spec, winner, density=density, backend=backend)
    return winner


# ---------------------------------------------------------------------------
# CLI: --validate and --sweep
# ---------------------------------------------------------------------------

def validate(path: Optional[str] = None) -> List[str]:
    """Parse the cache and check CI-shape coverage; returns problems.

    Loading already rejects entries without a measuring-backend tag; the
    coverage check asks for ``interpret`` entries, the ones a CPU run
    exercises, whatever the validating host.
    """
    path = path or os.environ.get(ENV_VAR) or DEFAULT_CACHE_PATH
    try:
        cache = AutotuneCache.load(path)
    except (ValueError, OSError, json.JSONDecodeError) as e:
        return [f"cache {path!r} failed to parse: {e}"]
    if not cache.entries:
        return [f"cache {path!r} is missing or empty"]
    return [f"cache {path!r} does not cover CI benchmark shape {shape} "
            f"for backend {INTERPRET!r} ({len(cache.entries)} entries)"
            for shape in cache.coverage(CI_SHAPES, backend=INTERPRET)]


def _print_cache_stats(path: str, device=None) -> None:
    """Hit/miss + coverage stats for logs (beyond pass/fail)."""
    try:
        cache = AutotuneCache.load(path)
    except (ValueError, OSError, json.JSONDecodeError):
        return
    by_backend: Dict[str, int] = {}
    for entry in cache.entries.values():
        backend = entry.get("backend", "?")
        by_backend[backend] = by_backend.get(backend, 0) + 1
    # probe the CI shapes the way the dispatch seams would
    for shape in CI_SHAPES:
        cache.lookup(*shape, device=device)
    stats = cache.stats()
    print(f"cache stats: {stats['entries']} entries "
          f"(by backend: {dict(sorted(by_backend.items()))}); "
          f"CI-shape probe [{current_backend(device)}]: "
          f"hits={stats['hits']} misses={stats['misses']}")
    reg = obs_metrics.get_registry()
    print(f"process counters: autotune_cache_hits="
          f"{reg.counter('repro_autotune_cache_hits_total').value} "
          f"misses="
          f"{reg.counter('repro_autotune_cache_misses_total').value} "
          f"miss_warnings="
          f"{reg.counter('repro_autotune_miss_warnings_total').value}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--validate", action="store_true",
                    help="check the cache parses and covers CI_SHAPES")
    ap.add_argument("--sweep", action="store_true",
                    help="measure CI_SHAPES and write the cache")
    ap.add_argument("--cache", default=None,
                    help=f"cache path (default: ${ENV_VAR} or the "
                         f"checked-in {os.path.basename(DEFAULT_CACHE_PATH)})")
    ap.add_argument("--planes", type=int, default=3,
                    help="digit-plane budget of the sweep's synthetic "
                         "weights (default 3)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device the sweep runs on (default cuda); "
                         "--validate probes its backend's keys (default: "
                         "the CPU's)")
    args = ap.parse_args(argv)
    path = args.cache or os.environ.get(ENV_VAR) or DEFAULT_CACHE_PATH
    if args.sweep:
        from repro_torch import resolve_device
        from repro_torch.engine.spec import QuantSpec
        device = resolve_device(args.device)
        cache = AutotuneCache(path)
        if os.path.exists(path):
            cache = AutotuneCache.load(path)
            cache.path = path
        backend = current_backend(device)
        for m, k, n in CI_SHAPES:
            # the default plan grid (spec=None) plus the spec'd grids the
            # benches sweep: one entry per density bucket reached
            for planes in sorted({1, 2, args.planes, 4}):
                spec = QuantSpec(planes=planes)
                win = autotune_gemm(m, k, n, spec, cache=cache,
                                    iters=args.iters, seed=0, device=device)
                print(f"[{backend}] {m}x{k}x{n} planes={planes}: {win}")
            win = autotune_gemm(m, k, n, None, cache=cache,
                                iters=args.iters, seed=0, device=device)
            print(f"[{backend}] {m}x{k}x{n} default: {win}")
        cache.save(path)
        print(f"wrote {path} ({len(cache.entries)} entries)")
        return 0
    if args.validate:
        problems = validate(path)
        for p in problems:
            print(f"FAIL: {p}")
        if not problems:
            print(f"OK: {path} parses and covers the CI benchmark shapes")
        _print_cache_stats(path, args.device)
        return 1 if problems else 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
