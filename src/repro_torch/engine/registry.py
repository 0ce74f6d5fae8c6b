"""GemmEngine registry: one strategy object per quantized-matmul
implementation, selected per call by ``QuantSpec.impl``.

Each engine exposes

    apply(plan_or_w, x, spec)    -> act((x @ w)_int * scales + bias)
    cost(m, k, n, spec)          -> the reference's static cost model (dict)
    predict_seconds(m, k, n, spec) -> cost() priced on a core.hwmodel design

and says with ``uses_plans`` whether it takes the ``w_plan`` records of
``kernels.ops.plan_params``.

Registered engines:

    ref          -- one exact integer matmul on the spec's grid.
    planes       -- the exact digit-plane decomposed matmul (one product
                    per BW plane of spec.encoding): the kernels' oracle.
    int8         -- the same single integer product as ``ref`` (the
                    reference's int8 dot, before plane skipping).
    pallas       -- the Hopper bw_gemm kernel with plane-block skipping;
                    dequant/bias/activation epilogue in torch.
    pallas_fused -- bw_gemm with the epilogue fused into the kernel (the
                    serving path).
    pallas_sparse    -- pallas_fused through planned_dense_apply(
                    dispatch='auto'): the sparse kernel walking the plan's
                    m_major schedule when its density is at most
                    ops.SPARSE_DENSITY_THRESHOLD, else the dense kernel.
    pallas_pipelined -- the same on k_major schedules, through the
                    pipelined kernel.

The names are the reference's, so a spec string selects the same strategy
in both packages.  The plain engines are forward-only oracles; products
are exact (float64 on the card, int64 on the CPU).

The cost model is the reference's, number for number: the counters
describe the reference's TPU kernels' grids and DMA traffic, and
``predict_seconds`` prices them on the reference's ``hw.TABLE7`` designs.
It is the tier router's relative pricing seam, not a model of the card.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import bw_ref
from repro_torch.core import quant as quantlib
from .spec import QuantSpec

__all__ = ["GemmEngine", "register", "get_engine", "engine_names",
           "active_planes", "NOMINAL_HBM_BPS", "NOMINAL_ICI_BPS"]

_REGISTRY: Dict[str, "GemmEngine"] = {}


def register(engine: "GemmEngine") -> "GemmEngine":
    """Register a GemmEngine strategy instance under ``engine.name``."""
    if not engine.name:
        raise ValueError("engine needs a non-empty name")
    if engine.name in _REGISTRY:
        raise ValueError(f"engine {engine.name!r} already registered")
    _REGISTRY[engine.name] = engine
    return engine


def get_engine(name: str) -> "GemmEngine":
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown quant impl {name!r}; "
                         f"one of {engine_names()}") from None


def engine_names() -> tuple:
    return tuple(_REGISTRY)


def active_planes(spec: QuantSpec) -> int:
    """Plane passes a digit-plane engine cannot structurally skip:
    sign-magnitude encodings (ent / mbe / bitserial_sm) leave the planes
    above the quantization bound all-zero; two's-complement bit-serial
    sign-extends negatives into every plane."""
    if spec.encoding == "bitserial":
        return spec.num_digits
    return min(spec.planes, spec.num_digits)


def _numpy(a) -> np.ndarray:
    """A plan array (tensor on any device, or numpy) as numpy, on the
    host: the cost model reads plans at routing time, never per step."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def _epilogue(y, bias, activation, out_dtype):
    if bias is not None:
        y = y + bias.to(y.dtype)
    if activation is not None:
        from repro_torch.kernels.bw_gemm import EPILOGUE_ACTIVATIONS
        y = EPILOGUE_ACTIVATIONS[activation](y)
    return y.to(out_dtype)


# Nominal pricing bandwidths for predict_seconds (bytes/s), the
# reference's.  Only the relative cost across engines matters for routing;
# obs.calibrate.CostCalibrator measures drift from the absolute scale.
NOMINAL_HBM_BPS = 300e9
NOMINAL_ICI_BPS = 50e9


class GemmEngine:
    """Strategy interface for one quantized-GEMM implementation."""

    name: str = ""
    uses_plans: bool = False      # consumes pre-planned weight records

    def apply(self, plan_or_w, x, spec: QuantSpec, *, n_out: int = None,
              bias=None, activation: Optional[str] = None,
              out_dtype=torch.float32):
        """y = act((x @ w)_int * scales + bias), cast to out_dtype.

        plan_or_w: the raw float weight [K, N], or its ``w_plan`` record
        (kernel engines only; then n_out, the original N, is required).
        """
        raise NotImplementedError

    def cost(self, m: int, k: int, n: int, spec: QuantSpec, *,
             density: Optional[float] = None, plan=None,
             shards=None) -> dict:
        """Schedule-aware cost of one [M,K]x[K,N] call (the tier-routing
        seam), the reference's ``GemmEngine.cost``.

        density: fraction of non-zero plane blocks over all digit planes;
        ``plan`` (a ``w_plan`` record or PlannedOperand) supplies it and,
        on the kernel engines, the block grid and schedule.  Neither given:
        the spec's active planes, fully dense.  shards: ``(s_data,
        s_model)``; the counters then describe one device's shard and
        ``collective_bytes`` the psum of its partial accumulator.

        Keys: ``mxu_passes``, ``int_macs``, ``acc_hbm_bytes``,
        ``grid_steps``, ``dma_bytes``, ``b_dma_elided`` and
        ``collective_bytes`` (see the reference for each).
        """
        from ._collectives import gemm_collective_bytes, normalize_shards
        s_data, s_model = normalize_shards(shards)
        if (s_data, s_model) == (1, 1):
            out = self._cost1(m, k, n, spec, density=density, plan=plan)
            out["collective_bytes"] = 0
            return out
        if density is None:
            density = self._plan_density(plan)
        out = self._cost1(m, -(-k // s_data), -(-n // s_model), spec,
                          density=density, plan=None)
        out["collective_bytes"] = gemm_collective_bytes(m, n, s_data,
                                                        s_model)
        return out

    def predict_seconds(self, m: int, k: int, n: int, spec: QuantSpec, *,
                        density: Optional[float] = None, plan=None,
                        shards=None, design: str = "tpu") -> float:
        """cost() priced in seconds on a ``core.hwmodel`` design: compute
        at its peak integer throughput, the accumulator round trip at
        NOMINAL_HBM_BPS, collectives at NOMINAL_ICI_BPS."""
        from repro_torch.core import hwmodel as hw
        c = self.cost(m, k, n, spec, density=density, plan=plan,
                      shards=shards)
        ops_per_s = hw.peak_tops(hw.TABLE7[design]) * 1e12
        return (2.0 * c["int_macs"] / ops_per_s
                + c["acc_hbm_bytes"] / NOMINAL_HBM_BPS
                + c["collective_bytes"] / NOMINAL_ICI_BPS)

    def _cost1(self, m: int, k: int, n: int, spec: QuantSpec, *,
               density: Optional[float] = None, plan=None) -> dict:
        """Single-device counters (engines override this, not cost())."""
        passes = self._passes(spec)
        acc = self._acc_hbm_bytes(m, n)
        return {
            "mxu_passes": passes,
            "int_macs": passes * m * k * n,
            "acc_hbm_bytes": acc,
            "grid_steps": 0,
            "dma_bytes": m * k + k * n + 4 * m * n + acc,
            "b_dma_elided": 0,
        }

    @staticmethod
    def _plan_density(plan) -> Optional[float]:
        if plan is None:
            return None
        mask = plan["mask"] if isinstance(plan, dict) else plan.mask
        return float(_numpy(mask).mean())

    def _passes(self, spec: QuantSpec) -> int:
        return 1

    def _acc_hbm_bytes(self, m: int, n: int) -> int:
        return 0


class _PlainEngine(GemmEngine):
    """The exact plain-torch engines: quantize both operands per call."""

    kind: str = ""

    def apply(self, plan_or_w, x, spec, *, n_out=None, bias=None,
              activation=None, out_dtype=torch.float32):
        if isinstance(plan_or_w, dict):
            raise TypeError(f"engine {self.name!r} takes raw weights, not "
                            f"plan records")
        w = plan_or_w
        act_axis = -1 if spec.act_quant == "per_token" else None
        qx, sx = quantlib.quantize_for_spec(x.to(torch.float32), spec,
                                            axis=act_axis)
        qw, sw = quantlib.quantize_for_spec(w.to(torch.float32), spec,
                                            axis=0)
        x2 = qx.reshape(-1, qx.shape[-1])
        if self.kind == "planes":
            acc = bw_ref.bw_matmul(x2, qw, spec.encoding, spec.bits)
        else:
            acc = bw_ref.exact_matmul(x2, qw).to(torch.int32)
        acc = acc.reshape(*qx.shape[:-1], qw.shape[-1])
        y = (acc.to(torch.float32) * (sx * sw)).to(out_dtype)
        return _epilogue(y, bias, activation, out_dtype)


class RefEngine(_PlainEngine):
    name = "ref"
    kind = "ref"


class PlanesEngine(_PlainEngine):
    name = "planes"
    kind = "planes"

    def _passes(self, spec):
        return active_planes(spec)


class Int8Engine(_PlainEngine):
    name = "int8"
    kind = "int8"


class PallasEngine(GemmEngine):
    """bw_gemm kernel path, dequant/bias/activation epilogue in torch."""

    name = "pallas"
    uses_plans = True
    fused = False
    dispatch = "dense"           # kernel route (ops.DISPATCHES)
    order = "m_major"            # schedule order the plans carry

    def apply(self, plan_or_w, x, spec, *, n_out=None, bias=None,
              activation=None, out_dtype=torch.float32):
        from repro_torch.kernels import ops
        if isinstance(plan_or_w, dict):
            if n_out is None:
                raise ValueError("n_out is required with a plan record "
                                 "(the record only carries padded shapes)")
            return ops.planned_dense_apply(
                plan_or_w, x, spec, n_out, bias=bias, activation=activation,
                out_dtype=out_dtype, fused=self.fused,
                dispatch=self.dispatch, order=self.order)
        return ops.quantized_dense(
            x, plan_or_w, spec, bias=bias, activation=activation,
            out_dtype=out_dtype, fused=self.fused, dispatch=self.dispatch,
            order=self.order)

    def _passes(self, spec):
        return active_planes(spec)

    def _acc_hbm_bytes(self, m, n):
        # unfused: the int32 accumulator is written, then re-read (and the
        # float result written) by the epilogue
        return 3 * 4 * m * n

    def _geometry(self, m, k, n, spec, plan=None):
        """(bm, bk, bn, mb, kb, nb) for the cost model; a plan's arrays
        give the block grid it was built with."""
        from repro_torch.kernels import ops
        bm, bk, bn = ops.select_block_sizes(m, k, n, spec)
        mb, kb = -(-m // bm), -(-k // bk)
        if plan is not None:
            mask = plan.get("mask") if isinstance(plan, dict) \
                else getattr(plan, "mask", None)
            digits = plan.get("digits") if isinstance(plan, dict) \
                else getattr(plan, "digits", None)
            if getattr(mask, "ndim", 0) == 3 and \
                    getattr(digits, "ndim", 0) == 3:
                _, mb, kb = mask.shape
                bm = digits.shape[1] // mb
                bk = digits.shape[2] // kb
        return (bm, bk, bn, mb, kb, -(-n // bn))

    def _cost1(self, m, k, n, spec, *, density=None, plan=None):
        """The reference's dense predicated kernel: the full grid is
        walked and every digit plane of every block is read; only empty
        plane blocks' passes are skipped."""
        if density is None:
            density = self._plan_density(plan)
        bm, bk, bn, mb, kb, nb = self._geometry(m, k, n, spec, plan)
        bwn = spec.num_digits
        if density is None:
            density = active_planes(spec) / bwn
        acc = self._acc_hbm_bytes(m, n)
        return {
            "mxu_passes": self._passes(spec),
            "int_macs": int(density * bwn * m * k * n),
            "acc_hbm_bytes": acc,
            "grid_steps": mb * nb * kb,
            "dma_bytes": int(mb * nb * kb * (bwn * bm * bk + bk * bn)
                             + mb * nb * bm * bn * 4 + acc),
            "b_dma_elided": 0,
        }


class PallasFusedEngine(PallasEngine):
    """bw_gemm with the epilogue fused onto the register-resident
    accumulator."""

    name = "pallas_fused"
    fused = True

    def _acc_hbm_bytes(self, m, n):
        return 0                 # only the final float block is written


class PallasSparseEngine(PallasFusedEngine):
    """Density-dispatched sparse route: B3 on m_major schedules when the
    plan's density proxy is at most ops.SPARSE_DENSITY_THRESHOLD, the
    dense fused kernel otherwise."""

    name = "pallas_sparse"
    dispatch = "auto"

    @staticmethod
    def _plan_schedule(plan, min_cols: int = 6):
        """The plan's [L, >=min_cols] schedule as numpy, or None."""
        if plan is None:
            return None
        sched = plan.get("schedule") if isinstance(plan, dict) \
            else getattr(plan, "schedule", None)
        if sched is None:
            return None
        sched = _numpy(sched)
        if sched.ndim != 2 or sched.shape[1] < min_cols:
            return None
        return sched

    def _cost1(self, m, k, n, spec, *, density=None, plan=None):
        if density is None:
            density = self._plan_density(plan)
        bm, bk, bn, mb, kb, nb = self._geometry(m, k, n, spec, plan)
        bwn = spec.num_digits
        if density is None:
            density = active_planes(spec) / bwn
        sched = self._plan_schedule(plan)
        if sched is not None:
            steps = sched.shape[0]            # measured: the walk itself
        else:
            nnz = density * bwn * mb * kb
            steps = max(int(round(nnz)), mb)  # sentinels keep empty rows
        return {
            "mxu_passes": self._passes(spec),
            "int_macs": int(density * bwn * m * k * n),
            "acc_hbm_bytes": 0,
            "grid_steps": steps * nb,
            "dma_bytes": int(steps * nb * (bm * bk + bk * bn)
                             + mb * nb * bm * bn * 4),
            "b_dma_elided": 0,
        }


class PallasPipelinedEngine(PallasSparseEngine):
    """pallas_sparse on k_major schedules (planned so by plan_params): the
    pipelined kernel B5, or the dense fused kernel above the threshold."""

    name = "pallas_pipelined"
    order = "k_major"

    def _cost1(self, m, k, n, spec, *, density=None, plan=None):
        """Overlap-aware: only the copies issued count (real plane blocks,
        and one B fetch per k-block run); the saved B copies are
        ``b_dma_elided``."""
        if density is None:
            density = self._plan_density(plan)
        bm, bk, bn, mb, kb, nb = self._geometry(m, k, n, spec, plan)
        bwn = spec.num_digits
        if density is None:
            density = active_planes(spec) / bwn
        sched = self._plan_schedule(plan, 9)   # B_FETCH column required
        if sched is not None:
            steps = sched.shape[0]
            real = int((sched[:, 3] != 0).sum())      # weight column
            b_fetches = int(sched[:, 8].sum())        # B_FETCH column
        else:
            real = max(int(round(density * bwn * mb * kb)), 0)
            steps = max(real, mb)
            b_fetches = min(kb, real)
        return {
            "mxu_passes": self._passes(spec),
            "int_macs": int(density * bwn * m * k * n),
            "acc_hbm_bytes": 0,
            "grid_steps": steps * nb,
            "dma_bytes": int(real * nb * bm * bk + b_fetches * nb * bk * bn
                             + mb * nb * bm * bn * 4),
            "b_dma_elided": max(real - b_fetches, 0) * nb,
        }


for _engine in (RefEngine(), PlanesEngine(), Int8Engine(), PallasEngine(),
                PallasFusedEngine(), PallasSparseEngine(),
                PallasPipelinedEngine()):
    register(_engine)
