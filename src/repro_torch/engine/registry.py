"""GemmEngine registry: one strategy object per quantized-matmul
implementation, selected per call by ``QuantSpec.impl``.

Each engine exposes

    apply(plan_or_w, x, spec)    -> act((x @ w)_int * scales + bias)

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
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import bw_ref
from repro_torch.core import quant as quantlib
from .spec import QuantSpec

__all__ = ["GemmEngine", "register", "get_engine", "engine_names"]

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


def _epilogue(y, bias, activation, out_dtype):
    if bias is not None:
        y = y + bias.to(y.dtype)
    if activation is not None:
        from repro_torch.kernels.bw_gemm import EPILOGUE_ACTIVATIONS
        y = EPILOGUE_ACTIVATIONS[activation](y)
    return y.to(out_dtype)


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


class PallasFusedEngine(PallasEngine):
    """bw_gemm with the epilogue fused onto the register-resident
    accumulator."""

    name = "pallas_fused"
    fused = True


class PallasSparseEngine(PallasFusedEngine):
    """Density-dispatched sparse route: B3 on m_major schedules when the
    plan's density proxy is at most ops.SPARSE_DENSITY_THRESHOLD, the
    dense fused kernel otherwise."""

    name = "pallas_sparse"
    dispatch = "auto"


class PallasPipelinedEngine(PallasSparseEngine):
    """pallas_sparse on k_major schedules (planned so by plan_params): the
    pipelined kernel B5, or the dense fused kernel above the threshold."""

    name = "pallas_pipelined"
    order = "k_major"


for _engine in (RefEngine(), PlanesEngine(), Int8Engine(), PallasEngine(),
                PallasFusedEngine(), PallasSparseEngine(),
                PallasPipelinedEngine()):
    register(_engine)
