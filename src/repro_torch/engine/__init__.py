"""Quantized-GEMM configuration (``QuantSpec``) and the engine registry.

    from repro_torch.engine import QuantSpec, get_engine
    spec = QuantSpec.parse("planes=3,encoding=ent,impl=pallas_fused")
    y = get_engine(spec.impl).apply(w, x, spec)
"""
from .spec import QuantSpec, IMPLS, ACT_QUANT_POLICIES
from .registry import GemmEngine, register, get_engine, engine_names

__all__ = ["QuantSpec", "IMPLS", "ACT_QUANT_POLICIES", "GemmEngine",
           "register", "get_engine", "engine_names"]
