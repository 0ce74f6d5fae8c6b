"""QuantSpec: the single configuration object for quantized GEMM.

One point on the bit-weight design axis (encoding, digit-plane budget,
block shape, engine, activation-quantization policy) as an immutable,
hashable value passed explicitly down the call chain (model layer -> ops
dispatch -> kernel).  The grammar and the field set are the reference's
(``repro.engine.spec``), so a spec string means the same thing in both
packages:

    QuantSpec(planes=3, impl="pallas_fused")
    QuantSpec.parse("planes=4,encoding=ent,impl=pallas")
    QuantSpec.coerce(3)          # legacy int plane budget -> spec
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import encodings as enc

__all__ = ["QuantSpec", "IMPLS", "ACT_QUANT_POLICIES"]

# Engine names a spec may carry, the reference's; each is registered in
# repro_torch.engine.registry.
IMPLS = ("ref", "planes", "int8", "pallas", "pallas_fused", "pallas_sparse",
         "pallas_pipelined")

# How activations are quantized at matmul time:
#   per_tensor -- one scale for the whole activation tensor (folds into the
#                 per-channel weight scale in the kernel epilogue); a
#                 request's outputs then depend on its batch-mates.
#   per_token  -- one scale per row; reaches the fused kernel epilogue as a
#                 per-column vector (tokens sit on the kernel N axis), so
#                 decode rows are independent.  Every serving tier uses it.
ACT_QUANT_POLICIES = ("per_tensor", "per_token")

# legacy plane-budget sugar: "pallas" used to name the fused kernel path
_LEGACY_IMPL_ALIASES = {"pallas": "pallas_fused"}


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """One point in the bit-weight design space for a quantized GEMM.

    planes:   digit-plane budget of the quantization grid (0 disables the
              quantized path).
    encoding: BW encoding of the planned multiplicand (enc.ENCODINGS).
    bits:     integer operand width (the paper's setting is 8).
    impl:     engine name (see IMPLS).
    block_m/block_k/block_n: optional plan block-size overrides; None
              defers to ops.select_block_sizes.
    act_quant: activation quantization policy (see ACT_QUANT_POLICIES).
    """
    planes: int = 4
    encoding: str = "ent"
    bits: int = 8
    impl: str = "planes"
    block_m: Optional[int] = None
    block_k: Optional[int] = None
    block_n: Optional[int] = None
    act_quant: str = "per_tensor"

    def __post_init__(self):
        if self.encoding not in enc.ENCODINGS:
            raise ValueError(f"unknown encoding {self.encoding!r}; "
                             f"one of {enc.ENCODINGS}")
        if self.impl not in IMPLS:
            raise ValueError(f"unknown quant impl {self.impl!r}; "
                             f"one of {IMPLS}")
        if self.act_quant not in ACT_QUANT_POLICIES:
            raise ValueError(f"unknown act_quant {self.act_quant!r}; "
                             f"one of {ACT_QUANT_POLICIES}")
        if not 2 <= self.bits <= 8:
            raise ValueError(f"bits must be in [2, 8], got {self.bits}")
        if self.planes < 0 or self.planes > self.num_digits:
            raise ValueError(
                f"planes must be in [0, {self.num_digits}] for "
                f"{self.encoding!r}/{self.bits}b, got {self.planes}")
        for name in ("block_m", "block_k", "block_n"):
            v = getattr(self, name)
            if v is not None and (v <= 0 or v % 128):
                raise ValueError(f"{name} must be a positive multiple of "
                                 f"128, got {v}")

    @property
    def radix(self) -> int:
        return enc.radix(self.encoding)

    @property
    def num_digits(self) -> int:
        """Digit planes the encoding produces for `bits`-wide operands."""
        return enc.num_digits(self.encoding, self.bits)

    @property
    def enabled(self) -> bool:
        return self.planes > 0

    def plan_key(self) -> tuple:
        """The spec fields a weight plan depends on: impl, block_n and
        act_quant do not change the planned operand, so 'pallas' and
        'pallas_fused' share plans."""
        return (self.planes, self.encoding, self.bits,
                self.block_m, self.block_k)

    @classmethod
    def coerce(cls, value,
               impl: Optional[str] = None) -> Optional["QuantSpec"]:
        """Normalize ``None | int | QuantSpec`` to ``Optional[QuantSpec]``:
        0/None disable the quantized path; an int n > 0 is a default-grid
        spec with ``impl`` (default: the exact ``planes`` oracle; the
        legacy name "pallas" means the fused kernel path here)."""
        if value is None:
            return None
        if isinstance(value, cls):
            return value if value.enabled else None
        if isinstance(value, bool) or not isinstance(value, int):
            raise TypeError(f"cannot coerce {value!r} to QuantSpec")
        if value == 0:
            return None
        impl = impl or "planes"
        return cls(planes=value, impl=_LEGACY_IMPL_ALIASES.get(impl, impl))

    @classmethod
    def parse(cls, text: str, **defaults) -> Optional["QuantSpec"]:
        """Parse a CLI spec string: ``planes=4,encoding=ent,impl=pallas``.

        Unknown keys raise; ``off``/empty disables (returns None).  Keyword
        defaults seed fields not named in the string.
        """
        text = (text or "").strip()
        if text in ("", "off", "none", "0"):
            return None
        kw = dict(defaults)
        for item in text.split(","):
            if not item.strip():
                continue
            if "=" not in item:
                raise ValueError(
                    f"bad --quant-spec item {item!r} (expected key=value)")
            k, v = (s.strip() for s in item.split("=", 1))
            if k not in cls.__dataclass_fields__:
                raise ValueError(
                    f"unknown QuantSpec field {k!r}; one of "
                    f"{tuple(cls.__dataclass_fields__)}")
            field = cls.__dataclass_fields__[k]
            if field.type in ("int", "Optional[int]"):
                kw[k] = int(v)
            else:
                kw[k] = v
        return cls(**kw)

    def __str__(self) -> str:
        parts = [f"planes={self.planes}", f"encoding={self.encoding}",
                 f"bits={self.bits}", f"impl={self.impl}"]
        for name in ("block_m", "block_k", "block_n"):
            v = getattr(self, name)
            if v is not None:
                parts.append(f"{name}={v}")
        if self.act_quant != "per_tensor":
            parts.append(f"act_quant={self.act_quant}")
        return ",".join(parts)
