"""Weight planning and the quantized-linear entry points around the
bit-weight GEMM kernels: padding, plane encoding, occupancy masks, the
magnitude-ordered row permutation, and dequantization.

Every entry point is configured by one
:class:`repro_torch.engine.QuantSpec`.  A plan record built here holds the
same arrays as the reference's (``repro.kernels.ops.plan_dense_weight``)
except the compacted block schedule, which only the sparse kernels read;
without it dispatch resolves to the dense kernels, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import quant as quantlib
from repro_torch.engine.spec import QuantSpec
from . import bw_gemm as _bw
from . import ref as kref

__all__ = ["PlannedOperand", "plane_block_mask", "plan_operand",
           "select_block_sizes", "plan_dense_weight", "plan_params",
           "plan_tree_density", "planned_dense_apply", "quantized_dense",
           "DISPATCHES"]

# planned_dense_apply dispatch values; only "dense" has kernels in the port
DISPATCHES = ("dense", "sparse", "pipelined", "auto")


def _pad_to(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * x.dim()            # F.pad lists the last dim first
    widths[2 * (x.dim() - 1 - axis) + 1] = pad
    return F.pad(x, widths)


# ---------------------------------------------------------------------------
# Per-shape block-size selection
# ---------------------------------------------------------------------------
# The reference's static dispatch table: first row whose minimum (M, K, N)
# thresholds are all met wins.  (The reference consults a measured autotune
# cache first; the port has none yet, so a shape the cache covers there
# may plan with other blocks here.)
_BLOCK_TABLE = (
    # (min_m, min_k, min_n)  ->  (block_m, block_k, block_n)
    ((512, 2048, 512), (256, 512, 256)),
    ((256, 1024, 256), (256, 512, 128)),
    ((128, 512, 128), (128, 256, 128)),
    ((0, 0, 0), (128, 128, 128)),
)


def select_block_sizes(m: int, k: int, n: int,
                       spec: Optional[QuantSpec] = None):
    """(block_m, block_k, block_n) for a logical [M, K] x [K, N] GEMM; a
    spec's explicit block overrides win component-wise."""
    sel = _BLOCK_TABLE[-1][1]
    for (mn_m, mn_k, mn_n), blocks in _BLOCK_TABLE:
        if m >= mn_m and k >= mn_k and n >= mn_n:
            sel = blocks
            break
    if spec is not None:
        sel = (spec.block_m or sel[0], spec.block_k or sel[1],
               spec.block_n or sel[2])
    return sel


def plane_block_mask(digits: torch.Tensor, block_m: int,
                     block_k: int) -> torch.Tensor:
    """bool [BW, M/bm, K/bk]: True where a plane block has a non-zero digit."""
    bw, m, k = digits.shape
    d = digits.reshape(bw, m // block_m, block_m, k // block_k, block_k)
    return (d != 0).any(dim=4).any(dim=2)


@dataclasses.dataclass
class PlannedOperand:
    """A pre-encoded multiplicand ready for bw_gemm.

    row_perm sorts rows by high-plane occupancy so that non-zero
    high-weight digits cluster into few row blocks (turning the paper's
    element-level partial-product sparsity into block sparsity); inv_perm
    restores output order.
    """
    digits: torch.Tensor        # int8 [BW, M_pad, K_pad]
    mask: torch.Tensor          # bool [BW, M_pad/bm, K_pad/bk]
    row_perm: torch.Tensor      # int32 [M_pad]
    inv_perm: torch.Tensor      # int32 [M_pad]
    m: int                      # original M
    k: int
    block_m: int
    block_k: int
    encoding: str


def plan_operand(a_int8: torch.Tensor, encoding: str = "ent",
                 block_m: int = 128, block_k: int = 256,
                 reorder_rows: bool = True, bits: int = 8) -> PlannedOperand:
    """Pad, magnitude-order the rows of, and encode an int8 multiplicand.

    a_int8: int8 [M, K] (e.g. a transposed weight matrix).
    """
    a = a_int8.to(torch.int8)
    m, k = a.shape
    a = _pad_to(_pad_to(a, block_m, 0), block_k, 1)
    if reorder_rows:
        # sort rows by their high-plane digit counts (top min(2, BW) planes,
        # most significant first) so rows needing the high planes pack into
        # few row blocks; the stable sort keeps ties in row order
        d0 = kref.encode_planes_ref(a, encoding, bits)
        hi = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
        for p in range(min(2, d0.shape[0])):
            hi = hi * 1000 + (d0[-(p + 1)] != 0).sum(dim=1)
        row_perm = torch.argsort(-hi, stable=True).to(torch.int32)
    else:
        row_perm = torch.arange(a.shape[0], dtype=torch.int32,
                                device=a.device)
    inv_perm = torch.argsort(row_perm).to(torch.int32)
    digits = kref.encode_planes_ref(a[row_perm.long()], encoding, bits)
    mask = plane_block_mask(digits, block_m, block_k)
    return PlannedOperand(digits, mask, row_perm, inv_perm, m, k, block_m,
                          block_k, encoding)


def _channel_rows(vec: torch.Tensor, n: int, m_pad: int,
                  row_perm: torch.Tensor) -> torch.Tensor:
    """[N] per-channel vector -> [M_pad, 1] rows in planned (permuted)
    order."""
    full = torch.zeros((m_pad,), dtype=torch.float32, device=row_perm.device)
    full[:n] = vec.to(torch.float32).reshape(-1)
    return full[row_perm.long()].reshape(-1, 1)


def plan_dense_weight(w: torch.Tensor, spec) -> dict:
    """Quantize + plan a dense weight w [K, N] (d_in, d_out) into a record.

    The record holds the digit planes of W^T (output channels as kernel
    rows), the occupancy mask, the channel permutations and the permuted
    weight scales -- the reference's record without its ``schedule``.
    """
    spec = QuantSpec.coerce(spec)
    k, n = w.shape
    block_m, block_k, _ = select_block_sizes(n, k, 128, spec)
    qw, sw = quantlib.quantize_for_spec(w.to(torch.float32), spec, axis=0)
    planned = plan_operand(qw.t(), encoding=spec.encoding, block_m=block_m,
                           block_k=block_k, bits=spec.bits)
    m_pad = planned.digits.shape[1]
    return {
        "digits": planned.digits,                     # int8 [BW, M_pad, K_pad]
        "mask": planned.mask,                         # bool [BW, M/bm, K/bk]
        "row_perm": planned.row_perm,                 # int32 [M_pad]
        "inv_perm": planned.inv_perm,                 # int32 [M_pad]
        "sw_rows": _channel_rows(sw.reshape(-1), n, m_pad, planned.row_perm),
    }


def _resolve_dispatch(dispatch: str, plan: dict) -> str:
    """The kernel route: 'dense', the only one the port has kernels for.

    A plan without a schedule always resolves to 'dense' (as in the
    reference); asking for a sparse route on a scheduled plan raises.
    """
    if dispatch not in DISPATCHES:
        raise ValueError(f"dispatch must be one of {DISPATCHES}, "
                         f"got {dispatch!r}")
    if dispatch == "dense" or plan.get("schedule") is None:
        return "dense"
    raise NotImplementedError(
        f"dispatch={dispatch!r} needs the sparse bw_gemm kernels, which "
        f"are not ported yet; use dispatch='dense'")


def planned_dense_apply(plan: dict, x: torch.Tensor, spec, n_out: int, *,
                        bias=None, activation=None,
                        out_dtype=torch.float32, fused: bool = True,
                        dispatch: str = "dense") -> torch.Tensor:
    """y = act((x @ w)_int * s_x * s_w + bias) through the bw_gemm kernel.

    plan: record from plan_dense_weight, built under the same spec.
    Activations are quantized here per the spec's act_quant policy:
    ``per_tensor`` folds the single activation scale into the per-channel
    weight scale; ``per_token`` keeps one scale per activation row and
    (fused=True) hands it to the kernel epilogue as a per-column vector,
    since tokens sit on the kernel N axis.  fused=True runs dequant, bias
    and activation in the kernel epilogue; fused=False takes the int32
    accumulator from the kernel and runs the epilogue here.
    """
    spec = QuantSpec.coerce(spec)
    digits, mask = plan["digits"], plan["mask"]
    bw_n, m_pad, k_pad = digits.shape
    if bw_n != spec.num_digits:
        raise ValueError(
            f"plan record has {bw_n} digit planes but spec "
            f"{spec.encoding!r}/{spec.bits}b implies {spec.num_digits}; "
            f"was the plan built under a different spec?")
    block_m = m_pad // mask.shape[1]
    block_k = k_pad // mask.shape[2]
    _resolve_dispatch(dispatch, plan)
    k = x.shape[-1]
    lead = x.shape[:-1]
    per_token = spec.act_quant == "per_token"
    qx, sx = quantlib.quantize_for_spec(x.to(torch.float32), spec,
                                        axis=-1 if per_token else None)
    bt = _pad_to(qx.reshape(-1, k), block_k, 1)     # [N, K_pad]: token rows
    batch = bt.shape[0]
    inv_perm = plan["inv_perm"].long()
    if fused:
        scale_rows = plan["sw_rows"] if per_token else plan["sw_rows"] * sx
        sx_cols = sx.reshape(1, -1) if per_token else None
        bias_rows = None
        if bias is not None:
            bias_rows = _channel_rows(bias, n_out, m_pad, plan["row_perm"])
        out = _bw.bw_gemm_fused(
            digits, bt, mask, scale_rows, bias_rows, sx_cols,
            block_m=block_m, block_k=block_k, radix=spec.radix,
            activation=activation, epilogue_axis="m")
        y = out[inv_perm][:n_out].t()
    else:
        acc = _bw.bw_gemm(digits, bt, mask, block_m=block_m,
                          block_k=block_k, radix=spec.radix)
        acc = acc[inv_perm][:n_out]
        sw = plan["sw_rows"][inv_perm][:n_out]        # original order
        s = sw * (sx.reshape(1, -1) if per_token else sx)
        y = (acc.to(torch.float32) * s).t()
        if bias is not None:
            y = y + bias.to(torch.float32)
        if activation is not None:
            y = _bw.EPILOGUE_ACTIVATIONS[activation](y)
    return y.reshape(*lead, n_out).to(out_dtype)


def quantized_dense(x: torch.Tensor, w: torch.Tensor, spec, *, bias=None,
                    activation=None, out_dtype=torch.float32,
                    fused: bool = True,
                    dispatch: str = "dense") -> torch.Tensor:
    """Kernel-path dense on a raw weight: plan it, then apply.

    x: [..., K] float; w: [K, N] float; bias: optional [N].  The weight is
    planned on every call; serving plans once through plan_params.
    """
    spec = QuantSpec.coerce(spec)
    plan = plan_dense_weight(w, spec)
    return planned_dense_apply(plan, x, spec, w.shape[1], bias=bias,
                               activation=activation, out_dtype=out_dtype,
                               fused=fused, dispatch=dispatch)


def plan_params(params, spec):
    """Attach a 'w_plan' record next to every dense weight in a param tree.

    The tree is nested dicts and lists (the port keeps its layers as a
    list); every dict holding a 2-D "w" gets a plan.  Returns
    (new_params, planned_count); the input tree is not mutated.
    """
    spec = QuantSpec.coerce(spec)
    count = 0

    def walk(node):
        nonlocal count
        if isinstance(node, list):
            return [walk(v) for v in node]
        if not isinstance(node, dict):
            return node
        out = {k: walk(v) for k, v in node.items()}
        w = node.get("w")
        if isinstance(w, torch.Tensor) and w.dim() == 2:
            out["w_plan"] = plan_dense_weight(w, spec)
            count += 1
        return out

    return walk(params), count


def plan_tree_density(params) -> Optional[float]:
    """Plane-block density over every 'w_plan' record in a planned param
    tree (weighted by block count); None when the tree holds no plans."""
    nnz = total = 0

    def walk(node):
        nonlocal nnz, total
        if isinstance(node, list):
            for v in node:
                walk(v)
            return
        if not isinstance(node, dict):
            return
        plan = node.get("w_plan")
        if isinstance(plan, dict) and "mask" in plan:
            nnz += int(plan["mask"].sum())
            total += plan["mask"].numel()
        for key, v in node.items():
            if key != "w_plan":
                walk(v)

    walk(params)
    return (nnz / total) if total else None
