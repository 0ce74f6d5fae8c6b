"""Mixture-of-Experts FFN with capacity-bounded scatter dispatch
(``repro.models.moe``).

Top-k routing, the Switch load-balancing auxiliary loss, and an
O(tokens * d) scatter/gather dispatch (no [tokens, E, C] one-hot einsum).
The experts run as bf16 einsums on ``w_up`` / ``w_gate`` / ``w_down``:
``ops.plan_params`` plans only dicts keyed ``w`` and leaves the router
raw, so no expert weight goes through the bit-weight kernels, as in the
reference.

The reference shards the experts over a mesh (``cfg.moe_shard``) and
pins its buffers' layouts; on one device both are the identity on the
value, so the port has neither.  ``cfg.moe_dispatch_groups`` > 1 splits
the tokens into groups, each with its own capacity slots, as the
reference's data-parallel local dispatch does.

Three choices keep the result the reference's, bit for bit in bf16:

* top-k keeps the lower expert index first on equal probabilities, as
  ``jax.lax.top_k`` does (a stable descending sort; ``torch.topk`` takes
  the higher one);
* the combine adds a token's k weighted expert outputs in slot order,
  one bf16 add at a time from zeros, as XLA's scatter-add does
  (``index_add_`` rounds otherwise, and on the card in no fixed order);
* the counts and ranks of the dispatch need no host sync.
"""
from __future__ import annotations

import math

import torch

from . import layers as L

__all__ = ["moe_init", "moe_apply"]


def moe_init(gen: torch.Generator, cfg, device) -> dict:
    """Random float32 router [d, e] and experts [e, d, f] / [e, f, d]."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def w(shape):
        return L.truncated_normal(gen, shape, 1.0, device).div_(
            math.sqrt(shape[1]))

    p = {"router": {"w": L.truncated_normal(gen, (d, e), 1.0, device)},
         "w_up": w((e, d, f)),
         "w_down": w((e, f, d))}
    if cfg.gated_mlp:
        p["w_gate"] = w((e, d, f))
    return p


def _route(xf, router_w, k: int):
    """Tokens [T, d] -> (probs [T, e], gate [T, k], eidx [T, k]): float32
    router logits, softmax, top-k with lower indices first on ties,
    gates renormalized."""
    logits = xf.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = vals[:, :k], idx[:, :k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return probs, gate, eidx


def _dispatch(xf, eidx, gate, e: int, k: int, cap: int, dtype):
    """Tokens [T, d] + routing [T, k] -> (buf [e, cap, d], dest, wgt).

    A pick's rank is its place among the picks of its expert in token
    order; picks ranked ``cap`` or later are dropped: they are written to
    the dump row ``e * cap``, which is cut off (the only row two picks
    write), and weigh 0 in the combine."""
    d = xf.shape[1]
    flat_e = eidx.reshape(-1)                                 # [T*k]
    tk = flat_e.shape[0]
    dev = xf.device
    order = torch.argsort(flat_e, stable=True)
    # bincount without its host sync (it sizes its output by the max)
    counts = torch.zeros((e,), dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts                 # exclusive
    ranks_sorted = torch.arange(tk, device=dev) - starts[flat_e[order]]
    ranks = torch.empty_like(ranks_sorted).scatter_(0, order, ranks_sorted)
    keep = ranks < cap                                        # dropped beyond C
    tok_idx = torch.arange(tk, device=dev) // k
    dest = torch.where(keep, flat_e * cap + ranks, e * cap)   # dump slot
    buf = torch.zeros((e * cap + 1, d), dtype=dtype, device=dev)
    buf[dest] = xf[tok_idx].to(dtype)
    wgt = gate.reshape(-1).masked_fill(~keep, 0.0).to(dtype)
    return buf[:e * cap].reshape(e, cap, d), dest, wgt


def _combine(out, dest, wgt, n_tok: int, k: int, dtype):
    """Expert outputs [e, cap, d] -> token outputs [T, d]: a token's k
    picks are contiguous (pick i is token i // k's), added in slot order
    in ``dtype`` from zeros."""
    e_cap = out.shape[0] * out.shape[1]
    out_flat = out.reshape(e_cap, -1)
    vals = out_flat[torch.clamp_max(dest, e_cap - 1)]
    contrib = (vals * wgt[:, None]).reshape(n_tok, k, -1)
    y = torch.zeros((n_tok, out.shape[-1]), dtype=dtype, device=out.device)
    for slot in range(k):
        y = y + contrib[:, slot]
    return y


def _experts(buf, p, cfg, dtype, lead: str = ""):
    """The experts' FFN on dispatch buffers [.., e, cap, d] (``lead`` names
    the leading group axis in the einsums): bf16 copies of the float32
    weights, as the reference casts them every call, and its activation
    op by op on the einsum output."""
    act = L.activation(cfg.act)
    up = torch.einsum(f"{lead}ecd,edf->{lead}ecf", buf, p["w_up"].to(dtype))
    if cfg.gated_mlp:
        gt = torch.einsum(f"{lead}ecd,edf->{lead}ecf", buf,
                          p["w_gate"].to(dtype))
        h = act(gt) * up
    else:
        h = act(up)
    return torch.einsum(f"{lead}ecf,efd->{lead}ecd", h, p["w_down"].to(dtype))


def moe_apply(p, x, cfg, dtype=torch.bfloat16):
    """x: [B, T, d] -> (y [B, T, d], aux_loss float32 scalar)."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    g = max(int(cfg.moe_dispatch_groups), 1)
    xf = x.reshape(-1, d)
    n_tok = xf.shape[0]
    if n_tok % g:
        raise ValueError(f"{n_tok} tokens do not split into "
                         f"{g} dispatch groups")
    # the reference's float64 arithmetic, in its order
    cap = int(math.ceil(n_tok / g * k / e * cfg.capacity_factor))

    probs, gate, eidx = _route(xf, p["router"]["w"], k)

    # load-balance aux loss (Switch): E * sum_e f_e * P_e
    me = probs.mean(dim=0)                                    # mean prob/expert
    ce = torch.nn.functional.one_hot(eidx[:, 0], e).to(
        torch.float32).mean(dim=0)                            # dispatch frac
    aux = cfg.router_aux_coef * e * torch.sum(me * ce)

    if g == 1:
        buf, dest, wgt = _dispatch(xf, eidx, gate, e, k, cap, dtype)
        out = _experts(buf, p, cfg, dtype)
        y = _combine(out, dest, wgt, n_tok, k, dtype)
        return y.reshape(b, t, d), aux

    # per-group dispatch, each group with its own capacity slots
    tg = n_tok // g
    groups = [_dispatch(xf[i * tg:(i + 1) * tg], eidx[i * tg:(i + 1) * tg],
                        gate[i * tg:(i + 1) * tg], e, k, cap, dtype)
              for i in range(g)]
    out = _experts(torch.stack([grp[0] for grp in groups]), p, cfg, dtype,
                   lead="g")                                  # [g,e,cap,d]
    y = torch.cat([_combine(out[i], dest, wgt, tg, k, dtype)
                   for i, (_, dest, wgt) in enumerate(groups)])
    return y.reshape(b, t, d), aux
