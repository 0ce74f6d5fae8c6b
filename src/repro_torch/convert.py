"""Turn a reference param tree (numpy arrays) into the port's params.

The input is the reference engine's tree as numpy, e.g.
``jax.tree.map(np.asarray, unbox(engine.params))``: nested dicts with the
layers stacked on a leading axis under ``blocks`` ([L, ...]; an MoE
layer's experts [L, e, d, f] and router [L, d, e] too), or, in an
encoder-decoder tree, under ``enc_blocks`` ([n_encoder_layers, ...])
and ``dec_blocks`` ([n_layers, ...]).  The port keeps each stack as a
list of per-layer dicts and every other leaf as it is, with weights in
the reference's [d_in, d_out] layout, so it plans the same matrices.
``w_plan`` records are dropped: the port plans for itself.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["params_from_numpy"]


def _tensors(node, device, layer=None):
    if isinstance(node, dict):
        return {k: _tensors(v, device, layer) for k, v in node.items()
                if k != "w_plan"}
    arr = np.asarray(node)
    if layer is not None:
        arr = arr[layer]
    return torch.as_tensor(np.array(arr), device=device)   # a private copy


def params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The port's param tree for ``cfg`` from a reference numpy tree."""
    dev = resolve_device(device)
    depths = {"blocks": cfg.n_layers, "enc_blocks": cfg.n_encoder_layers,
              "dec_blocks": cfg.n_layers}
    return {k: ([_tensors(v, dev, layer=i) for i in range(depths[k])]
                if k in depths else _tensors(v, dev))
            for k, v in tree.items()}
