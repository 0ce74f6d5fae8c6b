"""PyTorch/CUDA port of ``repro``: the bit-weight decomposed quantized
serving path on an NVIDIA Hopper card.

The package mirrors ``repro``'s layout module for module (``core``,
``engine``, ``kernels``, ``configs``, ``models``, ``serving``, ``launch``)
and keeps its names, its param-tree layout and its ``QuantSpec`` grammar,
so a spec string or a param tree means the same thing in both packages.
It imports ``torch`` and never ``jax`` or ``repro``: the numpy-only parts
it needs are copied, not imported.

Every entry point takes an explicit ``device`` that defaults to
``"cuda"``; without a card it raises instead of carrying on on the CPU
(pass ``device="cpu"`` to run there, as the tests do).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless told otherwise.

    Raises when a CUDA device is asked for (explicitly or by default) and
    none is present, so a missing card never silently turns into a CPU
    run.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev
