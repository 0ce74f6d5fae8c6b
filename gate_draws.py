"""chip_smoke.py's decode gates read over several draws of inputs, on the card.

Phase 12 (d) holds hymba-1.5b's token-by-token decode (from zero caches) to
its forward without meta tokens; phase 13 (c) holds seamless-m4t-medium's
prime + teacher-forced decode to its forward.  Each gates a sound decode and
three broken ones on one draw of tokens (and frames).  This script reads the
same decodes through B1 on several draws, chip_smoke.py's own among them, at
several depths, with the phases' full-width params (seed 0), so that a gate
can be set between the largest sound reading and the smallest broken one at
a depth where they part on every draw.  For a sound decode that parts from
its forward it also finds where the two first part (``first_divergence``):
the first ``layers.dense_apply`` call (a planned projection on B1, or a
float32 projection) whose input or output differs between the forward's
position and the decode step, with the two values at its first differing
element.

    python3 gate_draws.py [--out READINGS.json]

Needs one card.  Prints one JSON line per reading, and with ``--out``
writes them all to that file.
"""

import contextlib
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# hymba's token draws: seed 11 is phase 12's; encdec's: phase 13's (tokens
# from seed 11, frames drawn after the params), then tokens and frames from
# each seed.
HYMBA_SEEDS = (11, 12, 13, 14, 15)
ENCDEC_SEEDS = (12, 13, 14, 15)
HYMBA_SOUND_DEPTHS = (1, 2, 4, 8, 16, 32)
HYMBA_BROKEN_DEPTHS = (1, 4, 32)
ENCDEC_DEPTHS = (1, 12)
# The widths a row that the token draws take: 385 is what phase 12 (b)'s
# forward of 384 tokens draws; 897 is the width it drew before that cut.
HYMBA_DRAW_WIDTHS = {11: (385, 897)}
DIVERGENCES = 2          # sound decodes a model that get a divergence walk


def stats(row) -> dict:
    return {k: row[k] for k in ("tokens_differ", "max_logit_gap",
                                "mean_logit_gap")} | {
        "max_margin": max(row["margins"], default=0.0)}


@contextlib.contextmanager
def recording(params):
    """Record every ``layers.dense_apply`` call as (name, input, output)
    while active; a call's name is its weight's path in ``params``."""
    from repro_torch.models import layers as L

    names = {}

    def walk(node, path):
        if isinstance(node, dict):
            if "w" in node:
                names[id(node)] = path
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}")
    walk(params, "")
    calls, real = [], L.dense_apply

    def dense_apply(p, x, *a, **k):
        y = real(p, x, *a, **k)
        calls.append((names.get(id(p), "?"), x.detach().clone(),
                      y.detach().clone()))
        return y
    L.dense_apply = dense_apply
    try:
        yield calls
    finally:
        L.dense_apply = real


def ulp(v: float, dtype) -> float:
    import torch
    return torch.finfo(dtype).eps * 2.0 ** math.floor(math.log2(abs(v))) \
        if v else torch.finfo(dtype).tiny


def first_divergence(forward, steps) -> dict:
    """``forward``: the forward's calls [(name, x [B, T, K], y)];
    ``steps``: each decode step's calls, step s at position s.  Walks the
    forward's calls in order and, for each name that the steps also call,
    compares the forward's input (then output) at every position with
    that step's: the first that differs, where, by how many elements,
    and its first differing element's two values beside an ulp of the
    forward's one; and how many calls before it matched."""
    import torch

    by_step = [{name: (x, y) for name, x, y in calls} for calls in steps]
    matched = 0
    for name, xf, yf in forward:
        if name not in by_step[0] or xf.dim() != 3:
            continue
        for what, f, idx in (("input", xf, 0), ("output", yf, 1)):
            for s, calls in enumerate(by_step):
                d, w = calls[name][idx][:, 0], f[:, s]
                if torch.equal(d, w):
                    continue
                diff = d.float() != w.float()
                where = diff.nonzero()[0].tolist()
                a, b = float(w[tuple(where)]), float(d[tuple(where)])
                return {"call": name, "differs": what, "position": s,
                        "rows": diff.flatten(1).any(1).nonzero()
                        .flatten().tolist(),
                        "elements": int(diff.sum()),
                        "of": int(diff[0].numel()),
                        "max_abs": float((d.float() - w.float()).abs()
                                         .max()),
                        "first": {"at": where, "forward": a, "decode": b,
                                  "dtype": str(w.dtype),
                                  "ulp": ulp(a, w.dtype)},
                        "calls_matched_before": matched}
        matched += 1
    return {"call": None, "calls_matched_before": matched}


def hymba_divergence(cfg, params, toks, dev) -> dict:
    import torch
    from repro_torch.models import hymba as H

    b, t = toks.shape
    with torch.no_grad(), recording(params) as calls:
        H.hymba_lm_apply(params, toks, cfg, dev, with_meta=False)
        forward, steps = list(calls), []
        state = H.init_hymba_caches(cfg, b, device=dev)
        for i in range(t):
            calls.clear()
            _, state = H.hymba_lm_decode_step(
                params, toks[:, i:i + 1],
                torch.full((b,), i, dtype=torch.int32, device=dev), state,
                cfg)
            steps.append(list(calls))
    return first_divergence(forward, steps)


def encdec_divergence(cfg, params, toks, frames, dev) -> dict:
    import torch
    from repro_torch.models import encdec as E

    b, t = toks.shape
    with torch.no_grad(), recording(params) as calls:
        E.encdec_apply(params, toks, cfg, dev, frontend_embeds=frames)
        forward = list(calls)
        calls.clear()
        cross = E.encdec_prime_cross(params, frames, cfg, dev)
        prime = {name: (x, y) for name, x, y in calls}
        state = E.init_encdec_caches(cfg, b, t + 1, cfg.frontend_tokens,
                                     device=dev)
        state["xk"], state["xv"] = cross["xk"], cross["xv"]
        steps = []
        for i in range(t):
            calls.clear()
            _, state = E.encdec_decode_step(
                params, toks[:, i:i + 1],
                torch.full((b,), i, dtype=torch.int32, device=dev), state,
                cfg)
            steps.append(list(calls))
    out = first_divergence(forward, steps)
    out["prime_equals_forward"] = all(
        torch.equal(x, prime[name][0]) and torch.equal(y, prime[name][1])
        for name, x, y in forward if name in prime)
    return out


def hymba_draws(seeds, dev, emit) -> None:
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import get_api
    from repro_torch.serving.engine import ServeEngine

    cfg = get_config(cs.HYMBA_ARCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = get_api(cfg).init(gen, cfg, dev)
    cs.hymba_draw_constants(params, gen)
    eng = ServeEngine(cfg, 3, cs.DENSE_MAX_LEN,
                      quant=cs.spec_of("pallas_fused"), params=params,
                      device=dev)
    walks = 0
    for seed in seeds:
        for width in HYMBA_DRAW_WIDTHS.get(seed, (385,)):
            rng = np.random.default_rng(seed)
            toks = torch.as_tensor(rng.integers(
                0, cfg.vocab_size, (cs.HYMBA_FORWARD_SIZE[0], width)),
                device=dev)[:, :cs.HYMBA_DECODE_TOKENS]
            for depth in sorted(set(HYMBA_SOUND_DEPTHS)
                                | set(HYMBA_BROKEN_DEPTHS)):
                variants = ((None,) if depth in HYMBA_SOUND_DEPTHS else ()) \
                    + (cs.HYMBA_BROKEN if depth in HYMBA_BROKEN_DEPTHS
                       else ())
                c = cfg.replace(n_layers=depth)
                p = dict(eng.params, blocks=eng.params["blocks"][:depth])
                t0 = time.perf_counter()
                rows = cs.hymba_handoff(c, p, toks, dev, variants)
                row = {"model": cs.HYMBA_ARCH, "draw": f"{seed}/{width}",
                       "layers": depth, "seconds": time.perf_counter() - t0,
                       **{str(k): stats(r) for k, r in rows.items()}}
                if depth == cfg.n_layers and walks < DIVERGENCES and \
                        rows[None]["max_logit_gap"] > 0:
                    walks += 1
                    row["first_divergence"] = hymba_divergence(c, p, toks,
                                                               dev)
                emit(row)
    del eng, params
    cs.free_device_memory()


def encdec_draws(seeds, dev, emit) -> None:
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import get_api
    from repro_torch.serving.engine import ServeEngine

    cfg = get_config(cs.ENCDEC_ARCH)
    b, t = cs.ENCDEC_FORWARD_SIZE
    gen = torch.Generator(device=dev).manual_seed(0)
    params = get_api(cfg).init(gen, cfg, dev)
    draws = [("11/phase", 11, gen)] + [
        (f"{s}/{s}", s, torch.Generator(device=dev).manual_seed(s))
        for s in seeds]
    eng = ServeEngine(cfg, 3, cs.DENSE_MAX_LEN,
                      quant=cs.spec_of("pallas_fused"), params=params,
                      device=dev)
    walks = 0
    for label, seed, fgen in draws:
        frames = torch.randn((b, cfg.frontend_tokens, cfg.d_model),
                             generator=fgen, device=dev)
        rng = np.random.default_rng(seed)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, t + 1)),
                               device=dev)[:, :t]
        for depth in ENCDEC_DEPTHS:
            c = cfg.replace(n_layers=depth)
            p = dict(eng.params, dec_blocks=eng.params["dec_blocks"][:depth])
            t0 = time.perf_counter()
            with torch.no_grad():
                want = eng.api.forward(p, {"tokens": toks, "frontend": frames},
                                       c, dev)[0].float()
            rows = cs.encdec_handoff(c, p, toks, frames, want, dev,
                                     (None,) + cs.ENCDEC_BROKEN)
            rows.pop("prime_launches")
            row = {"model": cs.ENCDEC_ARCH, "draw": label, "layers": depth,
                   "seconds": time.perf_counter() - t0,
                   **{str(k): stats(r) for k, r in rows.items()}}
            del want
            if depth == cfg.n_layers and walks < DIVERGENCES and \
                    rows[None]["max_logit_gap"] > 0:
                walks += 1
                row["first_divergence"] = encdec_divergence(c, p, toks,
                                                            frames, dev)
            emit(row)
    del eng, params
    cs.free_device_memory()


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=None,
                        help="a file to write every reading to, as JSON")
    args = parser.parse_args(argv)
    print(cs.card_line(), flush=True)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("gate_draws: no CUDA device is available")
    from repro_torch.kernels import _build

    _build.load_all()
    dev = torch.device("cuda")
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)
    hymba_draws(HYMBA_SEEDS, dev, emit)
    encdec_draws(ENCDEC_SEEDS, dev, emit)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": cs.card_line(),
                                        "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
