"""Hardware cost model for the paper's PE micro-architectures.

Encodes the paper's synthesis data (SMIC 28nm-HKCP-RVT, 0.72V):

  * Table I  -- INT8 MAC component decomposition at a 2ns clock.
  * Table V  -- 4-2 compressor tree: delay is *independent of bit-width*
                (the key property behind OPT1).
  * Table VII -- array-level area/power/frequency for the four classic TPE
                architectures, the bit-slice baselines, and OPT1..OPT4E.
  * Fig. 9/14 anchors -- PE-level area scaling vs clock constraint.

Two layers:
  1. a *data* layer holding the published numbers (the reproduction target);
  2. a *model* layer that prices a component census (repro_torch.core.notation)
     with Table I/V entries and predicts PE area -- validated against the
     published PE areas in tests.

All areas um^2, delays ns, power W (arrays) / uW (components), freqs MHz.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "TABLE1_MAC", "TABLE1_ACC", "TABLE5_COMPRESSOR", "COMPONENTS",
    "component_area", "component_delay", "ArrayDesign", "TABLE7",
    "peak_tops", "area_efficiency", "energy_efficiency", "table7_report",
    "efficiency_ratios", "pe_area_model", "PE_AREA_ANCHORS",
    "PAPER_AVG_PPS_ENT",
]

# Average non-zero PPs per EN-T-encoded INT8 operand on the paper's
# normally-distributed test vectors (Table III / Sec. V-D).  Our own
# measurement gives 2.24; the published array numbers are consistent with
# 2.27, which we keep for the faithful reproduction path.
PAPER_AVG_PPS_ENT = 2.27

# --------------------------- Table I ---------------------------------------
# width -> (area um^2, delay ns, power uW) @ 2ns clock
TABLE1_MAC = {20: (179.30, 1.56, 27.1), 24: (192.65, 1.67, 29.2),
              28: (206.01, 1.84, 31.4), 32: (238.51, 1.97, 36.3)}
TABLE1_ACC = {20: (57.32, 0.80, 8.6), 24: (62.43, 0.90, 9.4),
              28: (82.78, 0.99, 12.3), 32: (95.13, 1.13, 14.3)}
TABLE1_COMPRESSOR_14 = (55.92, 0.31, 8.5)
TABLE1_FULL_ADDER_14 = (51.32, 0.34, 7.7)

# --------------------------- Table V ---------------------------------------
# width -> (area um^2, delay ns): delay flat at ~0.32ns for any width.
TABLE5_COMPRESSOR = {14: (52.92, 0.31), 16: (60.98, 0.32), 20: (77.11, 0.32),
                     24: (93.99, 0.32), 28: (110.12, 0.32), 32: (126.25, 0.32)}


def _interp(table: Dict[int, tuple], width: int, col: int) -> float:
    ws = sorted(table)
    vals = [table[w][col] for w in ws]
    return float(np.interp(width, ws, vals))


# Per-component unit costs used to price a census.  Derived from Tables I/V
# plus standard-cell estimates for the small front-end blocks (the paper does
# not list them separately; values chosen so that the modelled PE areas match
# the published 246 / 81.27 / 311 um^2 anchors -- see tests).
COMPONENTS = {
    # name: (area per instance as fn(width), delay ns fn(width))
    # Front-end unit costs are calibrated so a census-priced MAC matches
    # Table I: MAC@32 (238.5um^2) - compressor(55.9) - FA(51.3) - acc(95.1)
    # leaves ~36um^2 for the whole encode/CPPG/mux/shift front end.
    "encoder":        (lambda w: 2.0,                lambda w: 0.08),
    "sparse_encoder": (lambda w: 2.2 * w,            lambda w: 0.12),
    "cppg_mux":       (lambda w: 0.5 * w,            lambda w: 0.10),
    "shifter":        (lambda w: 0.25 * w,           lambda w: 0.12),
    "compressor":     (lambda w: _interp(TABLE5_COMPRESSOR, w, 0),
                       lambda w: _interp(TABLE5_COMPRESSOR, w, 1)),
    "compressor3_2":  (lambda w: 0.45 * _interp(TABLE5_COMPRESSOR, w, 0),
                       lambda w: 0.29),
    "compressor6_2":  (lambda w: 0.9 * _interp(TABLE5_COMPRESSOR, w, 0),
                       lambda w: 0.40),
    "full_adder":     (lambda w: 51.32 * w / 14.0,   lambda w: 0.34 + 0.056 * (w - 14)),
    "accumulator":    (lambda w: _interp(TABLE1_ACC, w, 0),
                       lambda w: _interp(TABLE1_ACC, w, 1)),
    "dff_in":         (lambda w: 1.1 * w,            lambda w: 0.0),
    "dff_out":        (lambda w: 1.1 * w,            lambda w: 0.0),
    "simd_adder":     (lambda w: 51.32 * w / 14.0,   lambda w: 0.0),  # pipelined, off critical path
    "simd_shifter":   (lambda w: 1.6 * w,            lambda w: 0.0),
}


def component_area(name: str, width: int) -> float:
    return COMPONENTS[name][0](width)


def component_delay(name: str, width: int) -> float:
    return COMPONENTS[name][1](width)


def pe_area_model(census: Dict[str, float], n_pe: int) -> float:
    """Area per PE (um^2) from a census of a whole array.

    simd_* components live in the vector core OUTSIDE the PE array — the
    paper's PE area/power measurements cover "PE input/output DFFs,
    combinational logic, and clock networks" only (Sec. V-A), so they are
    excluded here (they are still counted by the census for honesty)."""
    total = 0.0
    for key, count in census.items():
        name, width = key.rsplit("@", 1)
        if name.startswith("simd_"):
            continue
        total += count * component_area(name, int(width))
    return total / n_pe


# Published single-PE area anchors (um^2): Fig. 14 caption.
PE_AREA_ANCHORS = {"baseline": 246.0, "opt4c": 81.27, "opt4e_group": 311.0}


# --------------------------- Table VII -------------------------------------

@dataclasses.dataclass(frozen=True)
class ArrayDesign:
    name: str
    freq_mhz: float
    area_um2: float
    power_w: float
    n_pe: int = 1024            # PE (or PE-lane) count used for peak perf
    avg_pps: float = 1.0        # serial designs retire 1 PP/cycle/PE
    published_peak_tops: Optional[float] = None
    published_tops_per_w: Optional[float] = None
    published_tops_per_mm2: Optional[float] = None
    family: str = "classic"     # classic | bitslice | ours
    base: Optional[str] = None  # baseline this design is compared against


TABLE7: Dict[str, ArrayDesign] = {d.name: d for d in [
    # -- published baselines (others') --------------------------------------
    ArrayDesign("tpu",       1000, 370631, 0.25, 1024, 1.0, 2.05, 8.05, 5.53),
    ArrayDesign("ascend",    1000, 320783, 0.24, 1024, 1.0, 2.05, 8.21, 7.22),
    ArrayDesign("trapezoid", 1000, 283704, 0.22, 1024, 1.0, 2.05, 9.31, 7.22),
    ArrayDesign("flexflow",  1000, 332848, 0.28, 1024, 1.0, 2.05, 7.29, 6.15),
    ArrayDesign("laconic",   1000, 213248, 1.21, 0,    1.0, 0.81, 0.67, 3.77,
                family="bitslice"),
    ArrayDesign("bitlet",    1000, 415800, 0.23, 0,    1.0, 0.74, 3.29, 1.79,
                family="bitslice"),
    ArrayDesign("sibia",      250, 1069000, 0.10, 0,   1.0, 0.77, 7.65, 0.72,
                family="bitslice"),
    ArrayDesign("bitwave",    250, 861681, 0.01, 0,    1.0, 0.22, 14.77, 0.25,
                family="bitslice"),
    # -- ours ----------------------------------------------------------------
    ArrayDesign("opt1_tpu",       1500, 436646, 0.37, 1024, 1.0,
                family="ours", base="tpu"),
    ArrayDesign("opt1_ascend",    1500, 332185, 0.24, 1024, 1.0,
                family="ours", base="ascend"),
    ArrayDesign("opt1_trapezoid", 1500, 271989, 0.22, 1024, 1.0,
                family="ours", base="trapezoid"),
    ArrayDesign("opt1_flexflow",  1500, 373898, 0.38, 1024, 1.0,
                family="ours", base="flexflow"),
    ArrayDesign("opt2_flexflow",  1500, 347216, 0.35, 1024, 1.0,
                family="ours", base="flexflow"),
    ArrayDesign("opt3",  2000, 460349, 0.70, 1024, PAPER_AVG_PPS_ENT,
                family="ours", base="laconic"),
    ArrayDesign("opt4c", 2500, 259298, 0.51, 1024, PAPER_AVG_PPS_ENT,
                family="ours", base="laconic"),
    ArrayDesign("opt4e", 2000, 672419, 0.89, 4096, PAPER_AVG_PPS_ENT,
                family="ours", base="laconic"),
]}


def peak_tops(d: ArrayDesign) -> float:
    """Peak performance: 2 ops/MAC * N_pe * f / avg PPs-per-MAC."""
    if d.published_peak_tops is not None and d.family != "ours":
        return d.published_peak_tops
    return 2.0 * d.n_pe * d.freq_mhz * 1e6 / d.avg_pps / 1e12


def area_efficiency(d: ArrayDesign) -> float:
    """TOPS / mm^2."""
    return peak_tops(d) / (d.area_um2 * 1e-6)


def energy_efficiency(d: ArrayDesign) -> float:
    """TOPS / W."""
    return peak_tops(d) / d.power_w


def efficiency_ratios() -> Dict[str, Dict[str, float]]:
    """Our designs' improvement factors over their published baselines.

    Reproduces the abstract's headline numbers: area-efficiency x1.27 / x1.28
    / x1.56 / x1.44 for systolic / 3D-Cube / adder-tree / 2D-Matrix, energy
    x1.04 / x1.56 / x1.49 / x1.20, and OPT4E vs Laconic x2.85 area / x12.10
    energy.
    """
    out = {}
    for d in TABLE7.values():
        if d.family != "ours" or d.base is None:
            continue
        b = TABLE7[d.base]
        base_ae = b.published_tops_per_mm2 or area_efficiency(b)
        base_ee = b.published_tops_per_w or energy_efficiency(b)
        out[d.name] = {
            "area_eff": area_efficiency(d) / base_ae,
            "energy_eff": energy_efficiency(d) / base_ee,
        }
    return out


def table7_report() -> List[dict]:
    rows = []
    for d in TABLE7.values():
        rows.append({
            "design": d.name, "freq_mhz": d.freq_mhz,
            "area_um2": d.area_um2, "power_w": d.power_w,
            "peak_tops": round(peak_tops(d), 3),
            "tops_per_mm2": round(area_efficiency(d), 2),
            "tops_per_w": round(energy_efficiency(d), 2),
            "published_tops_per_mm2": d.published_tops_per_mm2,
            "published_tops_per_w": d.published_tops_per_w,
        })
    return rows


# --------------------------- Fig. 9 anchors --------------------------------
# (design -> {freq_ghz: PE area um^2-ish anchors and max usable frequency})
FIG9 = {
    "baseline": {"area": {1.0: 367.0, 1.5: 707.0}, "fmax_ghz": 1.5,
                 "best_ghz": 1.0},
    "opt1":     {"area": {1.0: 380.0, 1.5: 433.0}, "fmax_ghz": 2.0,
                 "best_ghz": 1.5},   # x1.14 growth 1.0 -> 1.5 GHz
    "opt3":     {"area": {1.5: 440.0, 2.0: 480.0}, "fmax_ghz": 2.5,
                 "best_ghz": 2.0},   # x1.09 growth 1.5 -> 2.0 GHz
    "opt4c":    {"area": {2.0: 230.0, 2.5: 253.0}, "fmax_ghz": 3.0,
                 "best_ghz": 2.5},
    "opt4e":    {"area": {1.5: 610.0, 2.0: 657.0}, "fmax_ghz": 2.0,
                 "best_ghz": 2.0},
}


def max_frequency_ghz(design: str) -> float:
    return FIG9[design]["fmax_ghz"]


def area_growth(design: str) -> float:
    """Area growth factor across the design's published frequency step."""
    a = FIG9[design]["area"]
    ks = sorted(a)
    return a[ks[-1]] / a[ks[0]]
