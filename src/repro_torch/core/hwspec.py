"""Hardware specifications for five generations of TPU training supercomputers.

This module encodes Table 1 of the paper as typed data, plus TPU v5e (the
roofline TARGET of the reference's dry-runs). Everything the paper derives
from Table 1 — scaling ratios, bisection bandwidth, pod peak ExaFLOPS,
relative perf/W — is recomputed from these records. The port's copy of
``repro.core.hwspec``: these are the TPU tables the fleet simulator
models, not measurements of the port on its GPU.

Units follow the paper: TFLOPS are peak per chip; HBM BW GB/s per chip; ICI
link BW GB/s *per direction* (the paper's footnote 4); pod bisection GB/s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MXUSpec:
    """Matrix-multiply unit configuration (systolic arrays)."""

    count: int
    rows: int
    cols: int
    dtype: str  # "bf16" or "fp8"

    @property
    def macs_per_cycle(self) -> int:
        return self.count * self.rows * self.cols


@dataclasses.dataclass(frozen=True)
class TPUSpec:
    """One generation of training TPU (one column of Table 1)."""

    name: str
    year: int
    peak_bf16_tflops: float
    peak_fp8_tflops: Optional[float]  # None -> N.A. in the paper's table
    mxus: Tuple[MXUSpec, ...]
    vmem_mib: int
    hbm_version: str
    hbm_stacks: int
    hbm_gib: int
    hbm_gbps: float
    tensorcores: int
    sparsecores: int
    cooling: str  # "air" | "liquid"
    tpus_per_host: int
    pod_size: int
    pod_topology: str  # "2d_torus" | "3d_torus"
    ici_links: int
    ici_link_gbps: float
    # Relative rows of Table 1 (normalized to TPU v2 = 1).
    rel_pod_tflops: float  # normalized FP8 FLOPS
    rel_pod_tflops_per_watt: float  # per TDP watt
    rel_pod_tdp: float

    # ----- Derived quantities (the paper computes these from the above) -----

    @property
    def peak_tflops(self) -> float:
        """Best peak (FP8 if supported, else BF16) — Table 1 normalization."""
        return self.peak_fp8_tflops or self.peak_bf16_tflops

    @property
    def torus_dims(self) -> Tuple[int, ...]:
        """Torus shape. The paper gives pod size + topology; we use the
        deployed geometries (v2: 16x16, v3: 32x32, v4: 16x16x16,
        v5p: 16x20x28, Ironwood: 16x24x24)."""
        known: Dict[str, Tuple[int, ...]] = {
            "tpu_v2": (16, 16),
            "tpu_v3": (32, 32),
            "tpu_v4": (16, 16, 16),
            "tpu_v5p": (16, 20, 28),
            "ironwood": (16, 24, 24),
            "tpu_v5e": (16, 16),
        }
        if self.name in known:
            return known[self.name]
        # Fallback: balanced torus of the right dimensionality.
        ndims = 2 if self.pod_topology == "2d_torus" else 3
        side = round(self.pod_size ** (1.0 / ndims))
        return (side,) * ndims

    @property
    def pod_bisection_gbps(self) -> float:
        """Bisection bandwidth of the pod torus (GB/s, per direction).

        For a torus cut across its *longest* dimension the bisection crosses
        2 * (pod_size / longest_dim) links (wraparound doubles the cut).
        """
        dims = self.torus_dims
        longest = max(dims)
        cross_section = self.pod_size // longest  # nodes per "plane"
        return 2.0 * cross_section * self.ici_link_gbps

    @property
    def pod_peak_bf16_exaflops(self) -> float:
        return self.pod_size * self.peak_bf16_tflops / 1e6

    @property
    def pod_peak_fp8_exaflops(self) -> Optional[float]:
        if self.peak_fp8_tflops is None:
            return None
        return self.pod_size * self.peak_fp8_tflops / 1e6

    @property
    def pod_hbm_gib(self) -> float:
        """Pod-level directly addressable HBM in GiB. The paper's Table 1 row
        "Pod HBM Capacity" is this value / 1000 (e.g. Ironwood 1769472 GiB ->
        "1769"), mixing binary chip capacity with decimal pod units."""
        return float(self.pod_size * self.hbm_gib)

    @property
    def pod_hbm_table_units(self) -> float:
        """Table-1 convention: pod HBM in thousands of GiB."""
        return self.pod_hbm_gib / 1000.0

    @property
    def hosts_per_pod(self) -> int:
        return self.pod_size // self.tpus_per_host

    def matmul_peak_flops_per_cycle(self, dtype: str = "bf16") -> int:
        """2 * MACs/cycle for the MXUs of the given dtype."""
        return sum(2 * m.macs_per_cycle for m in self.mxus if m.dtype == dtype)


# --------------------------------------------------------------------------
# Table 1, verbatim.
# --------------------------------------------------------------------------

TPU_V2 = TPUSpec(
    name="tpu_v2", year=2017,
    peak_bf16_tflops=46.0, peak_fp8_tflops=None,
    mxus=(MXUSpec(2, 128, 128, "bf16"),),
    vmem_mib=32, hbm_version="HBM2", hbm_stacks=2, hbm_gib=16, hbm_gbps=700.0,
    tensorcores=2, sparsecores=2, cooling="air", tpus_per_host=4,
    pod_size=256, pod_topology="2d_torus", ici_links=4, ici_link_gbps=62.0,
    rel_pod_tflops=1.0, rel_pod_tflops_per_watt=1.0, rel_pod_tdp=1.0,
)

TPU_V3 = TPUSpec(
    name="tpu_v3", year=2018,
    peak_bf16_tflops=123.0, peak_fp8_tflops=None,
    mxus=(MXUSpec(4, 128, 128, "bf16"),),
    vmem_mib=32, hbm_version="HBM2", hbm_stacks=4, hbm_gib=32, hbm_gbps=900.0,
    tensorcores=2, sparsecores=2, cooling="liquid", tpus_per_host=8,
    pod_size=1024, pod_topology="2d_torus", ici_links=4, ici_link_gbps=70.0,
    rel_pod_tflops=10.0, rel_pod_tflops_per_watt=1.8, rel_pod_tdp=5.6,
)

TPU_V4 = TPUSpec(
    name="tpu_v4", year=2021,
    peak_bf16_tflops=275.0, peak_fp8_tflops=None,
    mxus=(MXUSpec(8, 128, 128, "bf16"),),
    vmem_mib=32, hbm_version="HBM2", hbm_stacks=4, hbm_gib=32, hbm_gbps=1200.0,
    tensorcores=2, sparsecores=4, cooling="liquid", tpus_per_host=4,
    pod_size=4096, pod_topology="3d_torus", ici_links=6, ici_link_gbps=50.0,
    rel_pod_tflops=100.0, rel_pod_tflops_per_watt=4.9, rel_pod_tdp=20.0,
)

TPU_V5P = TPUSpec(
    name="tpu_v5p", year=2023,
    peak_bf16_tflops=459.0, peak_fp8_tflops=459.0,
    mxus=(MXUSpec(8, 128, 128, "bf16"),),
    vmem_mib=128, hbm_version="HBM2E", hbm_stacks=6, hbm_gib=96,
    hbm_gbps=2765.0,
    tensorcores=2, sparsecores=4, cooling="liquid", tpus_per_host=4,
    pod_size=8960, pod_topology="3d_torus", ici_links=6, ici_link_gbps=100.0,
    rel_pod_tflops=350.0, rel_pod_tflops_per_watt=5.2, rel_pod_tdp=67.0,
)

IRONWOOD = TPUSpec(
    name="ironwood", year=2025,
    peak_bf16_tflops=2307.0, peak_fp8_tflops=4614.0,
    mxus=(MXUSpec(4, 256, 256, "bf16"), MXUSpec(4, 512, 512, "fp8")),
    vmem_mib=128, hbm_version="HBM3E", hbm_stacks=8, hbm_gib=192,
    hbm_gbps=7300.0,
    tensorcores=2, sparsecores=4, cooling="liquid", tpus_per_host=4,
    pod_size=9216, pod_topology="3d_torus", ici_links=6, ici_link_gbps=100.0,
    rel_pod_tflops=3600.0, rel_pod_tflops_per_watt=29.3, rel_pod_tdp=123.0,
)

# The dry-run/roofline TARGET for this repo (per task spec): TPU v5e.
# 197 TFLOP/s bf16; 819 GB/s HBM; ~50 GB/s/link ICI; 16 GiB HBM;
# 256-chip pod, 2D torus (16x16), 4 ICI links.
TPU_V5E = TPUSpec(
    name="tpu_v5e", year=2023,
    peak_bf16_tflops=197.0, peak_fp8_tflops=394.0,
    mxus=(MXUSpec(4, 128, 128, "bf16"),),
    vmem_mib=128, hbm_version="HBM2E", hbm_stacks=4, hbm_gib=16,
    hbm_gbps=819.0,
    tensorcores=1, sparsecores=4, cooling="air", tpus_per_host=4,
    pod_size=256, pod_topology="2d_torus", ici_links=4, ici_link_gbps=50.0,
    rel_pod_tflops=float("nan"), rel_pod_tflops_per_watt=float("nan"),
    rel_pod_tdp=float("nan"),
)

# Absolute TDP anchor for the paper's *relative* TDP row. The paper
# normalizes Pod TDP to TPU v2 = 1 and never states watts; the public TPU v2
# chip TDP (280 W) anchors the scale so the fleet simulator can integrate
# joules. Every other generation's absolute TDP is derived from its
# rel_pod_tdp, keeping the paper's ratios exact by construction.
TPU_V2_CHIP_TDP_W = 280.0
TPU_V2_POD_TDP_W = TPU_V2_CHIP_TDP_W * 256  # 71.68 kW


def pod_tdp_watts(spec: TPUSpec) -> Optional[float]:
    """Absolute pod TDP in watts (None when the paper gives no relative
    TDP for this part, e.g. TPU v5e)."""
    if math.isnan(spec.rel_pod_tdp):
        return None
    return spec.rel_pod_tdp * TPU_V2_POD_TDP_W


def chip_tdp_watts(spec: TPUSpec) -> Optional[float]:
    pod = pod_tdp_watts(spec)
    return None if pod is None else pod / spec.pod_size


GENERATIONS: Tuple[TPUSpec, ...] = (TPU_V2, TPU_V3, TPU_V4, TPU_V5P, IRONWOOD)

BY_NAME: Dict[str, TPUSpec] = {s.name: s for s in GENERATIONS + (TPU_V5E,)}


def get(name: str) -> TPUSpec:
    try:
        return BY_NAME[name]
    except KeyError:
        raise KeyError(
            f"unknown TPU generation {name!r}; have {sorted(BY_NAME)}"
        ) from None


def scaling_summary() -> Dict[str, float]:
    """Re-derive the paper's headline scaling claims from Table 1 data.

    Returns ratios Ironwood / TPU v2 (8 years):
      ~10x HBM capacity & bandwidth per node, ~100x peak node perf (fp8 vs
      bf16 normalization), ~3600x pod perf, ~36x pod size, ~39x bisection,
      ~400x pod HBM, ~30x perf/W.
    """
    v2, iw = TPU_V2, IRONWOOD
    return {
        "hbm_capacity_x": iw.hbm_gib / v2.hbm_gib,
        "hbm_bandwidth_x": iw.hbm_gbps / v2.hbm_gbps,
        "node_peak_x": iw.peak_tflops / v2.peak_tflops,
        "node_peak_bf16_x": iw.peak_bf16_tflops / v2.peak_bf16_tflops,
        "pod_size_x": iw.pod_size / v2.pod_size,
        "bisection_x": iw.pod_bisection_gbps / v2.pod_bisection_gbps,
        "pod_hbm_x": (iw.pod_size * iw.hbm_gib) / (v2.pod_size * v2.hbm_gib),
        "pod_peak_x": (iw.pod_size * iw.peak_tflops)
        / (v2.pod_size * v2.peak_tflops),
        "perf_per_watt_x": iw.rel_pod_tflops_per_watt
        / v2.rel_pod_tflops_per_watt,
        "cagr_pod_peak": (
            (iw.pod_size * iw.peak_tflops) / (v2.pod_size * v2.peak_tflops)
        ) ** (1.0 / (iw.year - v2.year)) - 1.0,
    }


@dataclasses.dataclass(frozen=True)
class RooflineTarget:
    """Per-chip constants used by the 3-term roofline (task-spec numbers)."""

    name: str = "tpu_v5e"
    peak_flops: float = 197e12  # bf16 FLOP/s per chip
    peak_flops_fp8: float = 394e12
    hbm_bw: float = 819e9  # bytes/s per chip
    ici_link_bw: float = 50e9  # bytes/s per link per direction
    ici_links: int = 4  # 2D torus
    hbm_capacity: float = 16 * 1024**3  # bytes
    vmem_capacity: float = 128 * 1024**2  # bytes


ROOFLINE_TARGET = RooflineTarget()


def roofline_target_for(spec: TPUSpec) -> RooflineTarget:
    """Per-chip ``RooflineTarget`` built from a Table-1 generation spec.

    Lets the three-term roofline (``core.roofline``) model *any*
    generation, not just the repo's v5e dry-run target — the fleet
    simulator's roofline-fed step times (``fleet.perf``) price every
    generation's step time from its own Table-1 column. ``peak_flops``
    stays bf16 (training normalization); FP8 peak rides along for parts
    that support it."""
    return RooflineTarget(
        name=spec.name,
        peak_flops=spec.peak_bf16_tflops * 1e12,
        peak_flops_fp8=(spec.peak_fp8_tflops or spec.peak_bf16_tflops)
        * 1e12,
        hbm_bw=spec.hbm_gbps * 1e9,
        ici_link_bw=spec.ici_link_gbps * 1e9,
        ici_links=spec.ici_links,
        hbm_capacity=spec.hbm_gib * 1024**3,
        vmem_capacity=spec.vmem_mib * 1024**2,
    )
