"""Performance-per-Watt (Figure 5) and Compute Carbon Intensity (Figure 6).

The paper (following [Vahdat24] and [Schneider25]) advocates two metrics:

  * performance per (TDP) Watt — Figure 5 gives the relative values
    1 / 1.8 / 4.9 / 5.2 / 29.3 for TPU v2..Ironwood (Table 1 bottom rows);
  * compute carbon intensity (CCI) — gCO2e per utilized ExaFLOP, split into
    operational + embodied. Figure 6 gives CCI for TPU v4, v5p, Ironwood.

Figure 6's bar values are reconstructed here from every number the paper
states in prose, and the reconstruction is over-constrained — tests check
all of the paper's stated relations simultaneously:
  - overall & operational CCI: v4/v5p = 1.1x, embodied v4/v5p = 1.3x;
  - Ironwood operational jump ~3.7x vs v5p, embodied ~3.8x;
  - TPU v5p total CCI = 265 g/EFLOP (the GPT-3 worked example);
  - operational share ~75% of total for all three (market-based);
  - footnote 7: location-based operational CCI = 793 / 712 / 195, under
    which Ironwood's embodied share drops from ~23% to ~8%.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.core import hwspec


@dataclasses.dataclass(frozen=True)
class CCIRecord:
    """CCI in gCO2e per ExaFLOP (10**18 utilized FLOPs)."""

    tpu: str
    operational_market: float  # credits carbon-free energy purchases
    embodied: float
    operational_location: float  # excludes CFE purchases (footnote 7)

    @property
    def total_market(self) -> float:
        return self.operational_market + self.embodied

    @property
    def total_location(self) -> float:
        return self.operational_location + self.embodied

    @property
    def embodied_share_market(self) -> float:
        return self.embodied / self.total_market

    @property
    def embodied_share_location(self) -> float:
        return self.embodied / self.total_location


# Figure 6 reconstruction (see module docstring). Units: gCO2e / EFLOP.
CCI_TPU_V4 = CCIRecord("tpu_v4", operational_market=219.0, embodied=86.0,
                       operational_location=793.0)
CCI_TPU_V5P = CCIRecord("tpu_v5p", operational_market=199.0, embodied=66.0,
                        operational_location=712.0)
CCI_IRONWOOD = CCIRecord("ironwood", operational_market=54.0, embodied=17.4,
                         operational_location=195.0)

CCI_TABLE: Tuple[CCIRecord, ...] = (CCI_TPU_V4, CCI_TPU_V5P, CCI_IRONWOOD)
CCI_BY_NAME: Dict[str, CCIRecord] = {r.tpu: r for r in CCI_TABLE}


def perf_per_watt_relative() -> Dict[str, float]:
    """Figure 5: relative peak performance per TDP Watt, TPU v2 = 1.

    Recomputed from Table 1's Relative Pod TFLOPS / Relative Pod TDP so the
    two rows' consistency is itself checked (they must reproduce the
    Relative Pod TFLOPS/W row)."""
    out = {}
    for spec in hwspec.GENERATIONS:
        out[spec.name] = spec.rel_pod_tflops / spec.rel_pod_tdp
    return out


def emissions_grams(flops: float, cci: CCIRecord, *,
                    market: bool = True) -> float:
    """Ballpark emissions for a task of ``flops`` utilized FLOPs (paper's
    GPT-3 example: 3.14e23 FLOPs * 265 g/EFLOP = ~8.3e7 gCO2e ~= 83 tCO2e).

    (The paper's prose converts 83e6 g to "83 million metric tons"; that is
    a unit slip — 83e6 g is 83 metric tons. We reproduce the 8.3e7 g figure.)
    """
    per_eflop = cci.total_market if market else cci.total_location
    return flops / 1e18 * per_eflop


def operational_cci_from_perf_per_watt(
    electricity_gco2e_per_kwh: float, flops_per_watt: float
) -> float:
    """Paper identity: operational CCI = emissions factor / (perf/Watt).

    flops_per_watt is measured FLOP/s per Watt; returns gCO2e/EFLOP.
    1 kWh = 3.6e6 J, so FLOPs per kWh = flops_per_watt * 3.6e6.
    """
    flops_per_kwh = flops_per_watt * 3.6e6
    return electricity_gco2e_per_kwh / flops_per_kwh * 1e18


@dataclasses.dataclass
class CarbonLedger:
    """Attachable to a training run: integrates utilized FLOPs into gCO2e.

    Uses the target generation's CCI; ``utilization`` discounts peak to
    realized FLOP/s (CCI is per *utilized* FLOP, so emissions depend only on
    total useful FLOPs — utilization affects wall time, not grams)."""

    cci: CCIRecord
    flops_accum: float = 0.0

    def record_step(self, useful_flops: float) -> None:
        if useful_flops < 0:
            raise ValueError("negative flops")
        self.flops_accum += useful_flops

    @property
    def grams_co2e(self) -> float:
        return emissions_grams(self.flops_accum, self.cci)

    def summary(self) -> Dict[str, float]:
        return {
            "flops": self.flops_accum,
            "gco2e_market": self.grams_co2e,
            "gco2e_location": emissions_grams(
                self.flops_accum, self.cci, market=False
            ),
        }
