"""Power and carbon integration for simulated fleet jobs.

Bridges three of the repo's paper models: the absolute-TDP anchor in
``core.hwspec`` (the paper's Relative Pod TDP row anchored at the public
TPU v2 280 W chip), the goodput ledger's wall-time partition, and the
CCI records of ``core.cci``. A job's energy integrates TDP over its
ledger: chips draw full TDP while stepping or reworking and an idle
fraction while detecting/restoring/queued. Effective FLOPs count only
*productive* step time (goodput discounts rework), so the J-per-
effective-FLOP and gCO2e-per-effective-FLOP outputs respond to both the
hardware generation (perf/W) and the fleet's resilience behavior — the
paper's sustainability and goodput stories in one number.

Elastic caveat: ``job_summary(ledger, chips)`` integrates at a fixed
chip count. A job that spent part of its life re-scaled to a smaller
slice held fewer chips during those segments, so passing its full
``spec.chips`` bounds energy from above (conservative for the
sustainability ratios, which are cross-generation and cancel the
fleet behavior).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core import hwspec
from repro_torch.core.cci import CCI_BY_NAME, CCIRecord
from repro_torch.core.goodput import GoodputLedger

# Time the chips are actually clocking the training step.
_BUSY_KINDS = ("steps", "rework")


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """Per-generation energy/carbon integrator.

    ``mfu`` discounts peak to realized FLOP/s during productive step
    time; ``idle_power_fraction`` is the draw while the slice is held but
    not stepping (detect, restore, queued); ``grid_gco2e_per_kwh`` is the
    operational emissions factor (market-based CFE-credited grids sit far
    below location-based ones — the paper's footnote 7 contrast).
    """

    spec: hwspec.TPUSpec
    mfu: float = 0.4
    idle_power_fraction: float = 0.15
    grid_gco2e_per_kwh: float = 100.0

    @property
    def chip_tdp_w(self) -> float:
        w = hwspec.chip_tdp_watts(self.spec)
        if w is None:
            raise ValueError(
                f"{self.spec.name}: no TDP anchor (paper gives no "
                "relative TDP row)")
        return w

    @property
    def cci(self) -> Optional[CCIRecord]:
        return CCI_BY_NAME.get(self.spec.name)

    def job_energy_joules(self, ledger: GoodputLedger, chips: int) -> float:
        t = ledger.totals()
        busy_s = sum(t.get(k, 0.0) for k in _BUSY_KINDS)
        held_s = ledger.total_seconds - busy_s
        w = self.chip_tdp_w * chips
        return busy_s * w + held_s * w * self.idle_power_fraction

    def job_effective_flops(self, ledger: GoodputLedger,
                            chips: int) -> float:
        per_chip = self.spec.peak_tflops * 1e12 * self.mfu
        return ledger.productive_seconds * chips * per_chip

    def job_summary(self, ledger: GoodputLedger,
                    chips: int) -> Dict[str, float]:
        energy_j = self.job_energy_joules(ledger, chips)
        eff = self.job_effective_flops(ledger, chips)
        eflops = eff / 1e18
        kwh = energy_j / 3.6e6
        out = {
            "energy_j": energy_j,
            "energy_kwh": kwh,
            "effective_eflops": eflops,
            "joules_per_eflop": energy_j / eflops if eflops else float("inf"),
            "gco2e_operational": kwh * self.grid_gco2e_per_kwh,
        }
        rec = self.cci
        if rec is not None:
            out["gco2e_embodied"] = rec.embodied * eflops
            out["gco2e_total"] = out["gco2e_operational"] + \
                out["gco2e_embodied"]
            out["gco2e_per_eflop"] = (out["gco2e_total"] / eflops
                                      if eflops else float("inf"))
        return out

    def serve_summary(self, ledger: GoodputLedger, chips: int, *,
                      good_tokens: float,
                      total_tokens: float) -> Dict[str, float]:
        """Joules-per-token for a serve job, through the *same* ledger
        integration training uses: SLO-good busy time is ``steps``,
        violating busy time is ``rework`` (full TDP either way — the
        chips clocked those tokens), idle/spin-up/recovery draw the idle
        fraction. ``chips`` is per-replica chips times the replica count
        the ledger describes (an upper bound under autoscaling, like the
        elastic caveat above)."""
        energy_j = self.job_energy_joules(ledger, chips)
        out = {
            "energy_j": energy_j,
            "energy_kwh": energy_j / 3.6e6,
            "good_tokens": good_tokens,
            "total_tokens": total_tokens,
            "joules_per_token": (energy_j / total_tokens
                                 if total_tokens else float("inf")),
            "joules_per_good_token": (energy_j / good_tokens
                                      if good_tokens else float("inf")),
        }
        return out


# ---------------------------------------------------------------------------
# Cross-generation sustainability trend (Figure 5 re-derived in joules).
# ---------------------------------------------------------------------------


def generation_efficiency_table(mfu: float = 1.0) -> Dict[str, float]:
    """Joules per peak ExaFLOP for each generation, from the anchored TDP
    and Table 1 peak (FP8 where supported — the paper's normalization).
    At mfu=1 this is exactly the inverse of the paper's perf/Watt row up
    to the anchoring constant."""
    out = {}
    for spec in hwspec.GENERATIONS:
        pod_w = hwspec.pod_tdp_watts(spec)
        assert pod_w is not None
        pod_flops = spec.pod_size * spec.peak_tflops * 1e12 * mfu
        out[spec.name] = pod_w / (pod_flops / 1e18)
    return out


def sustainability_ratios() -> Dict[str, float]:
    """Ironwood-vs-v2 improvement, both energy- and carbon-normalized.

    At fixed grid intensity, gCO2e/FLOP is proportional to J/FLOP, so
    both ratios reduce to the paper's ~29x perf/Watt claim; we recompute
    from the anchored absolute numbers so the derivation chain
    (TDP anchor -> joules -> CO2e) is itself exercised."""
    table = generation_efficiency_table()
    j_ratio = table["tpu_v2"] / table["ironwood"]
    rel = hwspec.IRONWOOD.rel_pod_tflops_per_watt / \
        hwspec.TPU_V2.rel_pod_tflops_per_watt
    return {
        "joules_per_flop_improvement_x": j_ratio,
        "co2e_per_flop_improvement_x": j_ratio,  # fixed-grid identity
        "paper_perf_per_watt_x": rel,
    }
