"""Three-term roofline model from compiled dry-run artifacts.

Terms, all in seconds per step (per-device program; since SPMD compiles one
partition's program, per-device FLOPs/bytes already embody the /chips of the
task formula):

  compute    = dot_FLOPs_per_device / peak_FLOP/s
  memory     = HBM_bytes_per_device / HBM_bw
  collective = sum over collectives of a ring-model time on the mesh axis
               the collective spans (parsed from replica_groups)

Hardware constants: TPU v5e target (197 bf16 TFLOP/s, 819 GB/s HBM,
~50 GB/s/link ICI per direction). Torus rings are bidirectional, so ring
collectives see 2x link bandwidth. The cross-pod "pod" axis is modeled at
DCN-class bandwidth (configurable; default 1/4 ICI) — the paper's multi-pod
Gemini training rides data-parallel all-reduce across data centers.

The report also carries MODEL_FLOPS (6*N*D train / 2*N*D inference, dense;
active params for MoE) so we can report the useful-compute ratio
MODEL_FLOPS / HLO_FLOPs, which catches remat and redundancy waste.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.hlo_analysis import CollectiveRecord, HloCostReport
from repro_torch.core.hwspec import ROOFLINE_TARGET, RooflineTarget


@dataclasses.dataclass(frozen=True)
class AxisLink:
    size: int
    link_bw: float  # bytes/s per direction


def mesh_axis_links(mesh_shape: Sequence[int], axis_names: Sequence[str],
                    target: RooflineTarget = ROOFLINE_TARGET,
                    pod_bw_fraction: float = 0.25) -> Dict[str, AxisLink]:
    links = {}
    for name, size in zip(axis_names, mesh_shape):
        bw = target.ici_link_bw
        if name == "pod":
            bw *= pod_bw_fraction  # cross-datacenter DCN-class
        links[name] = AxisLink(size=size, link_bw=bw)
    return links


def collective_time(rec: CollectiveRecord,
                    links: Dict[str, AxisLink]) -> float:
    """Ring-model time for one collective (single execution)."""
    axes = [a for a in rec.axes if a in links]
    if not axes:
        # unknown grouping: conservative — slowest link, full group size
        link = min(links.values(), key=lambda l: l.link_bw)
        n = rec.group_size
    else:
        link = min((links[a] for a in axes), key=lambda l: l.link_bw)
        n = rec.group_size
    if n <= 1:
        return 0.0
    bw = 2.0 * link.link_bw  # bidirectional ring
    op = rec.opcode
    if op in ("all-reduce",):
        return 2.0 * (n - 1) / n * rec.result_bytes / bw
    if op in ("all-gather",):
        return (n - 1) / n * rec.result_bytes / bw
    if op in ("reduce-scatter",):
        return (n - 1) / n * rec.operand_bytes / bw
    if op in ("all-to-all", "ragged-all-to-all"):
        avg_hops = n / 4.0
        return (n - 1) / n * avg_hops * rec.result_bytes / bw
    if op in ("collective-permute",):
        return rec.result_bytes / link.link_bw
    return rec.result_bytes / bw


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh_desc: str
    chips: int
    # raw inputs
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    peak_memory_bytes: float
    model_flops_global: float
    # terms (seconds/step)
    t_compute: float
    t_memory: float
    t_collective: float
    collective_by_axes: Dict[Tuple[str, ...], float]
    hbm_capacity: float
    peak_flops: float = 197e12
    notes: str = ""

    @property
    def bound(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def t_bound(self) -> float:
        """Step-time lower bound assuming perfect overlap of the 3 engines
        (MXU, HBM, ICI) — the roofline."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def t_serial(self) -> float:
        """No-overlap upper bound."""
        return self.t_compute + self.t_memory + self.t_collective

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs (global). >1 would mean undercounted HLO;
        <1 means remat/redundant compute."""
        hlo_global = self.flops_per_device * self.chips
        return self.model_flops_global / hlo_global if hlo_global else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the pod's peak FLOP/s devoted to *useful* model FLOPs
        at the roofline step time — the score we hillclimb.

        = (MODEL_FLOPS / chips / peak) / t_bound
        """
        if self.t_bound <= 0:
            return 0.0
        t_useful = self.model_flops_global / self.chips / self.peak_flops
        return t_useful / self.t_bound

    @property
    def fits_hbm(self) -> bool:
        return self.peak_memory_bytes <= self.hbm_capacity

    def row(self) -> Dict[str, object]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh_desc,
            "chips": self.chips,
            "t_compute_s": round(self.t_compute, 6),
            "t_memory_s": round(self.t_memory, 6),
            "t_collective_s": round(self.t_collective, 6),
            "bound": self.bound,
            "t_bound_s": round(self.t_bound, 6),
            "model_flops": f"{self.model_flops_global:.3e}",
            "useful_ratio": round(self.useful_flops_ratio, 3),
            "roofline_frac": round(self.roofline_fraction, 4),
            "mem_gib_per_chip": round(self.peak_memory_bytes / 2**30, 2),
            "fits_hbm": self.fits_hbm,
            "notes": self.notes,
        }


def build_report(
    *,
    arch: str,
    shape: str,
    mesh_shape: Sequence[int],
    axis_names: Sequence[str],
    cost: HloCostReport,
    model_flops_global: float,
    target: RooflineTarget = ROOFLINE_TARGET,
    pod_bw_fraction: float = 0.25,
    notes: str = "",
    peak_flops: Optional[float] = None,
) -> RooflineReport:
    chips = math.prod(mesh_shape)
    peak = peak_flops or target.peak_flops
    links = mesh_axis_links(mesh_shape, axis_names, target, pod_bw_fraction)
    t_coll = sum(collective_time(c, links) * c.multiplier
                 for c in cost.collectives)
    by_axes: Dict[Tuple[str, ...], float] = {}
    for c in cost.collectives:
        by_axes[c.axes] = by_axes.get(c.axes, 0.0) + c.total_operand_bytes
    return RooflineReport(
        arch=arch, shape=shape,
        mesh_desc="x".join(str(s) for s in mesh_shape),
        chips=chips,
        flops_per_device=cost.flops,
        hbm_bytes_per_device=cost.hbm_bytes,
        collective_bytes_per_device=cost.collective_bytes(),
        peak_memory_bytes=cost.peak_memory_bytes,
        model_flops_global=model_flops_global,
        t_compute=cost.flops / peak,
        t_memory=cost.hbm_bytes / target.hbm_bw,
        t_collective=t_coll,
        collective_by_axes=by_axes,
        hbm_capacity=target.hbm_capacity,
        peak_flops=peak,
        notes=notes,
    )


def model_flops(n_params_active: float, tokens: float,
                training: bool) -> float:
    """The paper-standard napkin: 6*N*D for a training step (fwd+bwd),
    2*N*D forward-only (prefill/decode)."""
    return (6.0 if training else 2.0) * n_params_active * tokens


def synthetic_train_cost(
    *,
    n_params_active: float,
    tokens_global: float,
    chips: int,
    param_bytes: float = 2.0,
    grad_bytes: float = 4.0,
    traversals: float = 3.0,
    opt_state_bytes: float = 8.0,
) -> HloCostReport:
    """First-order ``HloCostReport`` for an FSDP data-parallel training
    step, for callers with no compiled dry-run artifact (the fleet's
    roofline-fed step times, ``fleet.perf``).

    Per device, per step: FLOPs are the 6*N*T napkin split across chips;
    HBM traffic streams the *gathered* params once per traversal (fwd,
    remat-fwd, bwd — FSDP re-gathers shards each time, so this term does
    not shrink with scale) plus gradient and optimizer-state read/write
    on the shard; the collective is the ring grad all-reduce over the
    data axis. Deliberately omits activation traffic (model-shape
    dependent) — see ``core.napkin`` for the shape-aware model."""
    if chips <= 0:
        raise ValueError("chips must be positive")
    flops = 6.0 * n_params_active * tokens_global / chips
    hbm = traversals * n_params_active * param_bytes \
        + n_params_active / chips * (2.0 * grad_bytes
                                     + 2.0 * opt_state_bytes)
    collectives: List[CollectiveRecord] = []
    if chips > 1:
        grad_all_reduce_bytes = n_params_active * grad_bytes
        collectives.append(CollectiveRecord(
            opcode="all-reduce", comp="synthetic",
            result_bytes=grad_all_reduce_bytes,
            operand_bytes=grad_all_reduce_bytes,
            group_size=chips, groups=(), multiplier=1.0,
            axes=("data",)))
    peak_mem = n_params_active / chips * (param_bytes + opt_state_bytes
                                          + grad_bytes)
    return HloCostReport(flops=flops, hbm_bytes=hbm,
                         collectives=collectives,
                         peak_memory_bytes=peak_mem)
