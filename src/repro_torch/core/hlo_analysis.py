"""Cost records of a compiled program, as ``repro.core.hlo_analysis``
defines them: one collective (``CollectiveRecord``) and the trip-count-
aware cost summary of one partition program (``HloCostReport``).

Only these two records are here, because ``core.roofline`` prices a step
from them and ``core.roofline.synthetic_train_cost`` builds them without
any compiled artifact. The reference's HLO text parser, which fills them
from a compiled dry run, is not part of the port yet: it comes with the
port's dry-run launcher.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass
class CollectiveRecord:
    opcode: str
    comp: str
    result_bytes: float
    operand_bytes: float
    group_size: int
    groups: Tuple[Tuple[int, ...], ...]
    multiplier: float
    axes: Tuple[str, ...]  # mesh axes this collective spans ("?" if unknown)

    @property
    def total_result_bytes(self) -> float:
        return self.result_bytes * self.multiplier

    @property
    def total_operand_bytes(self) -> float:
        return self.operand_bytes * self.multiplier


@dataclasses.dataclass
class HloCostReport:
    """Trip-count-aware cost summary of one compiled partition program."""

    flops: float  # per-device FLOPs (dots + convs), trip-count scaled
    hbm_bytes: float  # per-device approximate HBM traffic
    collectives: List[CollectiveRecord]
    peak_memory_bytes: float  # from memory_analysis (argument+output+temp)
    dot_flops_by_comp: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def collective_bytes(self) -> float:
        return sum(c.total_operand_bytes for c in self.collectives)

    def collective_bytes_by_axes(self) -> Dict[Tuple[str, ...], float]:
        out: Dict[Tuple[str, ...], float] = {}
        for c in self.collectives:
            out[c.axes] = out.get(c.axes, 0.0) + c.total_operand_bytes
        return out
