"""OCS-based cube scheduling, spare substitution, and availability modeling.

Paper (§Improved Resilience Over Time): since TPU v4, pods are built from
4x4x4 electrically-cabled cubes whose face links terminate on optical circuit
switches. Consequences the paper highlights, all modeled here:

  * slices need not be *contiguous*: any idle cubes can be stitched into a
    torus (vs TPU v2/v3 which needed contiguous chips);
  * failed cubes are mapped out and spare cubes substituted, restoring the
    3D torus ("Ironwood can run four of the popular 2K slice jobs ... even if
    some nodes are down, as 16 spare cubes remain available as substitutes");
  * incremental deployment: each cube enters production as soon as it is
    installed, instead of waiting for the full pod;
  * the primary availability hazard is the CPU host (4 TPUs/host).

The scheduler here is used three ways: (1) benchmarks reproducing the paper's
scheduling/availability claims, (2) the resilience subsystem's elastic
driver, which asks the scheduler for a replacement allocation after injected
failures, and (3) property tests of its invariants.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.topology import CUBE, CubeGeometry, cube_grid

CubeId = int


@dataclasses.dataclass
class SliceAllocation:
    """A scheduled slice: a set of cubes stitched into a torus by the OCS."""

    job: str
    chips: int
    cubes: Tuple[CubeId, ...]
    cube_dims: Tuple[int, int, int]  # arrangement, in cubes

    @property
    def torus_dims(self) -> Tuple[int, int, int]:
        s = CUBE.side
        a, b, c = self.cube_dims
        return (a * s, b * s, c * s)


class OCSPodScheduler:
    """Cube-granularity slice scheduler for one pod.

    ``contiguous=False`` (OCS, TPU v4+): any idle healthy cubes satisfy a
    request. ``contiguous=True`` (pre-OCS, TPU v2/v3 semantics): a request is
    satisfiable only by a *rectangular block* of idle healthy cubes inside
    the pod's physical cube grid — the paper's "locate 128 contiguous idle
    chips" difficulty, modeled at cube granularity.
    """

    def __init__(self, total_cubes: int, *, contiguous: bool = False,
                 cube: CubeGeometry = CUBE,
                 grid: Optional[Tuple[int, int, int]] = None):
        if total_cubes <= 0:
            raise ValueError("total_cubes must be positive")
        self.cube = cube
        self.total_cubes = total_cubes
        self.contiguous = contiguous
        self.grid = grid or cube_grid(total_cubes * cube.chips)
        if math.prod(self.grid) < total_cubes:
            raise ValueError(f"grid {self.grid} smaller than {total_cubes}")
        self._failed: Set[CubeId] = set()
        self._installed: Set[CubeId] = set(range(total_cubes))
        self._alloc: Dict[str, SliceAllocation] = {}
        self._cube_owner: Dict[CubeId, str] = {}
        self.reconfig_count = 0  # successful OCS substitutions

    # ------------------------------------------------------------------ api

    @property
    def allocations(self) -> Dict[str, SliceAllocation]:
        return dict(self._alloc)

    @property
    def failed_cubes(self) -> FrozenSet[CubeId]:
        return frozenset(self._failed)

    def idle_cubes(self) -> List[CubeId]:
        return [c for c in sorted(self._installed)
                if c not in self._failed and c not in self._cube_owner]

    def spare_cubes(self) -> int:
        return len(self.idle_cubes())

    # -- incremental deployment (paper: cubes usable as installed) ----------

    def set_installed(self, cubes: Sequence[CubeId]) -> None:
        bad = [c for c in cubes if not (0 <= c < self.total_cubes)]
        if bad:
            raise ValueError(f"cube ids out of range: {bad}")
        self._installed = set(cubes)

    # -- scheduling ----------------------------------------------------------

    def allocate(self, job: str, chips: int) -> Optional[SliceAllocation]:
        """Try to schedule ``chips`` (rounded up to whole cubes)."""
        if job in self._alloc:
            raise ValueError(f"job {job!r} already scheduled")
        need = self.cube.cubes_for(chips)
        idle = self.idle_cubes()
        if len(idle) < need:
            return None
        if self.contiguous:
            block = self._find_contiguous_block(need)
            if block is None:
                return None
            chosen, dims = block
        else:
            chosen = tuple(idle[:need])
            dims = cube_grid(need * self.cube.chips)
        alloc = SliceAllocation(job=job, chips=chips, cubes=tuple(chosen),
                                cube_dims=dims)
        self._alloc[job] = alloc
        for c in chosen:
            self._cube_owner[c] = job
        return alloc

    def release(self, job: str) -> None:
        alloc = self._alloc.pop(job)
        for c in alloc.cubes:
            self._cube_owner.pop(c, None)

    # -- elastic re-scale (paper: "rescheduled at smaller scale") ------------

    def max_slice_cubes(self, limit: int) -> int:
        """Largest schedulable slice size in cubes, capped at ``limit``.

        OCS pods can stitch any idle healthy cubes into a torus, so the
        answer is simply how many are idle; pre-OCS (contiguous) pods are
        bounded by the largest free rectangular block. The elastic fleet
        arm asks this before shrinking a starved job."""
        idle = len(self.idle_cubes())
        if not self.contiguous:
            return min(limit, idle)
        for n in range(min(limit, idle), 0, -1):
            if self._find_contiguous_block(n) is not None:
                return n
        return 0

    def grow(self, job: str, extra_cubes: int) -> Optional[SliceAllocation]:
        """Stitch ``extra_cubes`` idle cubes into a live allocation (an OCS
        reconfiguration — the grow-back half of elastic re-scale). Returns
        the grown allocation, or None if not enough idle cubes. Pre-OCS
        pods cannot grow in place: the block would have to stay
        rectangular, so a full reschedule is required instead."""
        alloc = self._alloc.get(job)
        if alloc is None:
            raise KeyError(job)
        if extra_cubes <= 0:
            return alloc
        if self.contiguous:
            return None
        idle = self.idle_cubes()
        if len(idle) < extra_cubes:
            return None
        added = tuple(idle[:extra_cubes])
        new_cubes = alloc.cubes + added
        chips = len(new_cubes) * self.cube.chips
        for c in added:
            self._cube_owner[c] = job
        patched = dataclasses.replace(
            alloc, cubes=new_cubes, chips=chips,
            cube_dims=cube_grid(chips, self.cube))
        self._alloc[job] = patched
        self.reconfig_count += 1
        return patched

    # -- failures & repair ----------------------------------------------------

    def fail_cube(self, cube_id: CubeId) -> Optional[str]:
        """Mark a cube failed. Returns the impacted job (if any)."""
        self._failed.add(cube_id)
        return self._cube_owner.get(cube_id)

    def repair_cube(self, cube_id: CubeId) -> None:
        self._failed.discard(cube_id)

    def fail_host(self, host_id: int, tpus_per_host: int = 4
                  ) -> Tuple[CubeId, Optional[str]]:
        """A CPU host dies (the paper's primary availability hazard).

        A host serves ``tpus_per_host`` chips, so a 64-chip cube spans
        several hosts; losing any host breaks the cube's torus, and the
        map-out granularity of the OCS is the whole cube. Returns
        (cube id, impacted job)."""
        hosts_per_cube = self.cube.chips // tpus_per_host
        cube_id = host_id // hosts_per_cube
        if not 0 <= cube_id < self.total_cubes:
            raise ValueError(f"host {host_id} outside pod")
        return cube_id, self.fail_cube(cube_id)

    def substitute(self, job: str) -> Optional[SliceAllocation]:
        """Map out failed cubes of a job, substituting idle spares (OCS
        reconfiguration). Returns the patched allocation, or None if not
        enough spares — caller must then reschedule at smaller scale
        (elastic) or wait for repair. Pre-OCS (contiguous) pods cannot
        substitute: any failure forces a full reschedule."""
        alloc = self._alloc.get(job)
        if alloc is None:
            raise KeyError(job)
        broken = [c for c in alloc.cubes if c in self._failed]
        if not broken:
            return alloc
        if self.contiguous:
            return None
        spares = self.idle_cubes()
        if len(spares) < len(broken):
            return None
        replacement = dict(zip(broken, spares))
        new_cubes = tuple(replacement.get(c, c) for c in alloc.cubes)
        for c in broken:
            self._cube_owner.pop(c, None)
        for c in replacement.values():
            self._cube_owner[c] = job
        patched = dataclasses.replace(alloc, cubes=new_cubes)
        self._alloc[job] = patched
        self.reconfig_count += 1
        return patched

    # -- invariants (property tests / fleet simulator) -----------------------

    def check_invariants(self) -> None:
        """Raise AssertionError if the allocation state is inconsistent.

        Pinned invariants: no two live slices share a cube; the ownership
        index agrees with the allocations; allocations only use installed
        cubes; every owned cube belongs to a live allocation."""
        seen: Dict[CubeId, str] = {}
        for job, alloc in self._alloc.items():
            for c in alloc.cubes:
                assert c not in seen, \
                    f"cube {c} shared by {seen[c]!r} and {job!r}"
                seen[c] = job
                assert c in self._installed, f"cube {c} not installed"
                assert self._cube_owner.get(c) == job, \
                    f"owner index disagrees for cube {c}"
        assert set(self._cube_owner) == set(seen), \
            "ownership index has stale entries"

    # -- contiguous-mode block search -----------------------------------------

    def _find_contiguous_block(
        self, need: int
    ) -> Optional[Tuple[Tuple[CubeId, ...], Tuple[int, int, int]]]:
        gx, gy, gz = self.grid

        def cube_id(x: int, y: int, z: int) -> CubeId:
            return (x * gy + y) * gz + z

        free = {c for c in self.idle_cubes()}
        # enumerate factorizations of `need` into block dims, prefer balanced
        dims_opts = []
        for a in range(1, need + 1):
            if need % a:
                continue
            for b in range(1, need // a + 1):
                if (need // a) % b:
                    continue
                c = need // a // b
                dims_opts.append((a, b, c))
        dims_opts.sort(key=lambda d: max(d) / min(d))
        for (dx, dy, dz) in dims_opts:
            if dx > gx or dy > gy or dz > gz:
                continue
            for x0 in range(gx - dx + 1):
                for y0 in range(gy - dy + 1):
                    for z0 in range(gz - dz + 1):
                        ids = [cube_id(x0 + i, y0 + j, z0 + k)
                               for i in range(dx)
                               for j in range(dy)
                               for k in range(dz)]
                        if all(i in free and i < self.total_cubes
                               for i in ids):
                            return tuple(sorted(ids)), (dx, dy, dz)
        return None


# ---------------------------------------------------------------------------
# Availability / goodput models (paper §Resilience).
# ---------------------------------------------------------------------------


def slice_availability(host_availability: float, chips: int,
                       tpus_per_host: int = 4) -> float:
    """P(all hosts of a synchronous slice are up) = a^(hosts).

    Paper: "Without OCSes, host availability must be >99.9% to achieve high
    slice goodput" — an Ironwood pod has 2304 hosts.
    """
    hosts = -(-chips // tpus_per_host)
    return host_availability**hosts


def schedulable_jobs(total_cubes: int, failed_cubes: int, job_chips: int,
                     cube: CubeGeometry = CUBE) -> int:
    """How many jobs of ``job_chips`` fit with OCS (no contiguity needed)."""
    healthy = total_cubes - failed_cubes
    per_job = cube.cubes_for(job_chips)
    return healthy // per_job


def monte_carlo_contiguous_vs_ocs(
    total_cubes: int,
    job_cubes: int,
    busy_fraction: float,
    trials: int,
    seed: int = 0,
    grid: Optional[Tuple[int, int, int]] = None,
) -> Dict[str, float]:
    """P(schedule success) for a job of ``job_cubes`` when a random
    ``busy_fraction`` of cubes is already occupied — OCS vs contiguous.

    Reproduces the paper's point that "the difficulty of scheduling increases
    sharply with slice size" without OCS.
    """
    rng = np.random.default_rng(seed)
    ok_ocs = ok_contig = 0
    for _ in range(trials):
        busy = rng.random(total_cubes) < busy_fraction
        idle = int((~busy).sum())
        if idle >= job_cubes:
            ok_ocs += 1
        sched = OCSPodScheduler(total_cubes, contiguous=True, grid=grid)
        # mark busy cubes as failed (equivalent: unavailable)
        for c in np.flatnonzero(busy):
            sched.fail_cube(int(c))
        if sched.allocate("probe", job_cubes * CUBE.chips) is not None:
            ok_contig += 1
    return {
        "p_success_ocs": ok_ocs / trials,
        "p_success_contiguous": ok_contig / trials,
        "trials": float(trials),
    }
