"""Torus / cube topology math for TPU pods.

The paper's interconnect story: ICI links form a 2D torus (TPU v2/v3) or a
3D torus (TPU v4+), physically built (since v4) from electrically-cabled
4x4x4 "cubes" whose 96 face links terminate on optical circuit switches
(OCSes). Opposing faces of the torus connect through the same OCS, so the
scheduler can stitch any set of cubes into a torus and map failed cubes out.

This module provides the pure geometry: torus shapes, neighbor maps,
bisection bandwidth, cube decomposition, and collective cost models
(ring/bidirectional-torus all-reduce and all-to-all hop counts) used by the
roofline's collective term and the OCS scheduler.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Iterable, List, Sequence, Tuple

Coord = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Torus:
    """An N-dimensional torus of nodes with per-direction link bandwidth."""

    dims: Tuple[int, ...]
    link_gbps: float  # per direction, paper footnote 4

    @property
    def num_nodes(self) -> int:
        return math.prod(self.dims)

    @property
    def links_per_node(self) -> int:
        """External ICI links per node: 2 per torus dimension, except
        dimensions of size 1 (no links) and size 2 (single wraparound)."""
        n = 0
        for d in self.dims:
            if d >= 3:
                n += 2
            elif d == 2:
                n += 1
        return n

    def bisection_gbps(self) -> float:
        """Bisection bandwidth across the longest dimension (paper Table 1):
        2 * (num_nodes / longest) links, each link_gbps per direction."""
        longest = max(self.dims)
        if longest < 2:
            return 0.0
        cross = self.num_nodes // longest
        wrap = 2 if longest >= 3 else 1
        return wrap * cross * self.link_gbps

    def neighbors(self, coord: Coord) -> List[Coord]:
        out = []
        for axis, size in enumerate(self.dims):
            if size < 2:
                continue
            for step in (-1, +1):
                nxt = list(coord)
                nxt[axis] = (coord[axis] + step) % size
                if tuple(nxt) != coord:
                    out.append(tuple(nxt))
        # dedupe (size-2 dims produce the same neighbor twice)
        seen, uniq = set(), []
        for c in out:
            if c not in seen:
                seen.add(c)
                uniq.append(c)
        return uniq

    def all_coords(self) -> Iterable[Coord]:
        return itertools.product(*(range(d) for d in self.dims))

    # ----- collective cost models (used by the roofline collective term) ---

    def ring_allreduce_time(self, bytes_per_node: float, axis: int) -> float:
        """Bandwidth-optimal ring all-reduce along one torus axis.

        Moves 2*(n-1)/n * bytes per node through each link; a torus ring is
        bidirectional so effective bandwidth is 2*link (one ring each way).
        Returns seconds.
        """
        n = self.dims[axis]
        if n <= 1:
            return 0.0
        bw = 2.0 * self.link_gbps * 1e9
        return (2.0 * (n - 1) / n) * bytes_per_node / bw

    def allgather_time(self, bytes_per_node_out: float, axis: int) -> float:
        """Ring all-gather of a result totalling bytes_per_node_out per node:
        each node receives (n-1)/n of the full output over 2 directions."""
        n = self.dims[axis]
        if n <= 1:
            return 0.0
        bw = 2.0 * self.link_gbps * 1e9
        return ((n - 1) / n) * bytes_per_node_out / bw

    def alltoall_time(self, bytes_per_node: float, axis: int) -> float:
        """All-to-all along one axis: each node sends (n-1)/n of its data;
        average hop distance on a bidirectional ring is ~n/4, giving
        effective per-node throughput 4*link/n ... we use the standard
        torus all-to-all bound: time = bytes * (n/4) / (n * link * 2)."""
        n = self.dims[axis]
        if n <= 1:
            return 0.0
        bw = 2.0 * self.link_gbps * 1e9
        avg_hops = n / 4.0
        return bytes_per_node * ((n - 1) / n) * avg_hops / bw


@dataclasses.dataclass(frozen=True)
class CubeGeometry:
    """TPU v4+ physical building block: a 4x4x4 electrically-cabled cube.

    Each face of the cube exposes 4x4 = 16 ICI links; 6 faces -> 96 optical
    links per cube. Opposing faces must land on the same OCS for torus
    wraparound, so each cube attaches to 6*16/2 = 48 OCSes (paper, Fig. 4).
    """

    side: int = 4

    @property
    def chips(self) -> int:
        return self.side**3

    @property
    def links_per_face(self) -> int:
        return self.side * self.side

    @property
    def optical_links(self) -> int:
        return 6 * self.links_per_face

    @property
    def ocses_per_cube(self) -> int:
        return 6 * self.links_per_face // 2

    def cubes_for(self, num_chips: int) -> int:
        return -(-num_chips // self.chips)  # ceil div


CUBE = CubeGeometry()


def cube_grid(slice_chips: int, cube: CubeGeometry = CUBE) -> Tuple[int, int, int]:
    """Shape (in cubes) of a torus slice of ``slice_chips`` chips.

    Slices are multiples of 64 chips (one cube). We pick the most balanced
    3D arrangement of cubes, matching how slices are carved in practice
    (e.g. 2048 chips = 32 cubes -> 4x4x2 cubes -> 16x16x8 chip torus).
    """
    n = cube.cubes_for(slice_chips)
    best: Tuple[int, int, int] = (n, 1, 1)
    best_score = float("inf")
    for a in range(1, n + 1):
        if n % a:
            continue
        for b in range(1, n // a + 1):
            if (n // a) % b:
                continue
            c = n // a // b
            dims = tuple(sorted((a, b, c)))
            score = max(dims) / min(dims)
            if score < best_score:
                best_score = score
                best = dims  # type: ignore[assignment]
    return best  # cubes per axis


def slice_torus(slice_chips: int, link_gbps: float,
                cube: CubeGeometry = CUBE) -> Torus:
    """Chip-level torus for a slice assembled from cubes via OCS."""
    ca, cb, cc = cube_grid(slice_chips, cube)
    return Torus(dims=(ca * cube.side, cb * cube.side, cc * cube.side),
                 link_gbps=link_gbps)


def mesh_axis_torus(mesh_shape: Sequence[int], axis_names: Sequence[str],
                    link_gbps: float) -> Dict[str, Torus]:
    """Map logical mesh axes onto torus rings for collective costing.

    For the production meshes in this repo:
      (16,16)      -> data and model each ride one 16-ring of the 2D torus.
      (2,16,16)    -> pod axis crosses the inter-pod DCN/ICI boundary; data
                      and model ride intra-pod rings.
    Each axis is modeled as a 1-D (ring) torus of its own size sharing the
    per-direction ICI link bandwidth. The "pod" axis gets the same link rate
    (paper: cross-pod synchronous DP is feasible at >90% goodput; we model
    its bandwidth as ICI-class and note the assumption in DESIGN.md).
    """
    return {
        name: Torus(dims=(size,), link_gbps=link_gbps)
        for name, size in zip(axis_names, mesh_shape)
    }
