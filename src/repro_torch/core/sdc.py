"""Silent-data-corruption defenses of the port (``repro.core.sdc``): the
FBIST golden-pattern self-test of a matmul unit, the sampled replay
checker, the fleet SDC rate model and the screening loop.

FBIST runs golden patterns (numpy, byte-equal to the reference's) through
the very matmul the system uses and compares against float64 numpy
goldens, an oracle independent of the unit under test. The replay checker
re-executes a sampled share of rows with the lane (last) dimension
reversed and demands equality, so a bad lane shows. Faults are injected in
tests with ``faulty_wrap``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Fault injection (tests / simulation only).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FaultModel:
    """A marginal-silicon fault: with probability ``rate`` per call, one
    output element x becomes x * (1 + magnitude) + magnitude (a plausible
    wrong value, not a NaN)."""

    rate: float = 1.0
    magnitude: float = 1e-2
    seed: int = 0

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed)

    def corrupt(self, x: np.ndarray) -> np.ndarray:
        if self._rng.random() >= self.rate or x.size == 0:
            return x
        x = np.array(x, copy=True)
        idx = self._rng.integers(0, x.size)
        flat = x.reshape(-1)
        flat[idx] = flat[idx] * (1.0 + self.magnitude) + self.magnitude
        return x


def faulty_wrap(fn: Callable[..., Tensor],
                fault: FaultModel) -> Callable[..., Tensor]:
    """Wrap a compute callable so its output is silently corrupted. The
    output goes through numpy (bf16 as f32) and comes back as a tensor of
    its dtype on its device."""

    def wrapped(*args: Tensor) -> Tensor:
        out = fn(*args)
        host = out.detach().cpu()
        if host.dtype == torch.bfloat16:
            host = host.float()
        bad = torch.from_numpy(fault.corrupt(host.numpy()))
        return bad.to(device=out.device, dtype=out.dtype)

    return wrapped


# ---------------------------------------------------------------------------
# FBIST: functional built-in self test for matmul units.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FBISTReport:
    passed: bool
    patterns_run: int
    first_failing_pattern: Optional[int]
    max_abs_err: float


class FBIST:
    """Golden-pattern self-test for a matmul implementation: dense random,
    rank-1, checkerboard, tiny- and large-magnitude patterns (all PEs,
    edge propagation, carry chains, denormal range, accumulator range),
    each against a float64 numpy golden."""

    def __init__(self, m: int = 128, k: int = 128, n: int = 128,
                 n_patterns: int = 8, seed: int = 1234,
                 tol: float = 5e-2):
        self.shape = (m, k, n)
        self.n_patterns = n_patterns
        self.seed = seed
        self.tol = tol
        self._patterns = [self._make_pattern(i) for i in range(n_patterns)]

    def _make_pattern(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        m, k, n = self.shape
        rng = np.random.default_rng(self.seed + i)
        kind = i % 5
        if kind == 0:  # dense random
            a = rng.standard_normal((m, k))
            b = rng.standard_normal((k, n))
        elif kind == 1:  # rank-1 structured
            a = np.outer(rng.standard_normal(m), np.ones(k))
            b = np.outer(np.ones(k), rng.standard_normal(n))
        elif kind == 2:  # checkerboard
            a = ((np.indices((m, k)).sum(0) % 2) * 2.0 - 1.0)
            b = ((np.indices((k, n)).sum(0) % 2) * 2.0 - 1.0)
        elif kind == 3:  # tiny magnitudes
            a = rng.standard_normal((m, k)) * 1e-3
            b = rng.standard_normal((k, n)) * 1e-3
        else:  # large magnitudes (accumulator range)
            a = rng.standard_normal((m, k)) * 64.0
            b = rng.standard_normal((k, n)) * 64.0
        return a.astype(np.float32), b.astype(np.float32)

    def run(self, matmul: Callable[[Tensor, Tensor], Tensor], *,
            device: DeviceLike = None) -> FBISTReport:
        """Each pattern goes onto ``device`` (default: the card), through
        ``matmul``, and back to the host as float64."""
        dev = resolve_device(device)
        max_err = 0.0
        for i, (a, b) in enumerate(self._patterns):
            golden = a.astype(np.float64) @ b.astype(np.float64)
            out = matmul(torch.from_numpy(a).to(dev),
                         torch.from_numpy(b).to(dev))
            got = out.detach().double().cpu().numpy()
            scale = np.maximum(np.abs(golden), 1.0)
            err = float(np.max(np.abs(got - golden) / scale))
            max_err = max(max_err, err)
            if not np.isfinite(err) or err > self.tol:
                return FBISTReport(False, i + 1, i, max_err)
        return FBISTReport(True, self.n_patterns, None, max_err)


# ---------------------------------------------------------------------------
# Replay checker: sampled redundant execution of vector work.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReplayReport:
    passed: bool
    bundles_checked: int
    mismatches: int


class ReplayChecker:
    """Sampled redundant execution with lane permutation.

    ``check(fn, x, generator)`` picks ``sample_frac`` of the rows of x
    without replacement (from ``generator``), evaluates fn on them twice,
    once as-is and once with the lane (last) dimension reversed and the
    result un-reversed, and counts elements that differ by more than
    ``atol`` (exact equality by default, for elementwise fn)."""

    def __init__(self, sample_frac: float = 0.0625, atol: float = 0.0):
        if not 0.0 < sample_frac <= 1.0:
            raise ValueError("sample_frac in (0, 1]")
        self.sample_frac = sample_frac
        self.atol = atol

    def check(self, fn: Callable[[Tensor], Tensor], x: Tensor,
              generator: torch.Generator) -> ReplayReport:
        if x.dim() < 2:
            x = x.reshape(1, -1)
        n = x.shape[0]
        k = max(1, int(round(n * self.sample_frac)))
        idx = torch.randperm(n, generator=generator,
                             device=generator.device)[:k].to(x.device)
        sample = x[idx]
        primary = fn(sample)
        replayed = torch.flip(fn(torch.flip(sample, dims=(-1,))),
                              dims=(-1,))
        mismatches = int(((primary - replayed).abs() > self.atol).sum())
        return ReplayReport(mismatches == 0, k, mismatches)


# ---------------------------------------------------------------------------
# Fleet-level SDC rate model (consumed by the fleet simulator).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SDCRateModel:
    """Corruptions arrive as a Poisson process at ``rate_per_chip_hour``
    per chip; screens every ``screen_interval_s`` each catch an active
    corruption with probability ``screen_coverage`` (a geometric
    detection delay over screen intervals)."""

    rate_per_chip_hour: float = 1e-7
    screen_interval_s: float = 300.0
    screen_coverage: float = 0.9

    def __post_init__(self) -> None:
        if not 0.0 < self.screen_coverage <= 1.0:
            raise ValueError("screen_coverage in (0, 1]")

    def corruption_rate_per_s(self, chips: int) -> float:
        return self.rate_per_chip_hour * chips / 3600.0

    def draw_time_to_corruption_s(self, rng: np.random.Generator,
                                  chips: int) -> float:
        rate = self.corruption_rate_per_s(chips)
        if rate <= 0.0:
            return float("inf")
        return float(rng.exponential(1.0 / rate))

    def draw_detection_delay_s(self, rng: np.random.Generator) -> float:
        """Time from corruption to the screen that catches it (the first
        opportunity is the next screen boundary)."""
        missed = int(rng.geometric(self.screen_coverage)) - 1
        offset = float(rng.uniform(0.0, self.screen_interval_s))
        return offset + missed * self.screen_interval_s


# ---------------------------------------------------------------------------
# Fleet screening loop (FBIST across devices).
# ---------------------------------------------------------------------------


def screen_devices(
    matmuls: Sequence[Callable[[Tensor, Tensor], Tensor]],
    *,
    fbist: Optional[FBIST] = None,
    device: DeviceLike = None,
) -> List[int]:
    """Run FBIST over per-device matmul callables; return the indices of
    the defective ones (to be mapped out)."""
    fb = fbist or FBIST()
    return [i for i, mm in enumerate(matmuls)
            if not fb.run(mm, device=device).passed]
