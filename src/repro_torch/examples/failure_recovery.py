"""Failure recovery (the port of ``examples/failure_recovery.py``): cube
failures in the middle of training, spares substituted by the OCS
scheduler, a restore from the last checkpoint and a replay, and a loss
trajectory bit-identical to an uninterrupted run's (the paper's
resilience contract: checkpoint and restore, deterministic repeatability,
modular isolation).

    PYTHONPATH=src python -m repro_torch.examples.failure_recovery
    PYTHONPATH=src python -m repro_torch.examples.failure_recovery \
        --device cpu

internlm2-1.8B at smoke size, batch 4 x 64, 30 steps, a checkpoint every
8; failures at steps 11 (cube 5) and 23 (cube 40). Weights are random,
made from seed 0 on the device. On the card the attention of the loss's
forward runs the hand-written flash kernel, and ``build_trainer`` turns on
PyTorch's deterministic mode, which the bit-identical replay needs.
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.registry import get_smoke
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.train import build_trainer

ARCH = "internlm2_1_8b"
STEPS = 30
FAILURES = {11: 5, 23: 40}  # step -> failed cube


def run(failures: Dict[int, int], ckpt_dir: str, device: DeviceLike = None
        ) -> Tuple[List[float], Any]:
    """Train ``STEPS`` steps with ``failures`` injected; returns (losses,
    goodput ledger)."""
    trainer, state = build_trainer(
        get_smoke(ARCH), batch=4, seq=64, ckpt_dir=ckpt_dir,
        checkpoint_every=8, failures=failures, device=device)
    state, ledger, losses = trainer.run(state, STEPS)
    return losses, ledger


def main(argv: Optional[Sequence[str]] = None) -> bool:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' on request)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        print("running clean baseline ...")
        losses_clean, ledger_clean = run({}, d1, dev)
        print("running with cube failures at steps 11 and 23 ...")
        losses_fail, ledger_fail = run(FAILURES, d2, dev)

    identical = losses_clean == losses_fail
    print(f"\nloss trajectories identical: {identical}")
    print(f"clean   goodput: {ledger_clean.goodput:.4f}")
    s = ledger_fail.summary()
    print(f"failure goodput: {s['goodput']:.4f} "
          f"(rework {s['rework_s']:.2f}s, restore {s['restore_s']:.2f}s, "
          f"detect {s['detect_s']:.2f}s)")
    if not identical:
        raise AssertionError("recovery must reproduce the exact trajectory")
    print("OK: failures recovered with exact-replay semantics")
    return identical


if __name__ == "__main__":
    main()
