"""Quickstart (the port of ``examples/quickstart.py``): train a ~100M-param
dense LM for a few hundred steps.

The end-to-end driver: a real config, the deterministic data pipeline,
AdamW with the cosine schedule, async checkpointing, goodput and carbon
ledgers — the whole training path at a small size, in bf16 compute on
the card (parameters and optimizer state stay f32).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--steps 300]

The device is the card unless ``--device cpu``. ``make_optimizer`` warms
up over 200 steps, so a run much shorter than the default 300 may not
show the loss fall, which the last line asserts. The emissions line is
the paper's Ironwood CCI applied to the run's 6 * N * tokens FLOPs: what
those FLOPs would emit on an Ironwood pod, not a reading of this device.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from typing import Optional, Sequence

import torch

from repro_torch.core.cci import CCI_BY_NAME, CarbonLedger
from repro_torch.device import resolve_device
from repro_torch.launch.train import build_trainer
from repro_torch.models.config import ModelConfig

# ~100M params: 12L, d=512, 8H, kv=4, ff=2048, 32k vocab
CONFIG_100M = ModelConfig(
    name="quickstart-100m", family="dense",
    n_layers=12, d_model=512, n_heads=8, n_kv_heads=4, d_ff=2048,
    vocab_size=32768, head_dim=64,
)


def make_trainer(ckpt_dir: str, batch: int = 8, seq: int = 128,
                 device=None):
    """The quickstart's trainer and its initial state: ``CONFIG_100M``,
    two microbatches, a checkpoint every 50 steps, bf16 compute."""
    return build_trainer(
        CONFIG_100M, batch=batch, seq=seq, ckpt_dir=ckpt_dir,
        microbatches=2, checkpoint_every=50,
        compute_dtype=torch.bfloat16, device=device)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' on request)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print(f"model: {CONFIG_100M.total_params()/1e6:.1f}M params")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer, state = make_trainer(ckpt_dir, args.batch, args.seq,
                                      device)
        carbon = CarbonLedger(CCI_BY_NAME["ironwood"])
        t0 = time.time()
        state, ledger, losses = trainer.run(state, args.steps)
        wall = time.time() - t0
        tokens = args.batch * args.seq * len(losses)
        carbon.record_step(6.0 * CONFIG_100M.total_params() * tokens)
        print(f"\n{len(losses)} steps, {wall:.0f}s, "
              f"{tokens/wall:.0f} tok/s on {device.type}")
        print(f"loss: {losses[0]:.3f} -> {min(losses):.3f}")
        print("goodput:", round(ledger.goodput, 4))
        print("emissions if run on an Ironwood pod (the paper's CCI):",
              f"{carbon.grams_co2e:.2e} gCO2e")
        if not losses[-1] < losses[0]:
            raise AssertionError("loss did not improve")


if __name__ == "__main__":
    main()
