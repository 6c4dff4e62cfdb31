"""Deterministic data pipeline (a numpy-only copy of
``repro.data.pipeline``: the same tokens for the same seed and step).

Paper §Resilience point 4: "Strict deterministic repeatability requirements:
to aid in system testing and failure detection." The pipeline here is a
pure function of (seed, step): restarting from a checkpoint at step k
replays exactly the batches k, k+1, ... — no iterator state to persist, no
drift between replicas. The same property drives the determinism tests and
lets the failure-injection benchmark verify bit-identical losses across a
kill/restore cycle.

Sources: a synthetic token stream (hashed counter -> vocab) used by tests
and benchmarks, and a binary token-file source (memory-mapped, sharded by
host) for real corpora. Both produce next-token-prediction batches with
labels shifted by one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    token_file: Optional[str] = None  # None -> synthetic


def _philox_tokens(seed: int, step: int, batch: int, seq: int,
                   vocab: int) -> np.ndarray:
    """Counter-based deterministic tokens: f(seed, step) with no state."""
    rng = np.random.Generator(
        np.random.Philox(key=seed, counter=[0, 0, 0, step]))
    # skew towards low ids like a zipfian corpus (cheap approximation)
    u = rng.random((batch, seq + 1))
    toks = np.floor((u ** 3.0) * vocab).astype(np.int32)
    return np.minimum(toks, vocab - 1)


class TokenFileSource:
    """Memory-mapped int32 token file; step-indexed deterministic slices."""

    def __init__(self, path: str, cfg: DataConfig):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.cfg = cfg
        need = cfg.global_batch * (cfg.seq_len + 1)
        if len(self.tokens) < need:
            raise ValueError(
                f"token file too small: {len(self.tokens)} < {need}")

    def batch_at(self, step: int) -> np.ndarray:
        cfg = self.cfg
        span = cfg.global_batch * (cfg.seq_len + 1)
        n_spans = len(self.tokens) // span
        rng = np.random.Generator(
            np.random.Philox(key=cfg.seed, counter=[0, 0, 0, step]))
        start = int(rng.integers(0, n_spans)) * span
        flat = np.asarray(self.tokens[start:start + span])
        return flat.reshape(cfg.global_batch, cfg.seq_len + 1)


class DataPipeline:
    """Step-indexed batches; ``batch_for_step(k)`` is pure in (seed, k)."""

    def __init__(self, cfg: DataConfig, model_cfg: Optional[ModelConfig] = None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.source = (TokenFileSource(cfg.token_file, cfg)
                       if cfg.token_file else None)

    def batch_for_step(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        if self.source is not None:
            toks = self.source.batch_at(step)
        else:
            toks = _philox_tokens(cfg.seed, step, cfg.global_batch,
                                  cfg.seq_len, cfg.vocab_size)
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        mc = self.model_cfg
        if mc is not None and mc.is_encoder_decoder:
            rng = np.random.Generator(
                np.random.Philox(key=cfg.seed + 1, counter=[0, 0, 0, step]))
            batch["enc_feats"] = rng.standard_normal(
                (cfg.global_batch, mc.encoder_seq, mc.d_model),
                dtype=np.float32) * 0.1
        if mc is not None and mc.pos_emb == "mrope":
            pos = np.broadcast_to(np.arange(cfg.seq_len, dtype=np.int32),
                                  (cfg.global_batch, cfg.seq_len))
            batch["positions"] = np.stack([pos, pos, pos])
        return batch

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_for_step(step)
            step += 1
