"""Deterministic, shardable token data pipeline: the port's copy of
``repro.data.pipeline`` (numpy only; the port imports nothing of the JAX
package).  Batches are numpy arrays drawn from the same Philox counters,
so they equal the JAX package's exactly.

* ``SyntheticLM`` — seeded zipfian token stream (self-contained; used by
  the examples and tests).
* ``PackedFileDataset`` — memory-mapped uint32 token file, packed into
  fixed-length rows.
* Determinism & fault tolerance: batches are a pure function of
  (seed, step), so restart-at-step-k reproduces the exact stream without
  any saved iterator state — the checkpoint only needs the step counter.
* Sharding: ``host_slice`` carves the per-host batch rows by
  (host_index, host_count), matching the DP axis layout.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    pad_id: int = -1
    frontend_tokens: int = 0
    d_model: int = 0


class SyntheticLM:
    """Batch = f(seed, step): restartable with zero iterator state."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int, host_index: int = 0,
                 host_count: int = 1) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rows = cfg.global_batch // host_count
        rng = np.random.Generator(np.random.Philox(
            key=cfg.seed, counter=[0, 0, step, host_index]))
        z = rng.zipf(cfg.zipf_a, size=(rows, cfg.seq_len + 1))
        tokens = (z % (cfg.vocab_size - 1)).astype(np.int32) + 1
        batch = {"tokens": tokens[:, :-1],
                 "labels": tokens[:, 1:].astype(np.int32)}
        if cfg.frontend_tokens:
            batch["frontend"] = rng.standard_normal(
                (rows, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PackedFileDataset:
    """Flat uint32 token file -> packed (batch, seq_len+1) rows.

    Row selection is a pure function of (seed, step) over the valid window
    count, so restarts are deterministic here too.
    """

    def __init__(self, path: str, cfg: DataConfig):
        self.cfg = cfg
        self.tokens = np.memmap(path, dtype=np.uint32, mode="r")
        self.n_windows = (len(self.tokens) - 1) // cfg.seq_len
        if self.n_windows < 1:
            raise ValueError(f"{path}: too few tokens for seq_len "
                             f"{cfg.seq_len}")

    def batch_at(self, step: int, host_index: int = 0,
                 host_count: int = 1) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rows = cfg.global_batch // host_count
        rng = np.random.Generator(np.random.Philox(
            key=cfg.seed, counter=[0, 1, step, host_index]))
        idx = rng.integers(0, self.n_windows, size=rows)
        out = np.stack([
            self.tokens[i * cfg.seq_len:(i + 1) * cfg.seq_len + 1]
            for i in idx]).astype(np.int32)
        out = np.minimum(out, cfg.vocab_size - 1)
        return {"tokens": out[:, :-1], "labels": out[:, 1:]}


def host_slice(batch: Dict[str, np.ndarray], host_index: int,
               host_count: int) -> Dict[str, np.ndarray]:
    def sl(x):
        rows = x.shape[0] // host_count
        return x[host_index * rows:(host_index + 1) * rows]
    return {k: sl(v) for k, v in batch.items()}
