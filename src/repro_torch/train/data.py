"""Deterministic synthetic LM data (the port's copy of ``repro.train.data``,
numpy only, so its batches are the reference's exactly).

Token streams come from a fixed-seed order-1 Markov chain with zipfian
transition probabilities: enough structure that training loss falls and
quantization formats give measurably different losses.  A batch is indexed
by (step, shard), so any host can regenerate any shard and a restart never
loses the data order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 256
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 1234
    branching: int = 8  # markov successors per state: lower = more learnable


class SyntheticLM:
    """Order-1 Markov chain over the vocab with zipf-distributed stationary
    probabilities; transitions are a fixed random sparse matrix."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v, b = cfg.vocab_size, cfg.branching
        self.successors = rng.integers(0, v, size=(v, b))
        probs = 1.0 / np.arange(1, b + 1) ** 1.2
        self.trans_probs = probs / probs.sum()

    def _gen_tokens(self, rng: np.random.Generator, n: int) -> np.ndarray:
        v, b = self.cfg.vocab_size, self.cfg.branching
        out = np.empty(n, np.int32)
        s = int(rng.integers(0, v))
        choices = rng.choice(b, size=n, p=self.trans_probs)
        for i in range(n):
            out[i] = s
            s = int(self.successors[s, choices[i]])
        return out

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> Dict[str, np.ndarray]:
        """Deterministic batch for (step, shard): tokens + next-token labels."""
        cfg = self.cfg
        assert cfg.global_batch % num_shards == 0
        bsz = cfg.global_batch // num_shards
        rows = []
        for r in range(bsz):
            seq_id = (step * cfg.global_batch) + shard * bsz + r
            rng = np.random.default_rng((cfg.seed, seq_id))
            rows.append(self._gen_tokens(rng, cfg.seq_len + 1))
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def stream(self, start_step: int = 0, shard: int = 0, num_shards: int = 1) -> Iterator[Dict]:
        step = start_step
        while True:
            yield self.batch(step, shard, num_shards)
            step += 1


def calibration_batches(model_params_like, n: int = 4, seq_len: int = 64, cfg: Optional[DataConfig] = None):
    """Small activation-calibration stream (the paper uses Pile samples)."""
    cfg = cfg or DataConfig(seq_len=seq_len, global_batch=2)
    ds = SyntheticLM(cfg)
    return [ds.batch(i) for i in range(n)]
