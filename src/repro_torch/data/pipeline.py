"""Deterministic, checkpointable, host-sharded synthetic data pipeline
(the port's own copy of ``repro/data/pipeline.py``: numpy only, batches
byte-equal to the JAX package's).

Every batch is a pure function of (seed, step, host shard), so a restart
from checkpoint step N reproduces the exact token stream — the property
a 1000-node run needs so data order survives preemptions, and different
host counts partition (not duplicate) the stream.

Two sources:
  * ``random``: uniform tokens (for shape/throughput work);
  * ``markov``: an order-1 Markov chain with a seed-fixed sparse
    transition table — learnable structure, so example training runs show
    a real CE drop toward the chain's entropy floor.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "markov"       # markov | random
    branching: int = 4           # markov out-degree


class SyntheticDataset:
    """Stateless per-step batch generator (state == the step integer)."""

    def __init__(self, cfg: DataConfig, process_index: int = 0,
                 process_count: int = 1):
        assert cfg.global_batch % process_count == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // process_count
        self.process_index = process_index
        if cfg.source == "markov":
            rng = np.random.RandomState(cfg.seed)
            # each token can be followed by `branching` successors
            self.successors = rng.randint(
                0, cfg.vocab, size=(cfg.vocab, cfg.branching)).astype(np.int32)

    @property
    def entropy_floor(self) -> float:
        """CE floor in nats for the markov source."""
        return float(np.log(self.cfg.branching))

    def batch(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.RandomState(
            (c.seed * 1_000_003 + step * 997 + self.process_index) % 2**31)
        if c.source == "random":
            toks = rng.randint(0, c.vocab, size=(self.local_batch, c.seq_len))
        else:
            toks = np.empty((self.local_batch, c.seq_len), np.int32)
            toks[:, 0] = rng.randint(0, c.vocab, size=self.local_batch)
            choices = rng.randint(0, c.branching,
                                  size=(self.local_batch, c.seq_len - 1))
            for t in range(1, c.seq_len):
                toks[:, t] = self.successors[toks[:, t - 1], choices[:, t - 1]]
        toks = toks.astype(np.int32)
        return {"tokens": toks, "labels": toks}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
