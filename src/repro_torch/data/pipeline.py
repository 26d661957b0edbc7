"""The seeded Markov language of the synthetic data pipeline.

A copy of the JAX package's ``data/pipeline.py``: each token has 8
plausible successors, drawn from a seeded table (``markov_table``,
``markov_sample``), so the trace synthesizer (``trace/synth.py``) makes
the same prompts in both packages, and ``SyntheticLM`` the same
training batches, byte for byte.  Every batch is a pure function of
(step, shard): a restarted or replaced worker regenerates exactly the
batches it owes, with no data state to checkpoint.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def markov_table(vocab: int, branch: int = 8, seed: int = 1234
                 ) -> np.ndarray:
    """(vocab, branch) successor table, deterministic in seed."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, vocab, size=(vocab, branch)).astype(np.int32)


def markov_sample(table: np.ndarray, length: int, rng: np.random.RandomState
                  ) -> np.ndarray:
    vocab, branch = table.shape
    out = np.empty(length, np.int32)
    t = rng.randint(vocab)
    choices = rng.randint(0, branch, size=length)
    for i in range(length):
        out[i] = t
        t = table[t, choices[i]]
    return out


@dataclass
class SyntheticLM:
    """Next-token batches of the seeded Markov language: ``batch_for_step``
    -> {"tokens", "targets"} int32 numpy (batch, seq), targets the
    tokens shifted by one."""
    vocab: int
    seq: int
    batch: int
    n_shards: int = 1
    shard: int = 0
    branch: int = 8
    seed: int = 1234

    def __post_init__(self):
        self.table = markov_table(self.vocab, self.branch, self.seed)

    def batch_for_step(self, step: int):
        rng = np.random.RandomState(
            (step * 1_000_003 + self.shard * 7919 + self.seed) % (2**31 - 1))
        toks = np.stack([markov_sample(self.table, self.seq + 1, rng)
                         for _ in range(self.batch)])
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
