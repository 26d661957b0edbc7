"""The seeded Markov language of the synthetic data pipeline.

A copy of the JAX package's ``data/pipeline.py`` ``markov_table`` and
``markov_sample``: each token has 8 plausible successors, drawn from a
seeded table, so the trace synthesizer (``trace/synth.py``) makes the
same prompts in both packages.  ``SyntheticLM`` (training batches)
joins with the training substrate (``ROADMAP.md``).
"""
from __future__ import annotations

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
