"""Synthetic token batches for the examples and the smoke script, in a
module without torch: the shm feed's coworker processes import the
module of their ``batch_fn`` and must not pay a torch import.

``synth_batch`` is the JAX example's (``examples/llama_train.py``):
int32 tokens seeded by the shard's first sample index, so every shard
is reproducible. ``ShardBatch`` is its picklable ``batch_fn`` for
``ElasticShmDataLoader`` and adds the shard's row range, so that the
trainer knows which samples each step trained on. ``SeededBatches`` is
``bench.py``'s ``_BenchProducer``: a stream of batches from one seeded
generator for ``ShmDataLoader``.
"""

from typing import Iterator, Tuple

import numpy as np


def synth_batch(start: int, end: int, seq_len: int = 128,
                vocab: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """One shard's (tokens, targets), int32 [end - start, seq_len]. A
    real job reads and tokenizes a corpus slice here."""
    rng = np.random.default_rng(start)
    tokens = rng.integers(0, vocab, (end - start, seq_len), dtype=np.int32)
    return tokens, tokens


class ShardBatch:
    """``batch_fn(start, end) -> (tokens, targets, rows)``: the shard's
    ``synth_batch`` and its row range ``[start, end)`` as an int64
    array of two."""

    def __init__(self, seq_len: int, vocab: int):
        self.seq_len = seq_len
        self.vocab = vocab

    def __call__(self, start: int, end: int):
        tokens, targets = synth_batch(start, end, self.seq_len, self.vocab)
        return tokens, targets, np.array([start, end], dtype=np.int64)


class SeededBatches:
    """``n_batches`` of int32 (tokens, tokens) [batch, seq] from one
    generator seeded with ``seed`` (``bench.py``'s ``_BenchProducer``).
    ``expected`` gives the same batches in the consumer's process."""

    def __init__(self, n_batches: int, batch: int, seq: int, vocab: int,
                 seed: int = 0):
        self.n_batches = n_batches
        self.batch = batch
        self.seq = seq
        self.vocab = vocab
        self.seed = seed

    def __call__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        for _ in range(self.n_batches):
            t = rng.integers(0, self.vocab, (self.batch, self.seq),
                             dtype=np.int32)
            yield t, t

    def expected(self):
        return [t for t, _ in self()]
