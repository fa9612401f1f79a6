"""Deterministic, resumable data pipeline for model training: the port's
own copy of ``repro.data.pipeline`` (pure numpy), so its batches are
bit-identical to the reference's for every ``(seed, step, shard)``.

Fault-tolerance requirement: after checkpoint/restart the pipeline must
resume at exactly the next unseen batch with no host coordination.  We get
this by deriving every batch from a *counter-based* PRNG keyed by
``(seed, step, shard)`` — there is no mutable iterator state to lose; the
checkpoint stores only the integer ``step``.

The synthetic LM stream draws Zipf-distributed token ids (matching the
corpus statistics used elsewhere in the framework) with a simple Markov
blending so that the ~100M-parameter example model has learnable structure.
Recsys batches (dense features, multi-hot sparse ids, history sequences)
are generated the same counter-based way.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

__all__ = ["PipelineState", "TokenPipeline", "RecsysPipeline"]


@dataclasses.dataclass(frozen=True)
class PipelineState:
    """Complete pipeline state — an integer. Stored in every checkpoint."""

    step: int = 0

    def advance(self, n: int = 1) -> "PipelineState":
        return PipelineState(step=self.step + n)


def _rng(seed: int, step: int, shard: int) -> np.random.Generator:
    # Counter-based: independent stream per (seed, step, shard).
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(step, shard))
    )


class TokenPipeline:
    """Synthetic LM token stream.

    Produces ``(tokens, targets)`` of shape (batch_per_shard, seq_len).
    Tokens follow a Zipf marginal with first-order structure: with
    probability ``repeat_p`` a token copies one of the previous 8 tokens,
    which gives next-token prediction a signal the example trainer can
    visibly reduce loss on.
    """

    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        batch_per_shard: int,
        seed: int = 0,
        zipf_s: float = 1.05,
        repeat_p: float = 0.3,
    ):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch_per_shard = batch_per_shard
        self.seed = seed
        self.repeat_p = repeat_p
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = ranks**-zipf_s
        self._cdf = np.cumsum(p / p.sum())

    def batch(self, state: PipelineState, shard: int = 0) -> Dict[str, np.ndarray]:
        rng = _rng(self.seed, state.step, shard)
        shape = (self.batch_per_shard, self.seq_len + 1)
        toks = np.searchsorted(self._cdf, rng.random(shape), side="right").astype(
            np.int32
        )
        # Local repetition structure.
        rep = rng.random(shape) < self.repeat_p
        lag = rng.integers(1, 9, size=shape)
        idx = np.maximum(np.arange(shape[1])[None, :] - lag, 0)
        toks = np.where(rep, np.take_along_axis(toks, idx, axis=1), toks)
        np.clip(toks, 0, self.vocab_size - 1, out=toks)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class RecsysPipeline:
    """Synthetic CTR/sequential-recommendation batches.

    Emits the superset of fields the four recsys architectures consume;
    each model picks what it needs:
      * ``dense``      (B, n_dense) float32
      * ``sparse_ids`` (B, n_fields) int32 — one categorical id per field
      * ``hist_ids``   (B, hist_len) int32 — user behaviour sequence
      * ``hist_mask``  (B, hist_len) float32
      * ``target_id``  (B,) int32 — candidate item
      * ``label``      (B,) float32 — click
    """

    def __init__(
        self,
        n_dense: int,
        n_fields: int,
        vocab_size: int,
        hist_len: int,
        batch_per_shard: int,
        seed: int = 0,
    ):
        self.n_dense = n_dense
        self.n_fields = n_fields
        self.vocab_size = vocab_size
        self.hist_len = hist_len
        self.batch_per_shard = batch_per_shard
        self.seed = seed

    def batch(self, state: PipelineState, shard: int = 0) -> Dict[str, np.ndarray]:
        rng = _rng(self.seed ^ 0x5EC5, state.step, shard)
        b = self.batch_per_shard
        dense = rng.standard_normal((b, self.n_dense)).astype(np.float32)
        sparse = rng.zipf(1.2, size=(b, self.n_fields)) % self.vocab_size
        hist = rng.zipf(1.2, size=(b, self.hist_len)) % self.vocab_size
        hist_valid = (
            np.arange(self.hist_len)[None, :]
            < rng.integers(1, self.hist_len + 1, size=(b, 1))
        )
        target = rng.zipf(1.2, size=b) % self.vocab_size
        # Label has learnable structure: click iff target appears in history
        # or the dense projection is positive, with noise.
        clicked = (hist == target[:, None]).any(axis=1) | (dense[:, 0] > 0.5)
        flip = rng.random(b) < 0.1
        label = (clicked ^ flip).astype(np.float32)
        return {
            "dense": dense,
            "sparse_ids": sparse.astype(np.int32),
            "hist_ids": np.where(hist_valid, hist, 0).astype(np.int32),
            "hist_mask": hist_valid.astype(np.float32),
            "target_id": target.astype(np.int32),
            "label": label,
        }
