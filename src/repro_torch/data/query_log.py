"""Query logs and term-probability estimation.

The paper (§3.1) needs only the *marginal* probability P[t] of each term
appearing in a query; it estimates these either from a query log (AOL,
pagenstecher) or from corpus term frequencies.  The paper's evaluation
uses 2-term conjunctive queries; the engine (and this sampler) supports
arbitrary arity — the SAP-HANA attribute-filter scenario the paper cites
("in stock AND category=X AND brand=Y") is a 3-term conjunction.

Synthetic logs here are sampled with Zipf rank-probabilities over terms
(matching the paper's Figure 1) with a configurable topical co-occurrence
bias: with probability ``co_topic`` a non-leading query term is drawn from
the same topic block as the leading term, which mirrors real logs where
query terms are semantically related (and which makes the clustered
speedup realistic rather than adversarial).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.queries import QUERY_PAD, ConjunctiveQueries
from repro_torch.data.corpus import Corpus

__all__ = [
    "QueryLog",
    "synth_query_log",
    "term_probabilities",
    "poisson_arrivals",
]


@dataclasses.dataclass
class QueryLog:
    """A set of conjunctive queries in the padded rectangular form.

    ``queries`` has shape (n_queries, max_arity), int32 term ids; rows
    with fewer terms are filled with ``QUERY_PAD`` (-1).  Terms within a
    query are distinct.  The historical 2-term log is the pad-free
    ``max_arity == 2`` case.

    ``arrivals`` (optional) carries one open-loop arrival timestamp per
    query — float64 seconds, nondecreasing — for serving replay
    (``repro_torch.serve.replay``).  A log without timestamps is the
    historical closed-batch form.
    """

    queries: np.ndarray
    arrivals: Optional[np.ndarray] = None

    @property
    def n_queries(self) -> int:
        return len(self.queries)

    @property
    def max_arity(self) -> int:
        return self.queries.shape[1] if self.queries.ndim == 2 else 0

    def arities(self) -> np.ndarray:
        return (self.queries != QUERY_PAD).sum(axis=1)

    def as_conjunctive(self) -> ConjunctiveQueries:
        return ConjunctiveQueries.from_padded(self.queries)

    def distinct_terms(self) -> np.ndarray:
        t = np.unique(self.queries)
        return t[t != QUERY_PAD]

    def stats(self) -> dict:
        """Table-2-style statistics."""
        return {
            "queries": self.n_queries,
            "distinct_terms": int(len(self.distinct_terms())),
            "mean_arity": float(self.arities().mean()) if self.n_queries else 0.0,
        }


def poisson_arrivals(
    n: int,
    qps: float,
    seed: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Open-loop Poisson arrival timestamps at a mean rate of ``qps``.

    Returns ``n`` nondecreasing float64 seconds: the cumulative sum of
    exponential inter-arrival gaps with mean ``1/qps``.  Open-loop means
    arrivals do not wait for replies — the process the serving loop must
    absorb, as opposed to closed-loop ping-pong benchmarking.
    """
    if qps <= 0:
        raise ValueError(f"qps must be positive, got {qps}")
    if rng is None:
        rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / qps, size=int(n)))


def synth_query_log(
    corpus: Corpus,
    n_queries: int = 20_000,
    zipf_s: float = 0.85,
    co_topic: float = 0.5,
    frequency_weight: float = 0.5,
    seed: int = 1,
    arity: int | Sequence[int] = 2,
    arity_weights: Optional[Sequence[float]] = None,
    arrival_qps: Optional[float] = None,
) -> QueryLog:
    """Sample a Zipf-like conjunctive query log against ``corpus``.

    Term query-propensity mixes corpus document frequency (people search
    for terms that exist) with a Zipf-over-frequency-rank tilt, then the
    non-leading terms are drawn either independently or within the same
    topical block as the leading term.  Terms with zero document frequency
    are never sampled (queries with an empty posting list cost nothing and
    the paper's logs are real text).

    ``arity`` is either a single arity for every query (default 2, the
    paper's setting — identical samples to the historical 2-term-only
    sampler) or a sequence of arities sampled per query with optional
    ``arity_weights``; ragged rows are ``QUERY_PAD``-filled.

    ``arrival_qps``, when given, attaches Poisson arrival timestamps at
    that mean rate (``QueryLog.arrivals``).  Arrivals are drawn strictly
    after every query draw from the same rng, so the query stream for a
    given seed is bit-identical with or without timestamps.
    """
    rng = np.random.default_rng(seed)
    df = corpus.term_doc_freq().astype(np.float64)
    alive = df > 0
    # Propensity: df^w * zipf(rank(df))^(1-w)
    order = np.argsort(-df, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(1, len(order) + 1)
    prop = np.where(alive, (df + 1e-9) ** frequency_weight * rank.astype(np.float64) ** (-zipf_s * (1.0 - frequency_weight)), 0.0)
    prop /= prop.sum()
    cdf = np.cumsum(prop)

    def draw(size: int) -> np.ndarray:
        return np.searchsorted(cdf, rng.random(size), side="right").astype(np.int64)

    def topical(t: np.ndarray) -> np.ndarray:
        """One companion term per entry of ``t``: with prob ``co_topic``
        drawn near t's topic block, else an independent draw."""
        n = len(t)
        u = draw(n)
        spec = corpus.spec
        if spec is not None and co_topic > 0:
            same = rng.random(n) < co_topic
            hi = spec.topic_block_hi if spec.topic_block_hi is not None else corpus.n_terms // 2
            lo = min(spec.topic_block_lo, hi - 1)
            blockw = max(1, (hi - lo) // max(spec.n_topics, 1))
            in_block = same & (t >= lo) & (t < lo + blockw * spec.n_topics)
            if in_block.any():
                z = (t[in_block] - lo) // blockw
                off = rng.integers(0, blockw, size=int(in_block.sum()))
                u2 = lo + z * blockw + off
                u2 = np.minimum(u2, corpus.n_terms - 1)
                ok = df[u2] > 0
                u[np.flatnonzero(in_block)[ok]] = u2[ok]
        return u

    def _arrivals() -> Optional[np.ndarray]:
        # Called after the last query draw: the rng stream consumed by the
        # query sampler is unchanged by the presence of timestamps.
        if arrival_qps is None:
            return None
        return poisson_arrivals(n_queries, arrival_qps, rng=rng)

    arities = np.atleast_1d(np.asarray(arity, dtype=np.int64))
    if (arities < 1).any():
        raise ValueError("query arity must be >= 1")
    max_arity = int(arities.max())

    t = draw(n_queries)

    if max_arity == 2 and len(arities) == 1:
        # The historical 2-term sampler, bit-for-bit (same rng stream).
        u = topical(t)
        eq = t == u
        while eq.any():
            u[eq] = draw(int(eq.sum()))
            eq = t == u
        q = np.stack([t, u], axis=1).astype(np.int32)
        return QueryLog(queries=q, arrivals=_arrivals())

    if arity_weights is not None:
        p = np.asarray(arity_weights, dtype=np.float64)
        p = p / p.sum()
    else:
        p = None
    per_query = rng.choice(arities, size=n_queries, p=p)

    q = np.full((n_queries, max_arity), QUERY_PAD, dtype=np.int64)
    q[:, 0] = t
    for slot in range(1, max_arity):
        need = per_query > slot  # rows still owed a term at this slot
        if not need.any():
            break
        idx = np.flatnonzero(need)
        u = topical(t[idx])
        # Terms within a query must be distinct: resample collisions.
        dup = (q[idx, :slot] == u[:, None]).any(axis=1)
        while dup.any():
            u[dup] = draw(int(dup.sum()))
            dup = (q[idx, :slot] == u[:, None]).any(axis=1)
        q[idx, slot] = u
    return QueryLog(queries=q.astype(np.int32), arrivals=_arrivals())


def term_probabilities(
    n_terms: int,
    log: Optional[QueryLog] = None,
    corpus: Optional[Corpus] = None,
    smoothing: float = 0.0,
) -> np.ndarray:
    """Estimate P[t], the probability a query contains term t (§3.1).

    From a query log when available (the accurate route), otherwise from
    corpus document frequencies (the paper's fallback).  Returns a float64
    array of shape (n_terms,) summing to 1.
    """
    if log is not None:
        flat = log.queries.ravel()
        flat = flat[flat != QUERY_PAD]  # ragged rows carry pad entries
        counts = np.bincount(flat, minlength=n_terms).astype(np.float64)
    elif corpus is not None:
        counts = corpus.term_doc_freq().astype(np.float64)
    else:
        raise ValueError("need a query log or a corpus")
    counts += smoothing
    total = counts.sum()
    if total <= 0:
        raise ValueError("empty statistics")
    return counts / total
