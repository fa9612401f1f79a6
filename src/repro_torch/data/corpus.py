"""Synthetic document corpora with Zipf marginals and latent-topic structure.

A corpus is a CSR set-of-terms representation:

  * ``doc_ptr``   -- int64 array of shape (n_docs + 1,)
  * ``doc_terms`` -- int32 array of shape (nnz,); ``doc_terms[doc_ptr[d]:
    doc_ptr[d+1]]`` is the sorted set of distinct term ids in document d.

Posting lists store each document at most once per term (the paper
intersects lists of document IDs), so the corpus stores term *sets*.

Generation model
----------------
Global term marginal is Zipf(s) over ``n_terms`` ranks.  ``n_topics``
latent topics each boost a contiguous block of mid-frequency term ranks by
``topic_boost``; a document draws one topic and samples
``topicality`` of its tokens from the boosted distribution and the rest
from the global one.  This mirrors what makes real corpora clusterable:
frequent terms are everywhere, but mid-frequency terms concentrate by
topic — exactly the non-uniformity SeCluD's objective rewards.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["CorpusSpec", "Corpus", "synth_corpus", "corpus_stats"]


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    """Parameters of a synthetic corpus."""

    n_docs: int = 20_000
    n_terms: int = 50_000
    mean_doc_len: float = 120.0  # tokens, before set-dedup
    sigma_doc_len: float = 0.8  # log-normal sigma
    zipf_s: float = 1.07  # Zipf exponent of the global marginal
    n_topics: int = 32
    topicality: float = 0.6  # fraction of tokens drawn from the topic dist
    topic_boost: float = 40.0  # multiplicative boost of a topic's term block
    topic_block_lo: int = 64  # topical blocks cover ranks [lo, hi)
    topic_block_hi: Optional[int] = None  # default: n_terms // 2
    seed: int = 0

    # Named presets mirroring the paper's corpora (Table 1), scaled down.
    @staticmethod
    def gov2_like(n_docs: int = 20_000, seed: int = 0) -> "CorpusSpec":
        """Long documents, large vocabulary (GOV2: 652 terms/doc)."""
        return CorpusSpec(
            n_docs=n_docs,
            n_terms=60_000,
            mean_doc_len=300.0,
            sigma_doc_len=0.7,
            n_topics=48,
            topicality=0.55,
            seed=seed,
        )

    @staticmethod
    def gov2s_like(n_docs: int = 120_000, seed: int = 0) -> "CorpusSpec":
        """Sentence-granularity: many tiny documents (GOV2s: 18 terms/doc)."""
        return CorpusSpec(
            n_docs=n_docs,
            n_terms=40_000,
            mean_doc_len=14.0,
            sigma_doc_len=0.5,
            n_topics=48,
            topicality=0.6,
            seed=seed,
        )

    @staticmethod
    def wiki_like(n_docs: int = 30_000, seed: int = 0) -> "CorpusSpec":
        """Medium documents (Wikipedia: 230 terms/doc)."""
        return CorpusSpec(
            n_docs=n_docs,
            n_terms=50_000,
            mean_doc_len=150.0,
            sigma_doc_len=0.9,
            n_topics=64,
            topicality=0.5,
            seed=seed,
        )

    @staticmethod
    def forum_like(n_docs: int = 12_000, seed: int = 0) -> "CorpusSpec":
        """Small specialized corpus (pagenstecher.de: 36 terms/doc,
        narrow topic spread — the instance with the best speedups)."""
        return CorpusSpec(
            n_docs=n_docs,
            n_terms=12_000,
            mean_doc_len=30.0,
            sigma_doc_len=0.6,
            n_topics=16,
            topicality=0.75,
            topic_boost=80.0,
            seed=seed,
        )


@dataclasses.dataclass
class Corpus:
    """CSR set-of-terms corpus."""

    doc_ptr: np.ndarray  # (n_docs + 1,) int64
    doc_terms: np.ndarray  # (nnz,) int32, sorted unique within each doc
    n_terms: int
    doc_topic: Optional[np.ndarray] = None  # (n_docs,) ground-truth topics
    spec: Optional[CorpusSpec] = None

    @property
    def n_docs(self) -> int:
        return len(self.doc_ptr) - 1

    @property
    def nnz(self) -> int:
        return int(self.doc_ptr[-1])

    def doc(self, d: int) -> np.ndarray:
        return self.doc_terms[self.doc_ptr[d] : self.doc_ptr[d + 1]]

    def doc_lengths(self) -> np.ndarray:
        return np.diff(self.doc_ptr)

    def term_doc_freq(self) -> np.ndarray:
        """Document frequency df(t) for every term (posting-list lengths)."""
        return np.bincount(self.doc_terms, minlength=self.n_terms)

    def subset(self, doc_ids: np.ndarray) -> "Corpus":
        """Row-subset corpus (used by multilevel sampling & TopDown)."""
        doc_ids = np.asarray(doc_ids)
        lengths = np.diff(self.doc_ptr)[doc_ids]
        new_ptr = np.zeros(len(doc_ids) + 1, dtype=np.int64)
        np.cumsum(lengths, out=new_ptr[1:])
        new_terms = np.empty(int(new_ptr[-1]), dtype=self.doc_terms.dtype)
        for i, d in enumerate(doc_ids):
            new_terms[new_ptr[i] : new_ptr[i + 1]] = self.doc_terms[
                self.doc_ptr[d] : self.doc_ptr[d + 1]
            ]
        return Corpus(
            doc_ptr=new_ptr,
            doc_terms=new_terms,
            n_terms=self.n_terms,
            doc_topic=None if self.doc_topic is None else self.doc_topic[doc_ids],
            spec=self.spec,
        )


def _zipf_probs(n_terms: int, s: float) -> np.ndarray:
    ranks = np.arange(1, n_terms + 1, dtype=np.float64)
    p = ranks**-s
    return p / p.sum()


def synth_corpus(spec: CorpusSpec) -> Corpus:
    """Generate a synthetic corpus per the module docstring.

    Fully vectorized numpy; ~10M token draws per second per core.
    Deterministic in ``spec.seed``.
    """
    rng = np.random.default_rng(spec.seed)
    n, m = spec.n_docs, spec.n_terms

    base_p = _zipf_probs(m, spec.zipf_s)

    # Topic term-blocks over mid-frequency ranks.
    hi = spec.topic_block_hi if spec.topic_block_hi is not None else m // 2
    lo = min(spec.topic_block_lo, hi - 1)
    block = max(1, (hi - lo) // max(spec.n_topics, 1))
    topic_p = np.tile(base_p, (spec.n_topics, 1))
    for z in range(spec.n_topics):
        b0 = lo + z * block
        b1 = min(lo + (z + 1) * block, hi)
        topic_p[z, b0:b1] *= spec.topic_boost
    topic_p /= topic_p.sum(axis=1, keepdims=True)

    # Document lengths (token draws, pre-dedup) and topics.
    mu = np.log(spec.mean_doc_len) - 0.5 * spec.sigma_doc_len**2
    lengths = np.maximum(
        2, rng.lognormal(mean=mu, sigma=spec.sigma_doc_len, size=n).astype(np.int64)
    )
    doc_topic = rng.integers(0, spec.n_topics, size=n)

    # Vectorized sampling: one big draw, segmented by document.
    total = int(lengths.sum())
    tok_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=tok_ptr[1:])
    tok_doc = np.repeat(np.arange(n), lengths)

    from_topic = rng.random(total) < spec.topicality
    # Inverse-CDF sampling against per-topic CDFs.
    u = rng.random(total)
    base_cdf = np.cumsum(base_p)
    tokens = np.empty(total, dtype=np.int64)
    glob = ~from_topic
    tokens[glob] = np.searchsorted(base_cdf, u[glob], side="right")
    topic_cdf = np.cumsum(topic_p, axis=1)
    tok_topic = doc_topic[tok_doc]
    for z in range(spec.n_topics):  # n_topics CDF rows; loop is over topics only
        sel = from_topic & (tok_topic == z)
        if sel.any():
            tokens[sel] = np.searchsorted(topic_cdf[z], u[sel], side="right")
    np.clip(tokens, 0, m - 1, out=tokens)

    # Dedup within documents: sort (doc, term) pairs, drop repeats.
    key = tok_doc * np.int64(m) + tokens
    key = np.unique(key)  # sorted; unique (doc, term)
    out_doc = (key // m).astype(np.int64)
    out_term = (key % m).astype(np.int32)
    counts = np.bincount(out_doc, minlength=n)
    doc_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=doc_ptr[1:])

    return Corpus(
        doc_ptr=doc_ptr,
        doc_terms=out_term,
        n_terms=m,
        doc_topic=doc_topic,
        spec=spec,
    )


def corpus_stats(corpus: Corpus) -> dict:
    """Table-1-style statistics."""
    lengths = corpus.doc_lengths()
    df = corpus.term_doc_freq()
    return {
        "documents": corpus.n_docs,
        "terms": int((df > 0).sum()),
        "terms_per_document": float(lengths.mean()),
        "postings": corpus.nnz,
        "max_doc_len": int(lengths.max()),
        "max_posting_len": int(df.max()),
    }
