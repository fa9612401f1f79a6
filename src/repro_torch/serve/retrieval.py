"""RecSys retrieval with SeCluD conjunctive pre-filtering, the port of
``repro.serve.retrieval``.

The ``retrieval_cand`` serving shape scores 1 query against 10⁶
candidates.  In production the dense scoring is preceded by attribute
filters ("in stock AND category=X") — exactly the paper's SAP-HANA
motivation: the full-text/attribute filter must be EXACT because it is
one clause of a larger query.  Pipeline:

  1. candidate items carry sparse attribute sets → an inverted index;
  2. SeCluD clusters the candidates with the ψ objective using the
     serving query-log marginals (items = "documents", attributes =
     "terms");
  3. a conjunctive attribute filter runs through the cluster index
     (lossless, per the paper), on the host as in the reference;
  4. only surviving candidates get dense-scored by the model head.

The fit uploads the index to ``device`` as every fit of the port does
(``"cuda"`` by default, which raises without a GPU; ``"cpu"`` for the
plain path); the filter reads the host index.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.seclud import SecludPipeline, SecludResult
from repro_torch.data.corpus import Corpus
from repro_torch.data.query_log import QueryLog

__all__ = ["FilteredRetriever", "RetrievalReport", "items_as_corpus"]


def items_as_corpus(item_attrs: list[np.ndarray], n_attrs: int) -> Corpus:
    """Items with sparse attribute sets -> CSR 'corpus'."""
    lengths = np.asarray([len(a) for a in item_attrs], dtype=np.int64)
    ptr = np.zeros(len(item_attrs) + 1, dtype=np.int64)
    np.cumsum(lengths, out=ptr[1:])
    terms = (
        np.concatenate([np.sort(np.unique(a)) for a in item_attrs])
        if len(item_attrs)
        else np.zeros(0, np.int32)
    )
    return Corpus(doc_ptr=ptr, doc_terms=terms.astype(np.int32), n_terms=n_attrs)


@dataclasses.dataclass
class RetrievalReport:
    n_candidates: int
    n_filtered: int
    filter_work: float
    baseline_work: float

    @property
    def speedup(self) -> float:
        return self.baseline_work / max(self.filter_work, 1e-30)


class FilteredRetriever:
    """SeCluD-filtered dense retrieval."""

    def __init__(
        self,
        item_corpus: Corpus,
        k: int = 64,
        attr_log: Optional[QueryLog] = None,
        tc: int = 2_000,
        seed: int = 0,
        device=None,
    ):
        self.corpus = item_corpus
        self.pipe = SecludPipeline(tc=tc, doc_grained_below=512, seed=seed)
        self.res: SecludResult = self.pipe.fit(
            item_corpus, k=k, algo="topdown", log=attr_log, device=device
        )
        # old item id for each new (reordered) id
        self.new_to_old = np.empty(item_corpus.n_docs, dtype=np.int64)
        self.new_to_old[self.res.perm] = np.arange(item_corpus.n_docs)

    def filter(self, *attrs: int) -> Tuple[np.ndarray, RetrievalReport]:
        """Exact conjunctive filter: item ids having ALL the attributes
        ("in stock AND category=X AND brand=Y" is ``filter(s, x, y)``)."""
        from repro_torch.core.hier_index import _flatten_terms
        from repro_torch.index.lookup import chain_lookup

        terms = _flatten_terms(attrs)
        docs_new, work = self.res.cluster_index.query(*terms)
        # Baseline work: cost-ordered Lookup chain on the unclustered
        # randomized index (smallest list probes first).
        lists = [self.res.base_index.postings(int(a)) for a in terms]
        _, base_total = chain_lookup(
            lists, self.corpus.n_docs, self.pipe.bucket_size
        )
        if len(terms) == 1:
            # A single-attribute filter intersects nothing in either
            # system — both just emit the posting list.  Price both sides
            # as that read so speedup reports an honest 1.0x instead of
            # baseline_work=0 (which would render as "0.0x speedup").
            base_total = float(len(lists[0]))
            filter_work = float(len(docs_new))
        else:
            filter_work = work["total"]
        report = RetrievalReport(
            n_candidates=self.corpus.n_docs,
            n_filtered=len(docs_new),
            filter_work=filter_work,
            baseline_work=base_total,
        )
        return self.new_to_old[docs_new], report

    def retrieve(
        self,
        score_fn: Callable[[np.ndarray], object],
        *attrs: int,
        top_k: int = 10,
    ) -> Tuple[np.ndarray, np.ndarray, RetrievalReport]:
        """Filter on the attribute conjunction, then dense-score only the
        survivors; returns (item_ids, scores, report).
        ``score_fn(cand_ids) -> (B, N)``, a numpy array or a tensor (a
        model's ``score_candidates`` on the card: copied to the host)."""
        cand, report = self.filter(*attrs)
        if len(cand) == 0:
            return cand, np.zeros((0,)), report
        scores = score_fn(cand.astype(np.int32))
        if isinstance(scores, torch.Tensor):
            scores = scores.detach().cpu().numpy()
        scores = np.asarray(scores)[0]
        k = min(top_k, len(cand))
        top = np.argpartition(-scores, k - 1)[:k]
        top = top[np.argsort(-scores[top])]
        return cand[top], scores[top], report
