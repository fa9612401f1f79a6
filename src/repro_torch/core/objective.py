"""The SeCluD objective ψ and its incremental δ lookup tables (paper §3.1–3.2).

For a clustering C with per-cluster term counts ``n_i(t)`` and independent
query-term marginals P[t], the expected conjunctive-query cost is

    ψ(C) = Σ_{t<u} P[t]·P[u] · Σ_i min(n_i(t), n_i(u))          (Eq. 2)

The marginal cost of ADDING a document containing term t to cluster j is

    δ_j⁺(t) = P[t] · Σ_{u≠t, n_j(t) < n_j(u)} P[u]

(only pairs where t is the *strictly smaller* list get more expensive), and
of REMOVING it

    δ_j⁻(t) = −P[t] · Σ_{u≠t, n_j(t) ≤ n_j(u)} P[u]

(the min shrinks whenever t's list is the smaller-or-equal one).  Both are
O(1) per (cluster, term) after building a lookup table: sort the cluster's
counts, suffix-sum the P's in sorted order, and map each term through a
``searchsorted`` on its own count (this also handles ties *exactly* — the
paper's "n_j(t) < n_j(u)" is strict).

Everything here is restricted to the TC most frequent terms (paper §3.2
"Ignoring Infrequent Terms"): rare terms contribute negligibly to query
cost but dominate the vocabulary.

Implementation notes: numpy + scipy.sparse on the host (the clustering
driver is recursion-heavy and runs on CPU; zero-compile vectorized numpy is
the right tool).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from repro_torch.data.corpus import Corpus

__all__ = [
    "FrequentTermView",
    "frequent_term_view",
    "cluster_counts",
    "psi_from_counts",
    "delta_add_tables",
    "delta_remove_tables",
    "assignment_scores",
    "query_set_cost",
    "hier_query_set_cost",
]


@dataclasses.dataclass
class FrequentTermView:
    """A corpus restricted to its TC most frequent terms.

    * ``edge_doc`` / ``edge_rank`` — COO edges (document, frequent-term
      rank); rank ∈ [0, TC).
    * ``p_freq``  — P[t] for the frequent terms, in rank order.
    * ``rank_of_term`` — n_terms array, −1 for infrequent terms.
    * ``term_of_rank`` — TC array of original term ids.
    * ``mat`` — CSR (n_docs × TC) with values P[rank] (the SpMM operand:
      scores = mat @ tablesᵀ).
    """

    edge_doc: np.ndarray
    edge_rank: np.ndarray
    p_freq: np.ndarray
    rank_of_term: np.ndarray
    term_of_rank: np.ndarray
    mat: sp.csr_matrix
    n_docs: int

    @property
    def tc(self) -> int:
        return len(self.term_of_rank)

    def subset(self, doc_ids: np.ndarray) -> "FrequentTermView":
        """Row-subset view (multilevel sampling / TopDown recursion).

        Keeps the global rank space and P so tables remain comparable.
        """
        doc_ids = np.asarray(doc_ids)
        sub = self.mat[doc_ids]
        coo = sub.tocoo()
        return FrequentTermView(
            edge_doc=coo.row.astype(np.int64),
            edge_rank=coo.col.astype(np.int32),
            p_freq=self.p_freq,
            rank_of_term=self.rank_of_term,
            term_of_rank=self.term_of_rank,
            mat=sub.tocsr(),
            n_docs=len(doc_ids),
        )


def frequent_term_view(
    corpus: Corpus, p: np.ndarray, tc: int = 10_000
) -> FrequentTermView:
    """Restrict a corpus to its ``tc`` highest-P terms (§3.2).

    The paper selects by frequency; selecting by P[t] is equivalent when P
    is estimated from frequencies and strictly better when P comes from a
    query log (we care about *query* cost). Ties broken by term id.
    """
    m = corpus.n_terms
    tc = min(tc, m)
    top = np.argpartition(-p, tc - 1)[:tc] if tc < m else np.arange(m)
    top = top[np.argsort(-p[top], kind="stable")]
    rank_of_term = np.full(m, -1, dtype=np.int32)
    rank_of_term[top] = np.arange(tc, dtype=np.int32)

    ranks_all = rank_of_term[corpus.doc_terms]
    keep = ranks_all >= 0
    edge_rank = ranks_all[keep].astype(np.int32)
    edge_doc = np.repeat(
        np.arange(corpus.n_docs, dtype=np.int64), np.diff(corpus.doc_ptr)
    )[keep]
    p_freq = p[top].astype(np.float64)

    mat = sp.csr_matrix(
        (p_freq[edge_rank], (edge_doc, edge_rank)),
        shape=(corpus.n_docs, tc),
        dtype=np.float64,
    )
    return FrequentTermView(
        edge_doc=edge_doc,
        edge_rank=edge_rank,
        p_freq=p_freq,
        rank_of_term=rank_of_term,
        term_of_rank=top.astype(np.int32),
        mat=mat,
        n_docs=corpus.n_docs,
    )


def cluster_counts(view: FrequentTermView, assign: np.ndarray, k: int) -> np.ndarray:
    """n_j(t): (k, TC) int64 — documents of cluster j containing rank-t term."""
    key = assign[view.edge_doc].astype(np.int64) * view.tc + view.edge_rank
    return np.bincount(key, minlength=k * view.tc).reshape(k, view.tc)


def psi_from_counts(counts: np.ndarray, p_freq: np.ndarray) -> float:
    """ψ = Σ_i Σ_{t<u} P_t P_u min(n_i(t), n_i(u)), exactly, in O(k·TC·log TC).

    Per cluster: sort terms by count ascending; then min(n_t, n_u) for any
    pair is the count of the earlier-sorted one (ties give the same value
    either way), so ψ_i = Σ_j P_(j) · n_(j) · (Σ_{l>j} P_(l)).
    """
    counts = np.asarray(counts)
    order = np.argsort(counts, axis=1, kind="stable")
    n_sorted = np.take_along_axis(counts, order, axis=1).astype(np.float64)
    p_sorted = p_freq[order]
    # suffix[l] = sum of p_sorted[l+1:]
    suffix = np.cumsum(p_sorted[:, ::-1], axis=1)[:, ::-1]
    suffix = np.concatenate([suffix[:, 1:], np.zeros((len(counts), 1))], axis=1)
    return float((p_sorted * n_sorted * suffix).sum())


def _sorted_tables(
    counts: np.ndarray, p_freq: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-cluster (sorted counts, suffix-P) — shared by δ⁺ and δ⁻."""
    order = np.argsort(counts, axis=1, kind="stable")
    n_sorted = np.take_along_axis(counts, order, axis=1)
    p_sorted = p_freq[order]
    # suffix_incl[l] = sum of p_sorted[l:]
    suffix_incl = np.cumsum(p_sorted[:, ::-1], axis=1)[:, ::-1]
    return n_sorted, suffix_incl


def delta_add_tables(counts: np.ndarray, p_freq: np.ndarray) -> np.ndarray:
    """S⁺[j, t] = Σ_{u: n_j(u) > n_j(t)} P_u  (strict; excludes u = t).

    δ_j⁺(t) = P[t]·S⁺[j, t]; δ_j⁺(d) = Σ_{t∈d} δ_j⁺(t) = (view.mat @ S⁺ᵀ)[d, j].
    """
    counts = np.asarray(counts)
    k, tc = counts.shape
    n_sorted, suffix_incl = _sorted_tables(counts, p_freq)
    out = np.empty((k, tc), dtype=np.float64)
    pad = np.zeros(1)
    for j in range(k):  # k rows; each row one vectorized searchsorted
        idx = np.searchsorted(n_sorted[j], counts[j], side="right")
        suf = np.concatenate([suffix_incl[j], pad])
        out[j] = suf[idx]
    return out


def delta_remove_tables(counts: np.ndarray, p_freq: np.ndarray) -> np.ndarray:
    """S⁻[j, t] = Σ_{u≠t: n_j(u) ≥ n_j(t)} P_u  (paper §6: removal matters
    for small clusters; used by the document-grained update mode)."""
    counts = np.asarray(counts)
    k, tc = counts.shape
    n_sorted, suffix_incl = _sorted_tables(counts, p_freq)
    out = np.empty((k, tc), dtype=np.float64)
    pad = np.zeros(1)
    for j in range(k):
        idx = np.searchsorted(n_sorted[j], counts[j], side="left")
        suf = np.concatenate([suffix_incl[j], pad])
        out[j] = suf[idx] - p_freq  # drop u = t (its count ≥ itself)
    return out


def assignment_scores(view: FrequentTermView, tables: np.ndarray) -> np.ndarray:
    """(n_docs, k) δ⁺ scores: one sparse-dense matmul (the SpMM hot loop
    of the clustering)."""
    return np.asarray(view.mat @ tables.T)


def _queried_term_edges(
    corpus: Corpus, terms: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """(term rank, doc id) of every corpus edge touching a queried term —
    the O(nnz) selection scan, hoisted so multi-level pricing pays it
    once (FULL term counts, not the TC-restricted view — queries hit
    rare terms too)."""
    sel = np.isin(corpus.doc_terms, terms)
    e_rank = np.searchsorted(terms, corpus.doc_terms[sel]).astype(np.int64)
    e_doc = np.repeat(
        np.arange(corpus.n_docs, dtype=np.int64), np.diff(corpus.doc_ptr)
    )[sel]
    return e_rank, e_doc


def _counts_from_edges(
    e_rank: np.ndarray,
    e_doc: np.ndarray,
    assign: np.ndarray,
    k: int,
    n_sel_terms: int,
) -> np.ndarray:
    """(n_sel_terms, k) per-cluster counts from pre-selected edges."""
    return np.bincount(
        e_rank * k + assign[e_doc], minlength=n_sel_terms * k
    ).reshape(n_sel_terms, k)


def _chain_cost(c: np.ndarray, q_ptr: np.ndarray, arities: np.ndarray, model: str) -> float:
    """Σ_q Σ_i Σ_{s ≠ argmin} Φ(min_j c[j, i], c[s, i]) for per-slot cost
    rows ``c`` ((nnz, k); pass (nnz, 1) for a scalar-per-term model).

    The smallest list is the running probe side of the cost-ordered plan
    and Φ prices each of the a−1 pairwise reductions: the min slot's
    Φ(x, x) cancels, leaving one Φ per actual chain stage.  Single-term
    queries cost 0 (no intersection happens).
    """
    from repro_torch.index.intersect import pair_cost

    n_q = len(q_ptr) - 1
    if n_q == 0:
        return 0.0
    x = np.minimum.reduceat(c, q_ptr[:-1], axis=0)  # (nq, k)
    qid = np.repeat(np.arange(n_q), arities)
    return float(pair_cost(x[qid], c, model).sum() - pair_cost(x, x, model).sum())


def query_set_cost(
    corpus: Corpus,
    assign: Optional[np.ndarray],
    k: int,
    queries,
    model: str = "lookup",
) -> float:
    """Theoretical per-cluster cost of an explicit conjunctive query set.

    For a query with per-cluster term counts (c_1, ..., c_a) the chain
    cost in cluster i is modeled as Σ_{s ≠ argmin} Φ(min_j c_j, c_s): the
    smallest list is the running probe side of the cost-ordered plan and
    Φ prices each of the a−1 pairwise reductions.  For 2-term queries
    this is exactly the paper's Σ_q Σ_i Φ(n_i(t_q), n_i(u_q)) (Eq. 2 on
    the query set); single-term queries cost 0 (no intersection happens).

    ``assign=None`` means the unclustered baseline (k = 1).  Used for the
    theoretical speedup S_T on held-out query logs.  ``queries`` is any
    form ``repro_torch.core.queries.as_queries`` accepts.  This prices the
    *posting* level only — :func:`hier_query_set_cost` prices the full
    descent of a multi-level index.
    """
    from repro_torch.core.queries import as_queries

    cq = as_queries(queries)
    terms = np.unique(cq.q_terms)
    rows = np.searchsorted(terms, cq.q_terms)  # (nnz,) rank of each slot

    if assign is None:
        assign = np.zeros(corpus.n_docs, dtype=np.int64)
        k = 1
    e_rank, e_doc = _queried_term_edges(corpus, terms)
    cnt = _counts_from_edges(e_rank, e_doc, assign, k, len(terms))
    if cq.n_queries == 0:
        return 0.0
    return _chain_cost(cnt[rows], cq.q_ptr, cq.arities, model)


def hier_query_set_cost(
    corpus: Corpus,
    level_assigns,
    level_ks,
    queries,
    model: str = "lookup",
) -> dict:
    """Theoretical cost of the FULL L-level descent for a query set.

    ``level_assigns``/``level_ks`` run coarse -> fine over the cluster
    levels (empty for the flat L = 1 index): each level-l chain over the
    terms' node lists is priced with the per-term node-presence counts
    c_l(t) = #{level-l nodes containing t} — the lists the descent
    actually intersects — and the leaf posting chain is priced per
    cluster exactly as :func:`query_set_cost`.

    Returns ``{"level_0": ..., ..., "postings": ..., "total": ...}``.
    Eq. 2 is recovered at L = 2: the ``postings`` component equals
    ``query_set_cost(corpus, leaf_assign, leaf_k, queries)`` exactly (and
    at L = 1 the whole dict degenerates to the unclustered baseline).
    """
    from repro_torch.core.queries import as_queries

    cq = as_queries(queries)
    level_assigns = list(level_assigns)
    level_ks = [int(x) for x in level_ks]
    if len(level_assigns) != len(level_ks):
        raise ValueError("level_assigns and level_ks must align")
    out = {f"level_{li}": 0.0 for li in range(len(level_assigns))}
    if cq.n_queries == 0:
        out["postings"] = 0.0
        out["total"] = 0.0
        return out
    terms = np.unique(cq.q_terms)
    rows = np.searchsorted(terms, cq.q_terms)
    # One O(nnz) corpus scan for the whole descent: only the assignment
    # (a bincount) changes between levels.
    e_rank, e_doc = _queried_term_edges(corpus, terms)
    leaf_assign = (
        level_assigns[-1]
        if level_assigns
        else np.zeros(corpus.n_docs, dtype=np.int64)
    )
    leaf_k = level_ks[-1] if level_ks else 1
    cnt_leaf = _counts_from_edges(e_rank, e_doc, leaf_assign, leaf_k, len(terms))
    leaf = _chain_cost(cnt_leaf[rows], cq.q_ptr, cq.arities, model)
    out["postings"] = leaf
    total = leaf
    for li, (assign, kl) in enumerate(zip(level_assigns, level_ks, strict=True)):
        if li == len(level_assigns) - 1:
            cnt = cnt_leaf  # the leaf counts were just computed
        else:
            cnt = _counts_from_edges(e_rank, e_doc, assign, kl, len(terms))
        presence = (cnt > 0).sum(axis=1).astype(np.float64)  # node-list lengths
        cost_l = _chain_cost(presence[rows][:, None], cq.q_ptr, cq.arities, model)
        out[f"level_{li}"] = cost_l
        total += cost_l
    out["total"] = total
    return out
