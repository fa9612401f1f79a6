"""Flat K-means on the ψ objective (paper §3.2).

Two update modes, exactly as the paper:

* **round-based** — each iteration rebuilds the δ⁺ tables once, scores all
  documents with one SpMM, and reassigns every document simultaneously.
  One iteration is O(kN).  Iterates "as long as the objective improves by
  at least 1 %" (paper §4).

* **document-grained** — for small |D| (the paper switches below 100k
  documents at its 25M-document scale; the cutoff is a parameter here,
  default scaled to our corpus sizes) documents are visited one at a time
  and the objective state (counts + affected tables) is updated after
  *every* move: remove d from its cluster (δ⁻), add to the best (δ⁺).
  This kills the oscillations the round-based scheme suffers on small
  cluster sizes.

Beyond-paper robustness (noted in DESIGN.md): empty clusters are reseeded
with the documents that fit their current cluster worst; the paper leaves
empties unspecified.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.objective import (
    FrequentTermView,
    assignment_scores,
    cluster_counts,
    delta_add_tables,
    delta_remove_tables,
    psi_from_counts,
)

__all__ = ["KMeansResult", "kmeans", "document_grained_pass"]


@dataclasses.dataclass
class KMeansResult:
    assign: np.ndarray  # (n_docs,) int64 in [0, k)
    psi: float
    n_iters: int
    psi_history: list


def _reseed_empty(
    assign: np.ndarray, scores: np.ndarray, k: int, rng: np.random.Generator
) -> np.ndarray:
    """Move the worst-fitting documents into empty clusters."""
    sizes = np.bincount(assign, minlength=k)
    empty = np.flatnonzero(sizes == 0)
    if len(empty) == 0:
        return assign
    # Documents whose current-cluster fit is worst (largest own-δ).
    own = scores[np.arange(len(assign)), assign]
    donors = np.argsort(-own)
    used = 0
    for j in empty:
        # Skip donors that would empty their own cluster.
        while used < len(donors) and sizes[assign[donors[used]]] <= 1:
            used += 1
        if used >= len(donors):
            break
        d = donors[used]
        sizes[assign[d]] -= 1
        assign[d] = j
        sizes[j] += 1
        used += 1
    return assign


def kmeans(
    view: FrequentTermView,
    k: int,
    init_assign: Optional[np.ndarray] = None,
    max_iters: int = 100,
    min_rel_improvement: float = 0.01,
    doc_grained_below: int = 2_048,
    seed: int = 0,
) -> KMeansResult:
    """Cluster ``view`` into k clusters minimizing ψ.

    ``init_assign=None`` → random balanced init. Switches to the
    document-grained mode when |D| < ``doc_grained_below`` (paper §3.2).
    """
    rng = np.random.default_rng(seed)
    n = view.n_docs
    if init_assign is None:
        init_assign = rng.permutation(n) % k
    assign = np.asarray(init_assign, dtype=np.int64).copy()

    if n < doc_grained_below:
        return document_grained_pass(
            view, k, assign, max_passes=max_iters, rng=rng,
            min_rel_improvement=min_rel_improvement,
        )

    history = []
    counts = cluster_counts(view, assign, k)
    psi = psi_from_counts(counts, view.p_freq)
    history.append(psi)
    _it = 0
    for _it in range(1, max_iters + 1):
        tables = delta_add_tables(counts, view.p_freq)
        scores = assignment_scores(view, tables)  # (n, k)
        new_assign = np.argmin(scores, axis=1)
        new_assign = _reseed_empty(new_assign, scores, k, rng)
        counts_new = cluster_counts(view, new_assign, k)
        psi_new = psi_from_counts(counts_new, view.p_freq)
        history.append(psi_new)
        if psi_new < psi * (1.0 - 1e-12):
            improved = (psi - psi_new) / max(psi, 1e-30)
            assign, counts, psi = new_assign, counts_new, psi_new
            if improved < min_rel_improvement:
                break
        else:
            break  # no improvement: keep previous assignment
    return KMeansResult(assign=assign, psi=psi, n_iters=_it, psi_history=history)


def document_grained_pass(
    view: FrequentTermView,
    k: int,
    assign: np.ndarray,
    max_passes: int = 20,
    min_rel_improvement: float = 0.01,
    rng: Optional[np.random.Generator] = None,
    table_refresh: int = 1,
) -> KMeansResult:
    """Document-grained K-means: objective state updated after every move.

    Exact bookkeeping: counts are updated per move; the δ tables of the two
    affected clusters are rebuilt every ``table_refresh`` moves (=1 → fully
    exact, the paper's description; >1 → the paper-§6 "compromise"
    between round-based and document-wise updates).
    """
    rng = rng or np.random.default_rng(0)
    n = view.n_docs
    assign = np.asarray(assign, dtype=np.int64).copy()
    counts = cluster_counts(view, assign, k)
    p = view.p_freq
    mat = view.mat  # CSR: rows are documents, values P[rank]

    add_t = delta_add_tables(counts, p)
    rem_t = delta_remove_tables(counts, p)
    psi = psi_from_counts(counts, p)
    history = [psi]
    stale = np.zeros(k, dtype=bool)
    moves_since_refresh = 0

    indptr, indices, data = mat.indptr, mat.indices, mat.data
    _npass = 0
    for _npass in range(1, max_passes + 1):
        moved = 0
        for d in rng.permutation(n):
            lo, hi = indptr[d], indptr[d + 1]
            ranks = indices[lo:hi]
            pvals = data[lo:hi]  # already P[rank]
            if len(ranks) == 0:
                continue
            cur = assign[d]
            if stale.any() and moves_since_refresh >= table_refresh:
                for j in np.flatnonzero(stale):
                    add_t[j] = delta_add_tables(counts[j : j + 1], p)[0]
                    rem_t[j] = delta_remove_tables(counts[j : j + 1], p)[0]
                stale[:] = False
                moves_since_refresh = 0
            # Gain of removing d from cur; cost of adding to each j.
            add_scores = pvals @ add_t[:, ranks].T  # (k,)
            remove_gain = float(pvals @ rem_t[cur, ranks])
            # Moving d from cur to j≠cur changes ψ by add(j) − remove(cur);
            # staying costs 0.
            dpsi = add_scores - remove_gain
            dpsi[cur] = 0.0
            best = int(np.argmin(dpsi))
            if best != cur and dpsi[best] < -1e-15:
                counts[cur, ranks] -= 1
                counts[best, ranks] += 1
                assign[d] = best
                stale[cur] = stale[best] = True
                moves_since_refresh += 1
                moved += 1
        psi_new = psi_from_counts(counts, p)
        history.append(psi_new)
        rel = (psi - psi_new) / max(psi, 1e-30)
        psi = psi_new
        # Refresh all tables between passes.
        add_t = delta_add_tables(counts, p)
        rem_t = delta_remove_tables(counts, p)
        stale[:] = False
        moves_since_refresh = 0
        if moved == 0 or rel < min_rel_improvement:
            break
    return KMeansResult(assign=assign, psi=psi, n_iters=_npass, psi_history=history)
