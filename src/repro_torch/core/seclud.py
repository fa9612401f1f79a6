"""SecludPipeline — the end-to-end public API of the paper's system.

fit():   estimate P → frequent-term view → cluster (flat-multilevel "FM"
         or TopDown "TD") → recursively cluster the clusters for
         ``levels`` > 2 → nested reorder → build the cluster index and
         the L-level :class:`repro_torch.core.hier_index.HierIndex`.
evaluate(): the paper's three speedups against the unclustered baseline
         (which, per [14], uses a *random* document permutation):

  * S_T — theoretical, from the ψ cost model (Eq. 2) evaluated on the
          actual query set;
  * S_C — measured work of the two-level cluster-index query;
  * S_R — measured work of the single-index Lookup query on the
          cluster-contiguously *reordered* index;
  * S_H — measured work of the L-level hierarchical descent (reported
          when ``fit(levels=L)`` built a depth other than 2, where it
          would equal S_C).

Every query algorithm returns the exact same result set (losslessness is
asserted, modulo the id permutation) — the paper's defining property, at
every depth.
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cluster_index import ClusterIndex, build_cluster_index
from repro_torch.core.hier_index import HierIndex, HierLevel, build_hier_index
from repro_torch.core.multilevel import multilevel_cluster
from repro_torch.core.objective import (
    FrequentTermView,
    cluster_counts,
    frequent_term_view,
    hier_query_set_cost,
    psi_from_counts,
    query_set_cost,
)
from repro_torch.core.queries import as_queries
from repro_torch.core.reorder import cluster_ranges, reorder_permutation
from repro_torch.core.topdown import topdown_cluster
from repro_torch.data.corpus import Corpus
from repro_torch.index.build import InvertedIndex, build_index, permute_docs
from repro_torch.index.lookup import chain_lookup

if TYPE_CHECKING:  # deferred: repro_torch.data.query_log itself imports
    from repro_torch.data.query_log import QueryLog  # repro_torch.core.queries

__all__ = ["SecludPipeline", "SecludResult", "result_from_arrays"]


@dataclasses.dataclass
class SecludResult:
    assign: np.ndarray
    k: int
    perm: np.ndarray  # old doc id -> new doc id (cluster-contiguous)
    ranges: np.ndarray  # (k+1,) cluster boundaries in new id space
    psi: float
    psi_single: float
    cluster_time_s: float
    view: FrequentTermView
    base_index: InvertedIndex  # randomized ids (the [14] baseline)
    base_perm: np.ndarray
    reordered_index: InvertedIndex
    cluster_index: ClusterIndex
    # -- hierarchy (levels = 2 unless fit(levels=L) said otherwise) ------
    levels: int = 2
    level_ranges: Tuple[np.ndarray, ...] = ()  # coarse -> fine, L-1 arrays
    level_assigns: Tuple[np.ndarray, ...] = ()  # doc -> node id per level
    psi_levels: Tuple[float, ...] = ()  # ψ priced at each cluster level
    hier_index: Optional[HierIndex] = None
    # Upload-once device mirror of hier_index (repro_torch.core.device_engine),
    # built by fit() so serving never pays the upload per batch.
    device_index: Optional[object] = None

    @property
    def s_t(self) -> float:
        """Theoretical speedup from ψ itself (frequent terms, Eq. 2)."""
        return self.psi_single / max(self.psi, 1e-30)

    def shard_slices(self, n_shards: int):
        """Host views of the fitted index, one per corpus shard — the
        partitioning a multi-machine deployment hands each machine.

        Shards are contiguous groups of top-level clusters balanced by
        posting mass (``repro_torch.core.hier_index.shard_tops``); each view is
        the fitted :class:`HierIndex` restricted to its group
        (``slice_top``), sharing the underlying postings.  Returns
        ``(bounds, views)`` with ``bounds`` the ``(n_shards + 1,)``
        top-node boundaries and ``views`` the per-shard indexes.
        """
        from repro_torch.core.hier_index import as_hier, shard_tops

        hidx = as_hier(
            self.hier_index
            if self.hier_index is not None
            else self.cluster_index
        )
        bounds = shard_tops(hidx, n_shards)
        views = [
            hidx.slice_top(int(lo), int(hi))
            for lo, hi in zip(bounds[:-1], bounds[1:], strict=True)
        ]
        return bounds, views


def _corpus_of_clusters(corpus: Corpus, assign: np.ndarray, k: int) -> Corpus:
    """The corpus whose "documents" are clusters: cluster j's term set is
    the union of its members' terms — presence, not counts, because the
    upper-level node lists the descent intersects are presence lists."""
    e_doc = np.repeat(
        np.arange(corpus.n_docs, dtype=np.int64), np.diff(corpus.doc_ptr)
    )
    key = assign[e_doc].astype(np.int64) * corpus.n_terms + corpus.doc_terms
    u = np.unique(key)
    cl = u // corpus.n_terms
    terms = (u % corpus.n_terms).astype(np.int32)
    ptr = np.zeros(k + 1, dtype=np.int64)
    np.add.at(ptr, cl + 1, 1)
    np.cumsum(ptr, out=ptr)
    return Corpus(doc_ptr=ptr, doc_terms=terms, n_terms=corpus.n_terms)


def _nest_level_assigns(raw_assigns):
    """Renumber raw per-level doc assignments (coarse -> fine) so node
    ids are nested and contiguous: sort documents by the level tuple, cut
    each level where its (coarser..self) prefix changes.  Empty nodes
    vanish; the finest renumbered assignment alone sorts documents into
    the hierarchy order (ties keep original doc order, so
    ``reorder_permutation`` of it IS the nested permutation)."""
    n = len(raw_assigns[-1])
    order = np.lexsort(tuple(reversed(raw_assigns)))
    level_assigns, level_ranges = [], []
    change = np.zeros(n, dtype=bool)
    if n:
        change[0] = True
    for raw in raw_assigns:
        col = raw[order]
        change = change.copy()
        if n > 1:
            change[1:] |= col[1:] != col[:-1]
        ids_sorted = np.cumsum(change) - 1
        new_a = np.empty(n, dtype=np.int64)
        new_a[order] = ids_sorted
        level_assigns.append(new_a)
        level_ranges.append(
            np.append(np.flatnonzero(change), n).astype(np.int64)
        )
    return level_assigns, level_ranges


class SecludPipeline:
    def __init__(
        self,
        tc: int = 10_000,
        bucket_size: int = 16,
        bucket_size_clusters: int = 8,
        eps: float = 0.1,
        chi: int = 8,
        doc_grained_below: int = 2_048,
        min_rel_improvement: float = 0.01,
        seed: int = 0,
    ):
        self.tc = tc
        self.bucket_size = bucket_size
        self.bucket_size_clusters = bucket_size_clusters
        self.eps = eps
        self.chi = chi
        self.doc_grained_below = doc_grained_below
        self.min_rel_improvement = min_rel_improvement
        self.seed = seed

    # ------------------------------------------------------------------

    def fit(
        self,
        corpus: Corpus,
        k: int,
        algo: str = "topdown",
        log: Optional[QueryLog] = None,
        p: Optional[np.ndarray] = None,
        levels: int = 2,
        level_ks: Optional[Sequence[int]] = None,
        device=None,
    ) -> SecludResult:
        """Cluster, reorder and index the corpus at depth ``levels``.

        ``levels = 2`` (default) is the paper's pipeline, bit-for-bit.
        ``levels = 1`` skips clustering entirely — the flat single-index
        Lookup baseline as a degenerate hierarchy.  ``levels >= 3``
        recursively clusters the clusters: the leaf clustering runs as
        usual, then each upper level clusters a corpus whose "documents"
        are the level below's clusters (term-presence sets), targeting
        ``level_ks`` (coarse -> fine, ``levels - 2`` values; default: the
        geometric ladder round(k^((i+1)/(L-1)))).  Document ids are
        renumbered so every level's nodes own nested contiguous ranges,
        and the result carries the L-level ``hier_index`` next to the
        historical two-level ``cluster_index`` (both exact).

        The fitted index is uploaded to ``device`` (default ``"cuda"``,
        which raises when no GPU is present; ``"cpu"`` for the plain
        path).  The clustering itself is host numpy.
        """
        if levels < 1:
            raise ValueError(f"levels must be >= 1, got {levels}")
        from repro_torch.core.device_engine import resolve_device

        device = resolve_device(device)  # fail before the fit, not after
        if p is None:
            from repro_torch.data.query_log import term_probabilities

            p = term_probabilities(corpus.n_terms, log=log, corpus=corpus)
        view = frequent_term_view(corpus, p, tc=self.tc)

        t0 = time.perf_counter()
        if levels == 1:
            assign, k_actual = np.zeros(corpus.n_docs, dtype=np.int64), 1
        elif algo in ("flat", "fm"):
            res = multilevel_cluster(
                view,
                k,
                eps=self.eps,
                doc_grained_below=self.doc_grained_below,
                min_rel_improvement=self.min_rel_improvement,
                seed=self.seed,
            )
            assign, k_actual = res.assign, k
        elif algo in ("topdown", "td"):
            res = topdown_cluster(
                view,
                k,
                chi=self.chi,
                eps=self.eps,
                doc_grained_below=self.doc_grained_below,
                min_rel_improvement=self.min_rel_improvement,
                seed=self.seed,
            )
            assign, k_actual = res.assign, res.k_actual
        else:
            raise ValueError(f"unknown algo {algo!r}")

        if levels <= 2:
            level_assigns = [assign] if levels == 2 else []
        else:
            level_assigns = self._cluster_the_clusters(
                corpus, p, assign, k_actual, levels, level_ks
            )
        cluster_time = time.perf_counter() - t0

        if levels >= 3:
            # Renumber node ids per level so children of every node are
            # contiguous (nested ranges); the leaf renumbering replaces
            # `assign` and sorting by it alone reorders the documents.
            level_assigns, level_ranges = _nest_level_assigns(level_assigns)
            assign = level_assigns[-1]
            k_actual = len(level_ranges[-1]) - 1

        counts = cluster_counts(view, assign, k_actual)
        psi = psi_from_counts(counts, view.p_freq)
        psi_single = psi_from_counts(
            counts.sum(axis=0, keepdims=True), view.p_freq
        )

        index = build_index(corpus)
        rng = np.random.default_rng(self.seed + 7)
        base_perm = rng.permutation(corpus.n_docs)
        base_index = permute_docs(index, base_perm)

        perm = reorder_permutation(assign, k_actual)
        ranges = cluster_ranges(assign, k_actual)
        if levels <= 2:
            level_ranges = [ranges] if levels == 2 else []
        reordered = permute_docs(index, perm)
        cidx = build_cluster_index(
            reordered,
            ranges,
            bucket_size_clusters=self.bucket_size_clusters,
            bucket_size_postings=self.bucket_size,
        )
        hier = build_hier_index(
            reordered,
            level_ranges,
            bucket_size_clusters=self.bucket_size_clusters,
            bucket_size_postings=self.bucket_size,
        )
        if levels == 2:
            # The two-level facade's cached hier view IS this index:
            # share one object so the device upload is shared too.
            cidx.__dict__["_hier"] = hier
        psi_levels = tuple(
            psi_from_counts(
                cluster_counts(view, a, len(r) - 1), view.p_freq
            )
            for a, r in zip(level_assigns, level_ranges, strict=True)
        )
        # Upload the index once, now: every device batch (SearchService,
        # batched_counts) reuses this resident copy.
        from repro_torch.core.device_engine import device_index as _build_device_index

        dev = _build_device_index(hier, device)
        return SecludResult(
            assign=assign,
            k=k_actual,
            perm=perm,
            ranges=ranges,
            psi=psi,
            psi_single=psi_single,
            cluster_time_s=cluster_time,
            view=view,
            base_index=base_index,
            base_perm=base_perm,
            reordered_index=reordered,
            cluster_index=cidx,
            levels=levels,
            level_ranges=tuple(level_ranges),
            level_assigns=tuple(level_assigns),
            psi_levels=psi_levels,
            hier_index=hier,
            device_index=dev,
        )

    def _cluster_the_clusters(
        self,
        corpus: Corpus,
        p: np.ndarray,
        assign: np.ndarray,
        k_actual: int,
        levels: int,
        level_ks: Optional[Sequence[int]],
    ):
        """Raw (un-renumbered) doc-level assignments for every cluster
        level, coarse -> fine, by recursively clustering the clusters."""
        if level_ks is not None:
            upper_ks = [int(x) for x in level_ks]
            if len(upper_ks) != levels - 2:
                raise ValueError(
                    f"level_ks needs {levels - 2} entries (coarse -> fine "
                    f"above the leaf), got {len(upper_ks)}"
                )
        else:
            upper_ks = [
                max(2, int(round(k_actual ** ((i + 1) / (levels - 1)))))
                for i in range(levels - 2)
            ]
        level_assigns = [assign]
        cur, k_cur = assign, k_actual
        for depth_up, k_up in enumerate(reversed(upper_ks)):
            k_up = min(k_up, k_cur)
            cl_corpus = _corpus_of_clusters(corpus, cur, k_cur)
            view_up = frequent_term_view(cl_corpus, p, tc=self.tc)
            up = multilevel_cluster(
                view_up,
                k_up,
                eps=self.eps,
                doc_grained_below=self.doc_grained_below,
                min_rel_improvement=self.min_rel_improvement,
                seed=self.seed + 101 * (depth_up + 1),
            ).assign
            cur = up[cur]
            k_cur = k_up
            level_assigns.insert(0, cur)
        return level_assigns

    # ------------------------------------------------------------------

    def evaluate(
        self,
        corpus: Corpus,
        result: SecludResult,
        log: QueryLog,
        check_lossless: bool = True,
        max_queries: Optional[int] = None,
        cost_model: str = "lookup",
        batched: bool = False,
    ) -> Dict[str, float]:
        """Work-metric speedups S_T / S_C / S_R over the query log.

        Queries may be any arity >= 1 (``log.queries`` is the padded
        rectangular form; ragged rows carry ``QUERY_PAD``).  The baseline
        and S_R paths chain the single-index Lookup smallest-list-first;
        S_C runs the cost-ordered two-level query.

        ``batched=True`` runs the vectorized engine
        (``repro_torch.core.batched_query``) instead of the per-query Python
        loop: identical work dict (the engine is bit-exact), plus
        wall-clock timings ``t_baseline_s`` / ``t_cluster_index_s`` /
        ``t_reordered_s``.

        When the result was fit at a depth other than 2 the report adds
        the hierarchical descent: ``S_H`` / ``work_hier`` (measured, also
        lossless-checked), ``depth``, and the theoretical ``S_T_hier``
        from :func:`repro_torch.core.objective.hier_query_set_cost`.
        """
        # `max_queries=0` must mean "no queries", not "the full log".
        queries = log.queries[:max_queries] if max_queries is not None else log.queries
        if batched:
            return self._evaluate_batched(
                corpus, result, queries, check_lossless, cost_model
            )
        cq = as_queries(np.asarray(queries))
        n_docs = corpus.n_docs
        hier = self._hier_of(result)

        def chain(index, terms):
            """Cost-ordered single-index Lookup chain (k=2: the shorter
            list probes the longer — the historical loop)."""
            lists = [index.postings(int(t)) for t in terms]
            return chain_lookup(lists, n_docs, self.bucket_size)

        base_total = 0.0
        sc_total = 0.0
        sr_total = 0.0
        sh_total = 0.0
        inv_base = np.empty(n_docs, dtype=np.int64)
        inv_base[result.base_perm] = np.arange(n_docs)
        inv_perm = np.empty(n_docs, dtype=np.int64)
        inv_perm[result.perm] = np.arange(n_docs)

        for terms in cq:
            # Baseline: Lookup on the randomized single index.
            r0, w0 = chain(result.base_index, terms)
            base_total += w0
            # S_C: two-level cluster-index query.
            r1, w1 = result.cluster_index.query(*terms)
            sc_total += w1["total"]
            # S_R: single-index Lookup on the reordered index.
            r2, w2 = chain(result.reordered_index, terms)
            sr_total += w2
            # S_H: the L-level descent (only when depth differs from 2).
            r3 = None
            if hier is not None:
                r3, w3 = hier.query(*terms)
                sh_total += w3["total"]
            if check_lossless:
                s0 = np.sort(inv_base[r0])
                s1 = np.sort(inv_perm[r1])
                s2 = np.sort(inv_perm[r2])
                assert np.array_equal(s0, s1) and np.array_equal(s0, s2), (
                    f"lossless violation on query {tuple(terms)}"
                )
                if r3 is not None:
                    assert np.array_equal(s0, np.sort(inv_perm[r3])), (
                        f"lossless violation (hier) on query {tuple(terms)}"
                    )

        extra = self._hier_report(corpus, result, cq, cost_model, base_total, sh_total)
        return self._speedup_report(
            corpus, result, queries, cost_model, base_total, sc_total, sr_total,
            **extra,
        )

    @staticmethod
    def _hier_of(result: SecludResult) -> Optional[HierIndex]:
        """The hierarchical index to measure separately, or None when it
        coincides with the two-level cluster index (S_H ≡ S_C)."""
        hier = getattr(result, "hier_index", None)
        if hier is None or hier.depth == 2:
            return None
        return hier

    def _hier_report(
        self,
        corpus: Corpus,
        result: SecludResult,
        queries,
        cost_model: str,
        base_total: float,
        sh_total: float,
    ) -> Dict[str, float]:
        hier = self._hier_of(result)
        if hier is None:
            return {}
        hc = hier_query_set_cost(
            corpus,
            result.level_assigns,
            [len(r) - 1 for r in result.level_ranges],
            queries,
            model=cost_model,
        )
        flat = query_set_cost(corpus, None, 1, queries, model=cost_model)
        return {
            "S_H": base_total / max(sh_total, 1e-30),
            "work_hier": sh_total,
            "depth": float(hier.depth),
            "S_T_hier": flat / max(hc["total"], 1e-30),
        }

    def _speedup_report(
        self,
        corpus: Corpus,
        result: SecludResult,
        queries: np.ndarray,
        cost_model: str,
        base_total: float,
        sc_total: float,
        sr_total: float,
        **extra: float,
    ) -> Dict[str, float]:
        s_t = (
            query_set_cost(corpus, None, 1, queries, model=cost_model)
            / max(
                query_set_cost(
                    corpus, result.assign, result.k, queries, model=cost_model
                ),
                1e-30,
            )
        )
        return {
            "S_T": float(s_t),
            "S_C": base_total / max(sc_total, 1e-30),
            "S_R": base_total / max(sr_total, 1e-30),
            "work_baseline": base_total,
            "work_cluster_index": sc_total,
            "work_reordered": sr_total,
            "n_queries": float(len(queries)),
            "psi": result.psi,
            "psi_single": result.psi_single,
            "S_T_objective": result.s_t,
            **extra,
        }

    def _evaluate_batched(
        self,
        corpus: Corpus,
        result: SecludResult,
        queries: np.ndarray,
        check_lossless: bool,
        cost_model: str,
    ) -> Dict[str, float]:
        """The batched fast path: one engine call per algorithm, no
        per-query Python loop.  Work numbers are bit-identical to the
        looped path (the engine replicates Lookup's accounting exactly)."""
        from repro_torch.core.batched_query import batched_lookup, batched_query

        cq = as_queries(np.asarray(queries))
        n_docs = corpus.n_docs
        hier = self._hier_of(result)

        t0 = time.perf_counter()
        ptr0, docs0, w0 = batched_lookup(
            result.base_index, cq, bucket_size=self.bucket_size
        )
        t_base = time.perf_counter() - t0
        t0 = time.perf_counter()
        ptr1, docs1, w1 = batched_query(result.cluster_index, cq)
        t_cluster = time.perf_counter() - t0
        t0 = time.perf_counter()
        ptr2, docs2, w2 = batched_lookup(
            result.reordered_index, cq, bucket_size=self.bucket_size
        )
        t_reordered = time.perf_counter() - t0
        ptr3 = docs3 = None
        extra: Dict[str, float] = {}
        if hier is not None:
            t0 = time.perf_counter()
            ptr3, docs3, w3 = batched_query(hier, cq)
            extra = self._hier_report(
                corpus, result, cq, cost_model, w0["total"], w3["total"]
            )
            extra["t_hier_s"] = time.perf_counter() - t0

        if check_lossless:
            inv_base = np.empty(n_docs, dtype=np.int64)
            inv_base[result.base_perm] = np.arange(n_docs)
            inv_perm = np.empty(n_docs, dtype=np.int64)
            inv_perm[result.perm] = np.arange(n_docs)
            assert np.array_equal(ptr0, ptr1) and np.array_equal(ptr0, ptr2), (
                "lossless violation: per-query result counts differ"
            )
            # Sort each per-query segment in original-id space and compare.
            qid = np.repeat(np.arange(cq.n_queries), np.diff(ptr0))

            def canon(docs, inv):
                mapped = inv[docs]
                return mapped[np.lexsort((mapped, qid))]

            s0 = canon(docs0, inv_base)
            assert np.array_equal(s0, canon(docs1, inv_perm)) and np.array_equal(
                s0, canon(docs2, inv_perm)
            ), "lossless violation: result sets differ"
            if ptr3 is not None:
                assert np.array_equal(ptr0, ptr3) and np.array_equal(
                    s0, canon(docs3, inv_perm)
                ), "lossless violation: hierarchical result sets differ"

        return self._speedup_report(
            corpus,
            result,
            cq,
            cost_model,
            w0["total"],
            w1["total"],
            w2["total"],
            t_baseline_s=t_base,
            t_cluster_index_s=t_cluster,
            t_reordered_s=t_reordered,
            **extra,
        )


def result_from_arrays(arrays: Dict[str, object]) -> SecludResult:
    """A :class:`SecludResult` rebuilt from a fitted state given as numpy
    arrays — e.g. one fitted by another implementation of the pipeline,
    so that two engines serve from the same index.

    ``arrays`` holds ``assign``, ``perm``, ``ranges``, the reordered
    index's ``post_ptr`` / ``post_docs``, and per cluster level (coarse ->
    fine) the sequences ``level_ranges``, ``level_assigns``,
    ``level_cl_ptr``, ``level_cl_ids``, ``level_seg_start`` and
    ``level_seg_end``, plus ``psi``, ``psi_single``, ``psi_levels``,
    ``base_perm``, ``bucket_size_clusters`` and ``bucket_size_postings``.

    The result serves (``hier_index``, ``cluster_index``); it carries no
    frequent-term view or baseline index, so :meth:`SecludPipeline.evaluate`
    does not apply to it.  No device copy is made: a ``SearchService``
    uploads the index to its own device on first use.
    """
    assign = np.asarray(arrays["assign"])
    n_docs = len(assign)
    bsc = int(arrays["bucket_size_clusters"])
    bsp = int(arrays["bucket_size_postings"])
    reordered = InvertedIndex(
        post_ptr=np.asarray(arrays["post_ptr"], np.int64),
        post_docs=np.asarray(arrays["post_docs"], np.int32),
        n_docs=n_docs,
    )
    level_ranges = tuple(np.asarray(r, np.int64) for r in arrays["level_ranges"])
    levels = tuple(
        HierLevel(
            cl_ptr=np.asarray(cl_ptr, np.int64),
            cl_ids=np.asarray(cl_ids, np.int32),
            seg_start=np.asarray(seg_s, np.int64),
            seg_end=np.asarray(seg_e, np.int64),
            ranges=r,
        )
        for cl_ptr, cl_ids, seg_s, seg_e, r in zip(
            arrays["level_cl_ptr"],
            arrays["level_cl_ids"],
            arrays["level_seg_start"],
            arrays["level_seg_end"],
            level_ranges,
            strict=True,
        )
    )
    hier = HierIndex(
        levels=levels,
        index=reordered,
        bucket_size_clusters=bsc,
        bucket_size_postings=bsp,
    )
    ranges = np.asarray(arrays["ranges"], np.int64)
    if len(levels) == 1:
        leaf = levels[0]
        cidx = ClusterIndex(
            cl_ptr=leaf.cl_ptr,
            cl_ids=leaf.cl_ids,
            seg_start=leaf.seg_start,
            seg_end=leaf.seg_end,
            ranges=leaf.ranges,
            index=reordered,
            bucket_size_clusters=bsc,
            bucket_size_postings=bsp,
        )
        cidx.__dict__["_hier"] = hier
    else:
        cidx = build_cluster_index(
            reordered, ranges, bucket_size_clusters=bsc, bucket_size_postings=bsp
        )
    return SecludResult(
        assign=assign,
        k=len(ranges) - 1,
        perm=np.asarray(arrays["perm"]),
        ranges=ranges,
        psi=float(arrays["psi"]),
        psi_single=float(arrays["psi_single"]),
        cluster_time_s=0.0,
        view=None,
        base_index=None,
        base_perm=np.asarray(arrays["base_perm"]),
        reordered_index=reordered,
        cluster_index=cidx,
        levels=len(levels) + 1,
        level_ranges=level_ranges,
        level_assigns=tuple(np.asarray(a) for a in arrays["level_assigns"]),
        psi_levels=tuple(float(x) for x in arrays["psi_levels"]),
        hier_index=hier,
    )
