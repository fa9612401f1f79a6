"""The bucketed Lookup intersection of Sanders & Transier (ALENEX'07) —
the paper's reference algorithm [14], with exact work accounting.

Representation: the document-id universe [0, n) is divided into buckets of
width ``W = 2^w`` where ``w`` is chosen per posting list so the *average*
bucket occupancy is ``bucket_size`` (the paper uses 16 for the main index,
8 for the cluster index).  A directory array maps bucket id -> start offset
in the (sorted) list.  Intersection walks the shorter list and for each
element x probes the longer list's bucket ``x >> w``, scanning entries
until one >= x is found.

Work accounting (what the benchmarks report):

  * ``probes``  — one directory access per element of the shorter list
  * ``scanned`` — bucket entries examined until the first entry >= x
                  (the CPU algorithm's inner-loop iterations)

``Phi(x, y) = min(x, y)`` — the paper's objective — models exactly the
``probes`` term; ``scanned`` adds the data-dependent part that document
reordering (SeCluD §3.3, speedup S_R) improves.

This module is the exact scalar/numpy oracle of the intersection; the
device kernels in ``repro_torch.kernels.intersect`` compute the same sets.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = [
    "BucketedList",
    "bucketize",
    "lookup_intersect",
    "lookup_work",
    "chain_lookup",
    "cost_order",
    "adaptive_intersect",
]


@dataclasses.dataclass
class BucketedList:
    """A sorted posting list with a bucket directory."""

    values: np.ndarray  # (len,) sorted int32
    dir_ptr: np.ndarray  # (n_buckets + 1,) int64: bucket -> offset
    shift: int  # bucket width = 2**shift
    universe: int

    def __len__(self) -> int:
        return len(self.values)

    def bucket(self, b: int) -> np.ndarray:
        return self.values[self.dir_ptr[b] : self.dir_ptr[b + 1]]


def _pick_shift(universe: int, length: int, bucket_size: int) -> int:
    """Largest w with expected occupancy universe/2^w lists -> about
    ``bucket_size`` entries per bucket: 2^w ~ universe * B / len."""
    if length <= 0:
        return max(int(universe).bit_length(), 1)
    target = max(1.0, universe * bucket_size / length)
    return max(0, int(np.floor(np.log2(target))))


def bucketize(values: np.ndarray, universe: int, bucket_size: int = 16) -> BucketedList:
    """Build the bucket directory for a sorted list. O(len + n_buckets)."""
    values = np.asarray(values, dtype=np.int32)
    shift = _pick_shift(universe, len(values), bucket_size)
    n_buckets = (universe + (1 << shift) - 1) >> shift
    n_buckets = max(n_buckets, 1)
    # dir_ptr[b] = first index with value >= b << shift
    boundaries = (np.arange(n_buckets + 1, dtype=np.int64)) << shift
    dir_ptr = np.searchsorted(values, boundaries).astype(np.int64)
    return BucketedList(values=values, dir_ptr=dir_ptr, shift=shift, universe=universe)


def lookup_intersect(
    short: np.ndarray, long_b: BucketedList
) -> Tuple[np.ndarray, dict]:
    """Intersect ``short`` (sorted array) with a bucketized longer list.

    Work accounting models the actual C inner loop of [14]: the sorted
    short list is processed IN ORDER and the bucket scan pointer RESUMES —
    consecutive probes into the same bucket never rescan entries
    (``for x: while (ptr < hi && *ptr < x) ptr++``).  This resumability is
    precisely why cluster-contiguous reordering (S_R) pays off: in regions
    where both lists are dense the algorithm degenerates to a merge, and
    in regions where the long list is absent, probes cost ~nothing.

      * ``probes``  — one directory access + one loop-bound check per
                      element of the short list
      * ``scanned`` — pointer advances (entries examined)

    Fully vectorized and exact. Returns (result, work_dict).
    """
    short = np.asarray(short, dtype=np.int32)
    if len(short) == 0 or len(long_b) == 0:
        return np.empty(0, np.int32), {"probes": 0, "scanned": 0, "total": 0}
    b = short.astype(np.int64) >> long_b.shift
    b = np.clip(b, 0, len(long_b.dir_ptr) - 2)
    lo = long_b.dir_ptr[b]
    hi = long_b.dir_ptr[b + 1]
    pos = np.searchsorted(long_b.values, short)  # first entry >= x (global)
    stop = np.minimum(pos, hi)  # where the scan pointer ends for this probe
    # Resumable scan: within a run of probes sharing a bucket, the pointer
    # starts where the previous probe left it.
    start = lo.copy()
    if len(short) > 1:
        same = b[1:] == b[:-1]
        start[1:] = np.where(same, np.maximum(stop[:-1], lo[1:]), lo[1:])
    scanned = np.maximum(stop - start, 0)
    hit = (pos < hi) & (long_b.values[np.minimum(pos, len(long_b) - 1)] == short)
    work = {
        "probes": int(len(short)),
        "scanned": int(scanned.sum()),
        "total": int(len(short) + scanned.sum()),
    }
    return short[hit], work


def lookup_work(
    a: np.ndarray, b: np.ndarray, universe: int, bucket_size: int = 16
) -> Tuple[np.ndarray, dict]:
    """Convenience: bucketize the longer of (a, b) and intersect."""
    a = np.asarray(a)
    b = np.asarray(b)
    if len(a) > len(b):
        a, b = b, a
    return lookup_intersect(a, bucketize(b, universe, bucket_size))


def cost_order(lengths) -> list:
    """Cost-ordered plan: indices sorted by list length ascending, stable.

    Greedy-optimal under the paper's lookup model Φ(x, y) = min(x, y):
    the running intersection (always the shortest operand) probes each
    remaining list, cheapest first.  Ties keep the caller's order, so the
    2-term plan equals the historical "first term probes when lengths
    tie" behavior.
    """
    return sorted(range(len(lengths)), key=lambda i: lengths[i])


def chain_lookup(
    lists, universe: int, bucket_size: int = 16
) -> Tuple[np.ndarray, float]:
    """Cost-ordered Lookup chain over k >= 1 sorted lists.

    THE single definition of the per-query conjunctive Lookup semantics:
    the running intersection probes each remaining bucketized list,
    smallest-first (k = 2: the shorter list probes the longer — the
    historical loop).  Returns ``(result, total work)``; a single list
    costs nothing (no intersection happens).  ``repro_torch.core.batched_query.
    batched_lookup`` is its vectorized bit-exact mirror.
    """
    order = cost_order([len(x) for x in lists])
    cur = np.asarray(lists[order[0]])
    total = 0.0
    for i in order[1:]:
        cur, w = lookup_intersect(cur, bucketize(lists[i], universe, bucket_size))
        total += w["total"]
    return cur, total


def adaptive_intersect(
    a: np.ndarray, b: np.ndarray, universe: int, bucket_size: int = 16
) -> Tuple[np.ndarray, dict]:
    """The paper's §6 future-work item: a *symmetric* Lookup that probes
    from whichever list is locally sparser ("when a lookup finds an empty
    bucket, we might switch to the other list").

    Realized block-wise: the universe is cut at the bucket boundaries of
    the longer list; within each region the locally SHORTER side probes
    the locally longer side (regions where either side is empty cost
    nothing).  Exact results; work accounted like ``lookup_intersect``.
    Beyond-paper (EXPERIMENTS.md §Perf-SeCluD).
    """
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    if len(a) == 0 or len(b) == 0:
        return np.empty(0, np.int32), {"probes": 0, "scanned": 0, "total": 0}
    if len(a) > len(b):
        a, b = b, a
    blong = bucketize(b, universe, bucket_size)
    # Region = run of consecutive probes of `a` into the same bucket.
    bucket_of_a = np.clip(a.astype(np.int64) >> blong.shift, 0, len(blong.dir_ptr) - 2)
    region_start = np.flatnonzero(
        np.concatenate([[True], bucket_of_a[1:] != bucket_of_a[:-1]])
    )
    region_end = np.append(region_start[1:], len(a))
    probes = scanned = 0
    out = []
    for rs, re_ in zip(region_start, region_end, strict=True):
        bu = int(bucket_of_a[rs])
        lo, hi = int(blong.dir_ptr[bu]), int(blong.dir_ptr[bu + 1])
        n_a, n_b = int(re_ - rs), hi - lo
        if n_b == 0:
            probes += 1  # one directory check rules the region out
            continue
        short, long_ = (a[rs:re_], b[lo:hi]) if n_a <= n_b else (b[lo:hi], a[rs:re_])
        pos = np.searchsorted(long_, short)
        stop = np.minimum(pos, len(long_))
        start = np.zeros_like(stop)
        start[1:] = np.maximum(stop[:-1], 0)
        scanned += int(np.maximum(stop - start, 0).sum())
        probes += len(short)
        hit = (pos < len(long_)) & (long_[np.minimum(pos, len(long_) - 1)] == short)
        if hit.any():
            out.append(short[hit])
    res = np.concatenate(out).astype(np.int32) if out else np.empty(0, np.int32)
    return np.sort(res), {
        "probes": probes,
        "scanned": scanned,
        "total": probes + scanned,
    }
