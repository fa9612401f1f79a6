"""Helpers shared by the ``test_torch_*`` parity suites: carry a fitted
state of the JAX package across to the PyTorch port as numpy arrays."""

import numpy as np


def arrays_of(res) -> dict:
    """The fitted state of a ``repro.core.seclud.SecludResult`` as the
    numpy arrays ``repro_torch.core.seclud.result_from_arrays`` takes."""
    hier = res.hier_index
    levels = hier.levels
    return {
        "assign": np.asarray(res.assign),
        "perm": np.asarray(res.perm),
        "ranges": np.asarray(res.ranges),
        "post_ptr": np.asarray(hier.index.post_ptr),
        "post_docs": np.asarray(hier.index.post_docs),
        "level_ranges": [np.asarray(r) for r in res.level_ranges],
        "level_assigns": [np.asarray(a) for a in res.level_assigns],
        "level_cl_ptr": [lev.cl_ptr for lev in levels],
        "level_cl_ids": [lev.cl_ids for lev in levels],
        "level_seg_start": [lev.seg_start for lev in levels],
        "level_seg_end": [lev.seg_end for lev in levels],
        "psi": res.psi,
        "psi_single": res.psi_single,
        "psi_levels": res.psi_levels,
        "base_perm": np.asarray(res.base_perm),
        "bucket_size_clusters": hier.bucket_size_clusters,
        "bucket_size_postings": hier.bucket_size_postings,
    }


def port_result(res):
    """The port's ``SecludResult`` serving the same index as ``res``."""
    from repro_torch.core.seclud import result_from_arrays

    return result_from_arrays(arrays_of(res))


def ragged_queries(rng, n_q, n_terms, max_arity=5, dup_rate=0.25):
    """Random query lists of arity 1..max_arity, some with a duplicated
    term (∩ is idempotent)."""
    lists = []
    for _ in range(n_q):
        a = int(rng.integers(1, max_arity + 1))
        t = rng.integers(0, n_terms, a).tolist()
        if a >= 2 and rng.random() < dup_rate:
            t[1] = t[0]
        lists.append(t)
    return lists


def make_rows(rng, b, ls, ll, universe, holes=False):
    """(b, ls) short and (b, ll) long int32 rows of sorted distinct doc
    ids drawn from ``range(universe)``, PAD-padded; with ``holes`` about
    30 % of the short cells become PAD holes."""
    from repro_torch.kernels.intersect.ref import PAD

    short = np.full((b, ls), PAD, dtype=np.int32)
    long = np.full((b, ll), PAD, dtype=np.int32)
    for r in range(b):
        ns, nl = rng.integers(0, ls + 1), rng.integers(0, ll + 1)
        short[r, :ns] = np.sort(rng.choice(universe, size=ns, replace=False))
        long[r, :nl] = np.sort(rng.choice(universe, size=nl, replace=False))
    if holes:
        short[rng.random(short.shape) < 0.3] = PAD
    return short, long
