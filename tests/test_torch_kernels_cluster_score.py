"""The port's δ⁺ scoring gather against the JAX package's.

The port's ``cluster_scores`` (its plain version on the CPU) is held
against the reference's ``cluster_scores_ref``, against a float64 brute
force, and on one shape against the Pallas kernel in interpret mode,
within ``rtol=2e-5, atol=1e-5``: the tolerance of
``tests/test_kernels_cluster_score.py`` (fp32 sums over at most L terms,
taken in another order).
"""

import numpy as np
import pytest
import torch

from repro.kernels.cluster_score.ops import cluster_scores as jax_cluster_scores
from repro.kernels.cluster_score.ops import embedding_bag as jax_embedding_bag
from repro.kernels.cluster_score.ref import cluster_scores_ref as jax_cluster_scores_ref
from repro_torch.core.torch_ops import scores_from_ell
from repro_torch.kernels.cluster_score import cluster_scores, cluster_scores_ref, embedding_bag

TOL = dict(rtol=2e-5, atol=1e-5)
SHAPES = [(4, 8, 32, 4), (16, 128, 128, 8), (10, 50, 300, 33), (32, 64, 1024, 128)]
PAD_MAX = 2**31 - 1


def _inputs(rng, n, l, tc, k, pad_frac=0.3, pad_value=None):
    ell = rng.integers(0, tc, size=(n, l)).astype(np.int32)
    ell[rng.random((n, l)) < pad_frac] = tc if pad_value is None else pad_value
    p = rng.random(tc).astype(np.float32)
    tables = rng.standard_normal((tc, k)).astype(np.float32)
    return ell, p, tables


def _brute(ell, p, tables):
    tc, k = tables.shape
    out = np.zeros((ell.shape[0], k), np.float64)
    for d, row in enumerate(ell):
        for t in row:
            if 0 <= t < tc:
                out[d] += np.float64(p[t]) * tables[t].astype(np.float64)
    return out


@pytest.mark.parametrize("n,l,tc,k", SHAPES)
def test_scores_match_reference_and_brute(n, l, tc, k):
    rng = np.random.default_rng(n + l + tc + k)
    ell, p, tables = _inputs(rng, n, l, tc, k)
    got = cluster_scores(ell, p, tables)
    assert got.dtype == torch.float32 and got.shape == (n, k) and not got.is_cuda
    np.testing.assert_allclose(got.numpy(), _brute(ell, p, tables), **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_cluster_scores_ref(ell, p, tables)), **TOL
    )


def test_scores_match_the_pallas_kernel_in_interpret_mode():
    rng = np.random.default_rng(1)
    ell, p, tables = _inputs(rng, 16, 128, 128, 8)
    want = np.asarray(jax_cluster_scores(ell, p, tables, force_kernel=True, interpret=True))
    np.testing.assert_allclose(cluster_scores(ell, p, tables).numpy(), want, **TOL)


@pytest.mark.parametrize("pad_value", [300, PAD_MAX, -5], ids=["tc", "int32_max", "negative"])
def test_pads_anywhere_add_nothing(pad_value):
    rng = np.random.default_rng(2)
    ell, p, tables = _inputs(rng, 10, 50, 300, 33, pad_frac=0.5, pad_value=pad_value)
    np.testing.assert_allclose(cluster_scores(ell, p, tables).numpy(), _brute(ell, p, tables),
                               **TOL)
    if pad_value >= 300:  # the reference's contract: pads are >= TC
        np.testing.assert_allclose(cluster_scores(ell, p, tables).numpy(),
                                   np.asarray(jax_cluster_scores_ref(ell, p, tables)), **TOL)


def test_all_pad_rows_are_zero():
    tc, k = 64, 8
    ell = np.full((4, 16), tc, np.int32)
    ell[1] = PAD_MAX
    got = cluster_scores(ell, np.ones(tc, np.float32), np.ones((tc, k), np.float32))
    np.testing.assert_array_equal(got.numpy(), 0.0)


def test_duplicate_terms_accumulate():
    tc, k = 16, 4
    ell = np.array([[3, 3, 3, tc]], np.int32)
    p = np.arange(1, tc + 1, dtype=np.float32)
    tables = np.eye(tc, k, dtype=np.float32)
    want = np.zeros((1, k), np.float32)
    want[0, 3] = 3 * p[3]
    np.testing.assert_allclose(cluster_scores(ell, p, tables).numpy(), want)
    np.testing.assert_allclose(np.asarray(jax_cluster_scores(ell, p, tables)), want)


@pytest.mark.parametrize("n,l,k", [(0, 8, 4), (5, 0, 4), (6, 20, 1)], ids=["N0", "L0", "K1"])
def test_empty_and_narrow_shapes(n, l, k):
    rng = np.random.default_rng(3)
    ell, p, tables = _inputs(rng, n, l, 40, k)
    got = cluster_scores(ell, p, tables)
    assert got.shape == (n, k)
    np.testing.assert_allclose(got.numpy(), _brute(ell, p, tables), **TOL)


@pytest.mark.parametrize("block", [1, 7, 4096])
def test_blocking_does_not_change_the_plain_version(block):
    rng = np.random.default_rng(4)
    ell, p, tables = _inputs(rng, 33, 40, 200, 16)
    got = cluster_scores_ref(torch.from_numpy(ell), torch.from_numpy(p),
                             torch.from_numpy(tables), block=block)
    np.testing.assert_allclose(got.numpy(), _brute(ell, p, tables), **TOL)


def test_scores_from_ell_takes_tables_as_k_by_tc():
    rng = np.random.default_rng(5)
    ell, p, tables = _inputs(rng, 20, 30, 100, 6)
    got = scores_from_ell(torch.from_numpy(ell), torch.from_numpy(tables.T.copy()),
                          torch.from_numpy(p), block=8)
    np.testing.assert_allclose(got.numpy(), _brute(ell, p, tables), **TOL)


def test_embedding_bag_matches_reference():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 100, size=(6, 10)).astype(np.int32)
    ids[0, 3] = 100  # a pad slot
    table = rng.standard_normal((100, 12)).astype(np.float32)
    np.testing.assert_allclose(embedding_bag(ids, table).numpy(),
                               np.asarray(jax_embedding_bag(ids, table)), rtol=1e-5, atol=1e-5)
    w = rng.random((6, 10)).astype(np.float32)
    np.testing.assert_allclose(embedding_bag(ids, table, weights=w).numpy(),
                               np.asarray(jax_embedding_bag(ids, table, weights=w)),
                               rtol=1e-5, atol=1e-5)


# The staged variant of csrc/cluster_score.cu: its summation order
# emulated in fp32 on the CPU (``_torch_parity.staged_scores_emulation``),
# and the route the launcher takes from the shapes alone.


@pytest.mark.parametrize("mis", [0, 1, 3], ids=["aligned", "mis1", "mis3"])
@pytest.mark.parametrize("n,l,tc,k", [(6, 1, 40, 1), (7, 3, 40, 2), (9, 50, 300, 7),
                                      (12, 742, 3000, 8), (5, 130, 500, 9), (4, 97, 200, 16)])
def test_staged_summation_order_matches_reference(n, l, tc, k, mis):
    """Within the reference test's tolerance of the reference's plain
    version and of a float64 brute force; tables non-negative above
    L = 128, as δ⁺ tables are (mixed-sign sums over hundreds of slots in
    another order cancel beyond a fixed tolerance)."""
    from _torch_parity import staged_scores_emulation

    rng = np.random.default_rng(n * 31 + l + k + mis)
    ell, p, tables = _inputs(rng, n, l, tc, k)
    if l > 128:
        tables = np.abs(tables)
    ell[rng.random(ell.shape) < 0.2] = PAD_MAX
    ell[rng.random(ell.shape) < 0.1] = -7
    got = staged_scores_emulation(torch.from_numpy(ell), torch.from_numpy(p),
                                  torch.from_numpy(tables), base_misalignment=mis)
    assert got.shape == (n, k) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _brute(ell, p, tables), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               cluster_scores_ref(torch.from_numpy(ell), torch.from_numpy(p),
                                                  torch.from_numpy(tables)).numpy(), **TOL)
    valid = np.where((ell >= 0) & (ell < tc), ell, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_cluster_scores_ref(valid, p, tables)),
                               **TOL)


@pytest.mark.parametrize("tc,k,route", [
    (3000, 8, "staged"), (3000, 1, "staged"), (3000, 16, "staged"), (3000, 17, "general"),
    (3000, 256, "general"), (6144, 8, "staged"), (6145, 8, "general"), (3072, 9, "staged"),
    (3073, 9, "general"), (49152, 1, "staged"), (49153, 1, "general"), (1, 300, "general"),
])
def test_score_route_from_shapes_alone(tc, k, route):
    from repro_torch.kernels.cluster_score.kernel import (STAGED_TABLE_BYTES, padded_k,
                                                          score_route)

    assert score_route(tc, k) == route
    assert (tc * padded_k(k) * 4 <= STAGED_TABLE_BYTES and k <= 16) == (route == "staged")


def test_padded_k_is_the_next_power_of_two():
    from repro_torch.kernels.cluster_score.kernel import padded_k

    assert [padded_k(k) for k in (1, 2, 3, 4, 5, 8, 9, 16)] == [1, 2, 4, 4, 8, 8, 16, 16]
