"""The CUDA kernels of the port against their plain PyTorch versions.

The ``cuda`` tests need the card and skip without one.  This file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

The search kernels' outputs are integers: kernel and plain version must
be equal (the fold also on the hand-built layouts of
``_torch_parity.FOLD_CASES``, equal to the CPU emulation of its
algorithm, twice, and inside a CUDA graph).  The δ⁺ scores of
``cluster_scores`` are fp32 sums over at most L terms, taken in another
order than the plain version's, so they must agree within
``rtol=2e-5, atol=1e-5`` (the tolerance of the reference's
``tests/test_kernels_cluster_score.py``); each case asserts the variant
``kernel.score_route`` picked, a second launch gives the same bits, and
the staged variant equals the emulation of its summation order
(``_torch_parity.staged_scores_emulation``) bit for bit.  The tests without the marker
check, on any machine, that a launcher refuses what its kernel does not
take and that a missing compiler raises.

``flash_attention`` is held against its plain version computed in
float32 from the same inputs (TF32 off), at the cases and within the
tolerance of ``_torch_parity`` (``FLASH_CASES``, ``FLASH_TOL``, plus
``p_rounding_term`` for the sm90 variant, which rounds P to bf16) that
``chip_smoke.py`` uses too; each case asserts from the launch counters
which variant it took (``kernel.flash_route``).  The decode variant's two
kernels are also held one by one against their plain versions, and the
launcher must refuse a misaligned base or stride for the variants that
read with 16-byte loads or TMA.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import (FLASH_CASES, FLASH_VARIANTS, FOLD_CASES, VARIANT_LAUNCHES,
                           flash_close, flash_inputs, fold_emulation, make_rows, p_rounding_term,
                           staged_scores_emulation, synthetic_fold_case)
from repro_torch.kernels import build as B
from repro_torch.kernels.cluster_score import kernel as CK
from repro_torch.kernels.cluster_score import ops as cops
from repro_torch.kernels.cluster_score.ref import cluster_scores_ref
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref, combine_ref, decode_partials_ref
from repro_torch.kernels.intersect import kernel as K
from repro_torch.kernels.intersect import ops, ref
from repro_torch.kernels.intersect.ref import PAD

SHAPES = [(1, 16, 64), (8, 128, 128), (5, 100, 300), (16, 128, 512), (3, 257, 1000),
          (4, 33, 0), (0, 8, 8), (6, 0, 5), (7, 1, 1)]
# (N, L, TC, K): the reference test's shapes, empty and narrow ones, a K
# above 256 (column chunks), and the path's L = 742, TC = 3000 at the top
# TopDown split's K = 8 and the flat algorithm's K = 256.
SCORE_SHAPES = [(4, 8, 32, 4), (16, 128, 128, 8), (10, 50, 300, 33), (32, 64, 1024, 128),
                (0, 8, 32, 4), (6, 0, 32, 4), (9, 40, 64, 1), (20, 100, 500, 300),
                (300, 742, 3000, 8), (300, 742, 3000, 256),
                # the staged variant's edges: K in {1, 2, 7, 9} (padded to a power of
                # two), N in {0, 1, 3000}, L in {1, 3, 742} (rows 4-byte apart), and a
                # table just within and just beyond the shared-memory budget
                (3000, 742, 3000, 8), (1, 742, 3000, 8), (0, 742, 3000, 8), (3000, 1, 3000, 1),
                (3000, 3, 3000, 2), (500, 742, 3000, 7), (500, 742, 3000, 9),
                (200, 742, 6144, 8), (200, 742, 6145, 8), (200, 50, 3072, 16),
                (200, 50, 3073, 16), (50, 742, 3000, 33)]
SCORE_VARIANTS = ("cluster_scores_staged", "cluster_scores_general")
SCORE_TOL = dict(rtol=2e-5, atol=1e-5)
PAD_MAX = 2**31 - 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def test_launchers_refuse_cpu_and_wrong_dtype_tensors():
    s = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        K.intersect_count_cuda(s, s)
    with pytest.raises(ValueError, match="CUDA"):
        K.intersect_members_cuda(s, s)
    with pytest.raises(ValueError, match="CUDA"):
        K.intersect_members_count_cuda(s, s)
    cells = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        K.segment_fold_cuda(s.reshape(-1), cells, torch.zeros((2, 0), dtype=torch.int32),
                            8, (), 8, False)


def test_cluster_scores_launcher_refuses_cpu_and_wrong_dtype_tensors():
    ell = torch.zeros((2, 4), dtype=torch.int32)
    p = torch.ones(8, dtype=torch.float32)
    tables = torch.ones((8, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        CK.cluster_scores_cuda(ell, p, tables)
    with pytest.raises(ValueError, match="int32"):
        CK.cluster_scores_cuda(ell.long(), p, tables)
    with pytest.raises(ValueError, match="float32"):
        CK.cluster_scores_cuda(ell, p.double(), tables)
    with pytest.raises(ValueError, match="float32"):
        CK.cluster_scores_cuda(ell, p, tables.half())
    if torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
        with pytest.raises(ValueError, match="CUDA"):
            CK.cluster_scores_cuda(ell.to(dev), p, tables.to(dev))
        with pytest.raises(ValueError, match="contiguous"):
            CK.cluster_scores_cuda(ell.to(dev), p.to(dev), tables.to(dev).T)


def test_flash_attention_launcher_refuses_what_its_kernel_does_not_take():
    q = torch.zeros((1, 2, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        FK.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        FK.flash_attention_cuda(q.half(), q.half(), q.half())
    if torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
        qd = q.to(dev)
        with pytest.raises(ValueError, match="see a key"):
            FK.flash_attention_cuda(qd, qd[:, :, :2], qd[:, :, :2])
        with pytest.raises(ValueError, match="divide"):
            FK.flash_attention_cuda(qd, qd[:, :1].expand(1, 3, 4, 16), qd[:, :1].expand(1, 3, 4, 16))
        wide = torch.zeros((1, 1, 4, 512), device=dev)
        with pytest.raises(ValueError, match="head dim"):
            FK.flash_attention_cuda(wide, wide, wide)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("the CUDA toolkit is installed here")
    monkeypatch.setattr(B.shutil, "which", lambda name: None)
    monkeypatch.setattr(B, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(B, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        B.build_libraries()


@pytest.mark.cuda
@pytest.mark.parametrize("holes", [False, True], ids=["sorted", "pad_holes"])
@pytest.mark.parametrize("b,ls,ll", SHAPES)
def test_intersect_trio_equals_plain(cuda_device, b, ls, ll, holes):
    rng = np.random.default_rng(b + ls + ll)
    short, long = make_rows(rng, b, ls, ll, universe=max(4 * ll, 4 * ls, 8), holes=holes)
    s, l = torch.from_numpy(short).to(cuda_device), torch.from_numpy(long).to(cuda_device)
    hit = ref.intersect_members_ref(s, l)
    before = dict(B.LAUNCHES)
    assert torch.equal(ops.intersect_members(s, l, reduce="mask"), torch.where(hit, s, int(PAD)))
    assert torch.equal(ops.intersect_members(s, l, reduce="docs"),
                       ref.intersect_members_docs_ref(s, l))
    assert torch.equal(ops.intersect_members(s, l, reduce="count"),
                       hit.sum(dim=1).to(torch.int32))
    s_sorted = torch.sort(s, dim=1).values
    assert torch.equal(ops.intersect_count(s_sorted, l), ref.intersect_count_ref(s_sorted, l))
    assert B.LAUNCHES["intersect_members_kernel"] == before["intersect_members_kernel"] + 2
    for name in ("intersect_members_count_kernel", "intersect_count_kernel"):
        assert B.LAUNCHES[name] == before[name] + 1


@pytest.fixture(scope="module")
def fitted():
    from repro_torch.core.seclud import SecludPipeline
    from repro_torch.data.corpus import CorpusSpec, synth_corpus
    from repro_torch.data.query_log import synth_query_log

    corpus = synth_corpus(CorpusSpec(n_docs=800, n_terms=1500, mean_doc_len=24,
                                     n_topics=6, seed=3))
    log = synth_query_log(corpus, n_queries=120, seed=4, arity=[1, 2, 3, 4, 5])
    res = SecludPipeline(tc=400, doc_grained_below=128, seed=0).fit(
        corpus, k=10, log=log, levels=3, device="cpu")
    return corpus, log, res


@pytest.mark.cuda
@pytest.mark.parametrize("arity_one_only", [False, True], ids=["arity1to5", "arity1"])
@pytest.mark.parametrize("return_members", [False, True])
def test_segment_fold_equals_plain(cuda_device, fitted, return_members, arity_one_only):
    from repro_torch.core.batched_query import plan_segment_pairs
    from repro_torch.core.device_engine import device_index, lower_plan
    from repro_torch.core.queries import ConjunctiveQueries

    _corpus, log, res = fitted
    lists = [list(map(int, t)) for t in log.as_conjunctive()]
    if arity_one_only:
        lists = [x[:1] for x in lists]
    di = device_index(res.hier_index, cuda_device)
    low = lower_plan(plan_segment_pairs(di.host, ConjunctiveQueries.from_lists(lists),
                                        track_work=False))
    args = (di.post_docs, torch.from_numpy(low.cells).to(cuda_device),
            torch.from_numpy(low.stage_seg).to(cuda_device), low.group_width,
            low.stage_iters, low.n_queries_pad, return_members)
    before = B.LAUNCHES["segment_fold"]
    got = ops.segment_fold(*args)
    assert B.LAUNCHES["segment_fold"] == before + 1
    want = ref.segment_fold_ref(*args)
    for g, w in zip(got, want, strict=True):
        assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("return_members", [False, True])
@pytest.mark.parametrize("name", sorted(FOLD_CASES))
def test_segment_fold_hand_built_layouts_equal_plain(cuda_device, name, return_members):
    """Bit-identical counts, entering and members on the hand-built layouts
    of ``_torch_parity.FOLD_CASES``, equal to the CPU emulation of the
    kernel's algorithm too, and the same bits from a second launch."""
    case = synthetic_fold_case(**FOLD_CASES[name])
    host = (torch.from_numpy(case["post_docs"]), torch.from_numpy(case["cells"]),
            torch.from_numpy(case["stage_seg"]))
    rest = (case["group_width"], case["stage_iters"], case["n_queries_pad"], return_members)
    args = tuple(t.to(cuda_device) for t in host) + rest
    before = B.LAUNCHES["segment_fold"]
    got = ops.segment_fold(*args)
    again = ops.segment_fold(*args)
    torch.cuda.synchronize()
    assert B.LAUNCHES["segment_fold"] == before + 2
    want = ref.segment_fold_ref(*args)
    *emulated, _stats = fold_emulation(*host, *rest)
    for g, a, w, e in zip(got, again, want, emulated, strict=True):
        assert (g is None and w is None and e is None) or (
            torch.equal(g, w) and torch.equal(a, g) and torch.equal(g.cpu(), e))


@pytest.mark.cuda
def test_segment_fold_launch_copies_nothing_from_the_host(cuda_device):
    """The search depths travel by value: the call can be captured in a
    CUDA graph (a host-to-device copy or a stream sync inside the capture
    would fail it), and a replay gives the eager result."""
    case = synthetic_fold_case(**FOLD_CASES["edges"])
    args = (torch.from_numpy(case["post_docs"]).to(cuda_device),
            torch.from_numpy(case["cells"]).to(cuda_device),
            torch.from_numpy(case["stage_seg"]).to(cuda_device), case["group_width"],
            case["stage_iters"], case["n_queries_pad"], True)
    want = ops.segment_fold(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.segment_fold(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.segment_fold(*args)
    graph.replay()
    torch.cuda.synchronize()
    for g, w in zip(out, want, strict=True):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_search_service_on_the_card_equals_host(cuda_device, fitted):
    from repro_torch.serve.search_service import SearchService

    _corpus, log, res = fitted
    svc = SearchService(res, device=cuda_device)
    queries = log.queries
    host, _ = svc.serve_counts(queries)
    B.reset_launch_counts()
    counts, docs, info = svc.serve_counts_device(queries, return_docs=True)
    np.testing.assert_array_equal(counts, host)
    assert info["n_kernel_calls"] == 1.0 and B.LAUNCHES["segment_fold"] == 1
    blocks = svc.device_counts(svc.pack(queries))
    assert blocks.is_cuda
    np.testing.assert_array_equal(blocks.cpu().numpy(), host)
    assert B.LAUNCHES["intersect_members_kernel"] > 0
    assert B.LAUNCHES["intersect_members_count_kernel"] == 1


def _score_inputs(rng, n, l, tc, k):
    """As chip_smoke.score_inputs: standard normal tables up to the
    reference test's L = 128, non-negative ones (as δ⁺ tables are) above,
    where mixed-sign fp32 sums cancel beyond what the tolerance bounds."""
    ell = rng.integers(0, tc, size=(n, l)).astype(np.int32)
    holes = rng.random((n, l))
    ell[holes < 0.2] = tc
    ell[(holes >= 0.2) & (holes < 0.3)] = PAD_MAX
    if n and l >= 3:
        ell[0, :] = PAD_MAX  # an all-pad row
        ell[n - 1, 1:3] = ell[n - 1, 0]  # duplicate ranks accumulate
    p = rng.random(tc).astype(np.float32)
    if l <= 128:
        tables = rng.standard_normal((tc, k)).astype(np.float32)
    else:
        tables = rng.random((tc, k)).astype(np.float32)
    return ell, p, tables


def _score_case(cuda_device, n, l, tc, k, offset_rows=0):
    """Inputs on the card; with ``offset_rows`` the ELL is a row slice of a
    larger one, so its base sits inside a 16-byte block when L is odd."""
    rng = np.random.default_rng(n + l + tc + k)
    ell, p, tables = _score_inputs(rng, n + offset_rows, l, tc, k)
    if n and l >= 3:
        ell[offset_rows, :] = PAD_MAX  # the slice's first row: all pads
    if n and l:
        ell[-1, -1] = -3  # a negative rank is a pad too
    ell_d = torch.from_numpy(ell).to(cuda_device)[offset_rows:]
    return ell_d, torch.from_numpy(p).to(cuda_device), torch.from_numpy(tables).to(cuda_device)


def _launched(before):
    return {name: B.LAUNCHES[name] - before[name] for name in SCORE_VARIANTS}


@pytest.mark.cuda
@pytest.mark.parametrize("n,l,tc,k", SCORE_SHAPES)
def test_cluster_scores_equals_plain(cuda_device, n, l, tc, k):
    ell, p, tables = _score_case(cuda_device, n, l, tc, k, offset_rows=1 if l % 2 else 0)
    route = CK.score_route(tc, k)
    before = dict(B.LAUNCHES)
    got = cops.cluster_scores(ell, p, tables)
    torch.cuda.synchronize()
    assert B.LAUNCHES["cluster_scores_kernel"] == before["cluster_scores_kernel"] + (1 if n else 0)
    assert _launched(before) == {f"cluster_scores_{v}": int(bool(n) and v == route)
                                 for v in ("staged", "general")}
    assert got.is_cuda and got.shape == (n, k) and got.dtype == torch.float32
    want = cluster_scores_ref(ell, p, tables)
    torch.testing.assert_close(got, want, **SCORE_TOL)
    assert torch.equal(cops.cluster_scores(ell, p, tables), got)  # the same bits again
    if n and l >= 3:
        assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("offset_rows", [0, 1, 2, 3])
@pytest.mark.parametrize("n,l,tc,k", [c for c in SCORE_SHAPES
                                      if c[0] and CK.score_route(c[2], c[3]) == "staged"])
def test_staged_scores_are_the_emulated_sums_bit_for_bit(cuda_device, n, l, tc, k, offset_rows):
    """The staged variant adds the same fp32 values in the same order as
    ``_torch_parity.staged_scores_emulation`` (16-byte blocks to lanes,
    slot order in a lane, xor tree), whatever the ELL's base alignment."""
    ell, p, tables = _score_case(cuda_device, n, l, tc, k, offset_rows=offset_rows)
    got = CK.cluster_scores_cuda(ell, p, tables, variant="staged")
    mis = (ell.data_ptr() // 4) % 4
    want = staged_scores_emulation(ell.cpu(), p.cpu(), tables.cpu(), base_misalignment=mis)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cluster_scores_is_deterministic(cuda_device):
    rng = np.random.default_rng(9)
    ell, p, tables = (torch.from_numpy(a).to(cuda_device)
                      for a in _score_inputs(rng, 500, 200, 3000, 8))
    for variant in ("staged", "general"):
        assert torch.equal(CK.cluster_scores_cuda(ell, p, tables, variant=variant),
                           CK.cluster_scores_cuda(ell, p, tables, variant=variant))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,lq,lk,d,causal,window", FLASH_CASES)
def test_flash_attention_equals_plain(cuda_device, dtype, b, h, hkv, lq, lk, d, causal, window):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = flash_inputs(cuda_device, dtype, b, h, hkv, lq, lk, d, seed=lq + lk + d,
                           model_layout=lk % 2 == 0)
    route = FK.flash_route(dtype, h, hkv, lq, d)
    before = dict(B.LAUNCHES)
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert B.LAUNCHES["flash_attention_kernel"] == before["flash_attention_kernel"] + 1
    launched = {n: B.LAUNCHES[n] - before[n] for n in FLASH_VARIANTS}
    assert launched == {n: VARIANT_LAUNCHES[route].get(n, 0) for n in FLASH_VARIANTS}
    assert got.dtype == dtype and got.shape == q.shape and got.stride() == q.stride()
    extra = p_rounding_term(q, k, v, causal, window) if route == "sm90" else None
    flash_close(got, attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window),
                extra)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,lq,lk,d,causal,window",
                         [c for c in FLASH_CASES if FK.flash_route(torch.bfloat16, c[1], c[2], c[3],
                                                                   c[5]) == "decode"])
def test_flash_decode_kernels_equal_their_plain_versions(cuda_device, dtype, b, h, hkv, lq, lk, d,
                                                         causal, window):
    """The split kernel's partials against ``decode_partials_ref`` (fp32
    sums in another order: rtol 1e-4, atol 1e-4 of the largest |acc|), and
    the combine kernel on the plain partials against ``combine_ref``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = flash_inputs(cuda_device, dtype, b, h, hkv, lq, lk, d, seed=lk + d, model_layout=True)
    plan = FK.decode_plan(lq, lk, window, b * hkv,
                          torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    ml, acc = FK.decode_partials_cuda(q, k, v, causal, window, plan)
    want_ml, want_acc = decode_partials_ref(q, k, v, causal, window, plan)
    torch.testing.assert_close(ml, want_ml, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(acc, want_acc, rtol=1e-4, atol=1e-4 * float(want_acc.abs().max()))
    out = torch.empty_like(q)
    FK.combine_cuda(want_ml, want_acc, out, hkv)
    want = combine_ref(want_ml, want_acc, b, h, hkv, lq, torch.float32)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    else:  # one rounding to bf16 of nearly the same fp32 value
        torch.testing.assert_close(out.float(), want, rtol=2**-8, atol=1e-5)


def _offset_view(shape, dtype, device, offset):
    """A dense (B, H, L, D) view starting ``offset`` elements into a buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype, device=device)[offset:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("lq,h,hkv,d,dtype", [(1, 8, 4, 256, torch.bfloat16),
                                              (1, 4, 4, 64, torch.float32),
                                              (128, 8, 4, 256, torch.bfloat16)],
                         ids=["decode_bf16", "decode_f32", "sm90"])
def test_flash_attention_refuses_misaligned_bases_and_strides(cuda_device, lq, h, hkv, d, dtype):
    route = FK.flash_route(dtype, h, hkv, lq, d)
    lk = 200
    q = torch.zeros((1, h, lq, d), dtype=dtype, device=cuda_device)
    k = torch.zeros((1, hkv, lk, d), dtype=dtype, device=cuda_device)
    before = dict(B.LAUNCHES)
    with pytest.raises(ValueError, match=f"{route} variant needs 16-byte aligned"):
        flash_attention(_offset_view(q.shape, dtype, cuda_device, 1), k, k)
    with pytest.raises(ValueError, match=f"{route} variant needs 16-byte aligned"):
        flash_attention(q, _offset_view(k.shape, dtype, cuda_device, 1), k)
    # a position stride of D + 1 elements
    wide = torch.zeros((1, hkv, lk, d + 1), dtype=dtype, device=cuda_device)[..., :d]
    with pytest.raises(ValueError, match=f"{route} variant needs 16-byte aligned"):
        flash_attention(q, k, wide)
    assert B.LAUNCHES == before  # refused before any launch, no fallback


@pytest.mark.cuda
def test_flash_attention_window_of_one_is_the_value_of_the_own_key(cuda_device):
    q, k, v = flash_inputs(cuda_device, torch.float32, 1, 2, 2, 20, 50, 64, seed=3)
    got = flash_attention(q, k, v, causal=True, window=1)
    torch.testing.assert_close(got, v[:, :, 30:], rtol=1e-6, atol=1e-6)
