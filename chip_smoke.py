"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # one GPU, no arguments

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel of ``src/repro_torch/csrc`` for ``sm_90a``
   (one ``nvcc`` per source, all started together) and prints ptxas's
   registers and spills of each kernel;
3. holds each kernel against its plain PyTorch version on the card, on
   random and edge-case inputs: the search kernels exactly (their outputs
   are integers; the fold also on the hand-built layouts of
   ``tests/_torch_parity.FOLD_CASES`` and against the CPU emulation of its
   algorithm, twice), ``cluster_scores`` within ``rtol=2e-5, atol=1e-5``
   through the variant ``kernel.score_route`` picks (read from the
   counters), twice with the same bits, the staged variant bit-equal to
   the emulation of its summation order; the fold also on queries of 70
   and 131 terms (past the 64 stages one launch takes: chained launches),
   equal to the host engine too;
4. drives the search path through the launcher's own functions
   (``repro_torch.launch.search``): a host fit of the ``wiki`` corpus at
   ``N_DOCS`` documents and two logs of ``N_QUERIES`` queries, the
   index uploaded to the card, both query logs served through the fold
   kernel and the block path, every batch checked against the host
   engine bit for bit, one fold launch a batch — with every launch
   counter set to 0 just before and the search kernels' counters read
   just after (the fold's arguments of each batch are recorded, for its
   timing in step 12);
5. drives the serving tier over the same fit through the launcher's
   functions (``serve_sharded``, ``replay_sealed``, ``replay_async``,
   ``replay_chaos``), on ``TIER_SHARDS`` shard slots of the card: both
   logs through the sharded engine (four fold launches a batch, every
   batch equal to the host engine, counts and docs) and the block path
   split over the slots; sealed replays at ``TIER_QPS`` after
   ``prewarm`` (no compile, counts equal to the host, every batch at the
   ``"device"`` rung of the resilience ladder, one fold launch per shard
   and non-empty batch); an async replay; the two chaos replays of
   ``CHAOS_QUERIES`` queries (shard 0 lost at batch 2 and served at the
   ``"remesh"`` rung; a queue flood past the shed depth, shedding exactly
   its batches and any whose real backlog passes the depth), every
   answered request exact — counters set to 0 before each part and read
   after;
6. drives the clustering path: TopDown over the same frequent-term view
   with the device K-means (``distributed_kmeans_fn([cuda:0])``) as its
   ``kmeans_fn``, counters set to 0 just before and the
   ``cluster_scores`` counters read just after (every launch on the
   staged variant; each launch's shape recorded); checks the labels and
   that ψ beats a random assignment, and compares ψ and wall time with
   the host fit's;
7. runs one K-means round at full size through the kernel and through
   the plain version on the card (equal counts, bit-equal tables, scores
   within the tolerance, assignments equal but for near-ties);
8. holds the attention (``flash_attention_kernel``, the launcher's call)
   against its plain version computed in float32 from the same inputs, on
   random and edge-case inputs and at the LM path's shapes
   (``FLASH_CASES``, ``FLASH_TOL`` and ``p_rounding_term`` of
   ``tests/_torch_parity.py``, which the kernel tests share: float32
   within ``rtol=atol=2e-4``, bfloat16 within half a bf16 step, plus
   2**-8 times the plain attention of |v| on the sm90 variant, which
   rounds P to bf16), each case through the variant the launcher picks
   (``kernel.flash_route``: the bf16 tensor-core prefill ``sm90``, the
   split-K ``decode`` with its combine, the fp32 ``resident`` kernel (K
   and V of a head in shared memory; not causal, no window) or the
   ``general`` kernel) and read from the counters;
9. drives the LM serving path through the launcher's own functions
   (``repro_torch.launch.serve``), in the phases of ``LM_PHASES`` (run
   right after step 8, before step 4, while the card holds nothing else):
   gemma3-4b at its full width with the bf16 cache (8 prompts of 2048
   tokens, 8 greedy steps),
   then the serving cell ``decode_32k`` (the int8 KV cache) for
   qwen3-moe-30b-a3b at full width and depth, gemma3-4b at the cell's
   cache length of 32,768 and arctic-480b at full width cut to 2 layers,
   each with seeded random weights — counters set to 0 just before each
   phase's ``serve`` and the attention counters read just after (one call
   per layer per model call: the prefill's on the sm90 variant, the
   decode steps' on the split-K variant and its combine) — then replays
   the same run with attention through the plain version (over query
   chunks where the whole score tensor would not fit), fed the kernel
   route's tokens and, with MoE, its experts (the plain route's own
   routing flips must be near-ties by ``ROUTER_TIE_SHARE``), and compares
   every call's logits (within ``LOGIT_RTOL``) and tokens (equal but at
   near-ties), and at each attention call of that replay holds the kernel
   on the same inputs to its limit; the phase's faulty controls (the
   window ignored on local layers; the ragged tail of keys dropped; the
   MoE gates not renormalised) must land beyond ``LOGIT_RTOL`` in the
   logit comparison, and the tail-dropped attention beyond ``FLASH_TOL``
   at the first decode step; then traces four decode steps with
   ``torch.profiler`` (device kernel time per step split into attention,
   dequantize, MoE dispatch, expert products and the rest; the device's
   idle share) and, with the int8 cache, times the dequantize alone;
   then the model axis, the phases of ``MESH_PHASES`` (``launch/serve.py
   --mesh 1x4``: a ``(data, model)`` mesh of four slots of the card):
   qwen1.5-32b at full width and depth and qwen3-moe-30b-a3b, both at
   ``decode_32k`` — counters set to 0 just before ``serve`` and read
   just after (per decode step and layer one split-K launch per sequence
   shard with visible keys and one combine) — then replays fed the served
   tokens: through the kernels with the mesh decode held to
   ``FLASH_TOL`` of ``attention_ref`` over the dequantized visible prefix
   at every call; the plain route under the same mesh (MoE: with the
   kernel route's experts; its logits within ``LOGIT_RTOL``); a dense
   model's single-device route, kernels and all, and that route again
   with one bf16 unit moved in one attention output (the floor of the
   logit comparison: a dense model's mesh route is held to the
   single-device and the plain route within ``LOGIT_RTOL`` or
   ``FLOOR_MARGIN`` times that floor, its step time beside the mesh's);
   and the faulty controls of
   ``MESH_CONTROLS`` (one shard's partials dropped from the combine, one
   slot's expert outputs left out of the sum), which must land beyond
   the limit; a trace of four decode steps under the mesh, the splits of
   each shard and the combine's total, and the dropped MoE slots under
   both capacity rules;
10. trains right after the LM phases (``TRAIN_PHASES``, on the emptied
   card), after holding the attention's backward kernels against the
   plain backward (``attention_bwd_ref``) at
   ``_torch_parity.FLASH_BWD_CASES``, ``RESIDENT_BWD_CASES`` and the
   training shapes (``BWD_TRAIN_SHAPES``: gemma3-4b's local and global
   layer at 4,096 tokens in bf16, BERT4Rec's call at 32,768 rows in fp32,
   past one launch chunk), each call through the route
   ``kernel.bwd_route`` names (``BWD_ROUTE_KERNELS``, one launch of each
   a call): for fp32, not causal, no window (BERT4Rec's call) the
   resident kernel ``flash_bwd_resident`` alone
   (``csrc/flash_attention_bwd_resident.cu``, given the resident
   forward's log-sum-exp; ``FLASH_BWD_TOL``; a rerun bit-identical), else
   ``flash_bwd_prep`` (``csrc/flash_attention_bwd.cu``; delta alone where
   the sm90 forward saved the log-sum-exp), then for bf16 at D in {64,
   128, 256} the tensor-core ``flash_bwd_dkdv_sm90`` and
   ``flash_bwd_dq_sm90`` (``csrc/flash_attention_bwd_sm90.cu``; limit
   ``FLASH_BWD_TOL`` plus the rounding term of P and dS,
   ``bwd_rounding_terms``), else the general ``flash_bwd_dkdv`` and
   ``flash_bwd_dq`` (``FLASH_BWD_TOL``); the sm90 and resident cases also
   through the general backward forced; each kernel alone against its
   plain part, the sm90 and resident forwards' log-sum-exp against the
   plain one, and the faulty controls that must land beyond their route's
   limit (sm90: the window dropped, the group sum dropped; resident:
   delta dropped, the group sum dropped).  Each phase goes
   through
   ``launch/train.py``'s own ``train_setup`` and ``launch.steps.
   train_step`` at the published widths with seeded random weights:
   gemma3-4b at full depth (``train_4k``'s overrides, 2 microbatches of
   one 4,096-token sequence, bf16 weights, fp32 masters and moments),
   dien, mind and dcn-v2 at ``train_batch``'s 65,536 rows, bert4rec at
   16,384.  The first step's loss and every gradient leaf through the
   kernels are held to the same step through the plain attention on the
   card (``TRAIN_GRAD_RTOL``; a faulty control — the backward without the
   local layers' window, or BERT4Rec's made causal — beyond it), a recsys
   arch's also to the port on the CPU on its first rows; then the steps,
   counters set to 0 just before and read just after (the backward
   kernels once a layer a microbatch: bert4rec's one ``flash_bwd_resident``
   a layer and none of the others; the sm90 forward twice under the
   block remat), the last one traced (device time by part, idle), and
   the loss on the first batch must fall.  Then the checkpoint restart on
   dcn-v2 through the ``Trainer`` (restored state and next batch
   bit-equal; resumed losses within ``CKPT_LOSS_RTOL`` of the
   uninterrupted run's).  After the search path (step 4) it runs the
   sanitizer on the warm fold (``analysis/sanitize.py``: clean, and a
   planted ``.item()`` and ``torch.nonzero`` caught).  Then PNA
   (``pna_phase``, on the emptied card), through ``launch/train.py``'s
   ``graph_setup`` and ``launch.steps.train_step``: ogb_products at its
   full graph (2,449,029 nodes; ``synth_graph`` at degree 25 gives
   61,225,725 edges, the cell's 61,859,140 the one cut, printed) and
   full width, built on the host by a process of its own started after
   the LM and mesh phases (``start_pna_graphs``, with minibatch_lg's
   232,965-node graph at degree 492 and its first sampled batch of 1,024
   seeds); ``PNA_STEPS``
   steps, counters set to 0 just before and read just after (per step 2
   ``segment_aggregate_fwd`` launches a layer, the layer checkpoint's
   recompute included, and 1 ``segment_aggregate_bwd``), the last traced
   (step s, edges and nodes/s, peak, device ms by part, idle); layer 1's
   aggregation, kernels against the plain version's formulas in float64
   over destination ranges of at most ``PNA_RANGE_EDGES`` edges (node 0's
   11.5 M alone): max, min, deg and the tie counts bit for bit, mean, std,
   d hs and d hd within the limits of the kernels' float64 sums
   (``_torch_parity.aggregate_reference``, derived in its docstring), the
   faulty controls (ties not averaged; one run's merge record and the
   first record past the merge's 32 warps dropped, at node 0 and at a
   node of ~10⁵ edges) beyond them; each kernel timed eager and as a
   graph replay beside its bounds and the plain version's time on node
   0's range; and at ``PNA_ROUTE_CELLS`` (full_graph_sm, molecule, one
   minibatch_lg batch) a step through the kernels against the same step
   through the plain version, per leaf (``pna_route_check``);
11. drives the recsys serving path right after the training: first a
   ``FilteredRetriever`` (``serve/retrieval.py``, its defaults) over the
   ``retrieval_cand`` cell's ``N_ITEMS`` items with attributes drawn as
   the example search service draws them, each filter of ``FILTERS`` and
   a rare pair equal to a brute-force scan of the item CSR (a control
   that drops one attribute of the pair must fail that check); then, for
   each arch of ``RECSYS_ARCHS`` at its published widths with seeded
   random weights, through ``launch/serve.py``'s own functions and with
   the counters set to 0 just before and read just after: ``serve_p99``
   (``P99_CALLS`` calls of 512 rows: p50, p99, rows/s, peak memory),
   ``serve_bulk`` (262,144 rows in slices of ``SERVE_SLICE_ROWS``) and
   ``retrieval_cand`` (1 query x 10⁶ candidates); BERT4Rec's attention
   launches the ``resident`` variant twice a model call, the other archs
   launch no kernel.  Then a ``torch.profiler`` window of p99 calls
   (device time from the kernels' own events, idle share), and the
   checks: ``forward`` and ``score_candidates`` against the port on the
   CPU with the same weights on the first rows and candidates (the CPU
   parity tests' tolerance), the bulk batch's first rows against the
   p99 call, BERT4Rec's attention within ``FLASH_TOL`` of its plain
   version at every call of a p99 call and of the first bulk slice and
   its plain route's scores against the kernel route's, and each
   filter's survivors scored by the model: the top 10 equal to the
   unfiltered top 10 on the exact set (near-ties apart);
12. times each kernel against its plain version at the main path's
   shapes (the attention call at each phase's shapes, beside
   ``scaled_dot_product_attention`` with a boolean mask and as the fastest
   single call; the decode variant's split kernel and combine one by
   one; the fold, ``cluster_scores`` and attention also as device time
   from a CUDA-graph replay, without the host's launch cost;
   ``cluster_scores`` beside its first design, the ``general`` variant,
   re-timed on the same inputs), sums launches x (time - bound) over the
   search run's fold batches and over the TopDown's scoring calls (timed
   once per shape bucket; at BERT4Rec's call the ``resident`` variant,
   eager and as a graph replay, beside the ``general`` kernel forced on
   the same inputs, ``scaled_dot_product_attention``'s efficient backend
   in float32 and the plain version, both kernels held to ``FLASH_TOL``,
   each against the bound of the unit its products run on: the tensor
   cores' TF32 rate, three products for one, and the fp32 cores' rate),
   and prints one JSON line listing every kernel with its variant (the
   ``general`` kernel with its launches on the main path: none since the
   resident variant took BERT4Rec's call);
   The backward kernels are timed at the training shapes, each alone
   (eager and as a graph replay) against its plain part and its bound
   (at gemma3-4b's the sm90 route's, at BERT4Rec's the resident kernel,
   bound at the tensor cores' TF32 rate over three products, and at both
   the general ones forced), beside the whole backward of the route and
   of the general kernels and ``scaled_dot_product_attention``'s
   backward.  Each phase's wall time
   is printed on a line of its own (``phase <name>: <s>s``);
13. prints ``{"ok": true, "device": {...}}`` as its last line.

Any mismatch or error raises and the script exits non-zero.  Without a
GPU, or without the rest of the repository beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM fp32 rate outside the tensor cores, dense (NVIDIA data sheet):
# the peak for the scores' multiply-adds.
FP32_OPS_PER_S = 67e12
SECTOR_BYTES = 32  # the card's smallest device-memory transaction
# The main path's size: the `wiki` preset at 200,000 documents, the scale
# the host fit affords.  A cut changes these and is recorded in PERF.md.
N_DOCS = 200_000
N_QUERIES = 2000
# The host fit's clustering settings (``launch/search.py`` with the
# pipeline's defaults), which the device TopDown repeats.
K_CLUSTERS = 256
DOC_GRAINED_BELOW = 512
# fp32 sums over at most L terms, taken in another order than the plain
# version's: the tolerance of tests/test_kernels_cluster_score.py:40-41.
SCORE_RTOL, SCORE_ATOL = 2e-5, 1e-5
PAD_MAX = 2**31 - 1
# H100 SXM bf16 tensor-core rate, dense (NVIDIA data sheet): the peak for
# attention's products on bf16 inputs.
BF16_OPS_PER_S = 989e12
# H100 SXM TF32 tensor-core rate, dense (NVIDIA data sheet): the peak for
# the resident attention's products, three TF32 products for each fp32 one
# (the 3xTF32 split).
TF32_OPS_PER_S = 495e12
TF32_PRODUCTS_PER_FP32 = 3
# scaled_dot_product_attention, a yardstick with bf16 products of its own,
# against the plain version: the reference's bf16 tolerance
# (tests/test_kernels_flash_attention.py:88).
LIBRARY_TOL = 3e-2
# The decode variant's step of keys (kernel.DECODE_CHUNK_STEP: its splits
# are whole multiples of it, and the general kernel's tile is as long): a
# fault control drops the ragged last one.
KEY_TILE = 32
# Logits of the kernel route against the plain route, per step:
# max |a - b| <= LOGIT_RTOL * max |b|.  Both routes round every attention
# output and every activation to bf16 (a step is 2**-7 to 2**-8 of the
# value); the fp32 differences inside attention (sum order, exp) flip a few
# of those roundings by one step, and 34-48 layers carry the flips on.
# Sound runs read 0.0072-0.0170 over the LM phases on the card (PERF.md);
# every run also reads each phase's faulty controls through the same
# comparison and fails unless they land beyond the limit.  Greedy tokens must be equal except where the plain
# route's two logits lie within the same bound.
LOGIT_RTOL = 2e-2
# A routing flip of an MoE replay (its own top-k set differs from the
# kernel route's) is a near-tie when the token's router-logit gap between
# its k-th and (k+1)-th expert lies within ROUTER_TIE_SHARE of the spread
# of its router logits.  Derivation: the router is a linear map of the
# normed hidden state in bf16, as the output head is, at an earlier
# depth; the kernel route may move the head's logits by LOGIT_RTOL of
# their size, so it may move each router logit by LOGIT_RTOL of their
# spread; a flip needs the two logits to cross, which both shifts together
# can do over a gap of at most twice that.  In probabilities: the plain
# route's margin p_k - p_k+1 = p_k (1 - exp(-gap)) lies within
# p_k (1 - exp(-ROUTER_TIE_SHARE · log(p_max / p_min))).
ROUTER_TIE_SHARE = 2 * LOGIT_RTOL
# A dense mesh phase's logit limit follows the model's own floor, read in
# the same run: the single-device route again with one element of the
# first decode call's attention output moved by one bf16 unit in the last
# place (OneUlpAttention), against the single-device route.  Its logits
# are held to LOGIT_RTOL, or to FLOOR_MARGIN times that floor where the
# floor passes LOGIT_RTOL/FLOOR_MARGIN: a model that moves its logits that
# far for one unit in one element cannot tell a sound route from any
# other rounding below it.  Readings (tools/mesh_logit_probe.py on the
# card, qwen1.5-32b cut to 16/32/48/64 layers): the one-unit witness read
# 0.016/0.026/0.027/0.028; every rounding-only pair of routes (the mesh
# decode, two single-device decodes with 2 or 7 splits for 4, the plain
# route in fp32 and in bf16) read at most 1.27 times it at the same depth;
# a shard dropped from the combine read 0.14-0.21.
FLOOR_MARGIN = 1.5


class LMPhase(NamedTuple):
    """One LM serving run: the arch, the serving cell whose overrides it
    takes (None: the config as it is), requests x prompt tokens + greedy
    steps, a depth cut (None: full depth) and its fault controls
    (``CONTROLS``)."""

    name: str
    arch: str
    cell: Optional[str]
    requests: int
    prompt_len: int
    steps: int
    layers: Optional[int]
    controls: Tuple[str, ...]


# The LM path: gemma3-4b at full width and depth with the bf16 cache, 8
# requests of 2048 tokens (past the 1024 window, so the local layers skip
# key tiles) and 8 greedy steps, then the zoo's own serving cell
# ``decode_32k`` (its overrides: the int8 KV cache) for qwen3-moe-30b-a3b at
# full width and depth, for gemma3-4b at the cell's cache length (4 x
# 32,760 prompt tokens + 8 steps fill 32,768 positions) and for
# arctic-480b at full width with its depth cut to 2 layers (its 35 take
# 888 GiB).  Cuts: the cell's batch of 128 to 8 or 4, the MoE phases'
# cache of 32,768 positions to 2,056, weights random; the steps from 16 to
# 8 since the pna phase joined the run (each replay's decode calls halve).
LM_PHASES = (
    LMPhase("gemma3-4b", "gemma3-4b", None, 8, 2048, 8, None, ("window", "tail")),
    LMPhase("qwen3-moe-30b-a3b decode_32k", "qwen3-moe-30b-a3b", "decode_32k", 8, 2048, 8, None,
            ("gates",)),
    LMPhase("gemma3-4b decode_32k", "gemma3-4b", "decode_32k", 4, 32760, 8, None, ("window",)),
    LMPhase("arctic-480b decode_32k", "arctic-480b", "decode_32k", 8, 2048, 8, 2, ("gates",)),
)


class MeshPhase(NamedTuple):
    """One LM serving run under a ``(data, model)`` slot mesh of the card
    (``launch/serve.py --mesh``): the arch, its serving cell, the mesh
    ("DATAxMODEL"), requests x prompt tokens + greedy steps, a depth cut
    (None: full depth) and its fault controls (``MESH_CONTROLS``)."""

    name: str
    arch: str
    cell: str
    mesh: str
    requests: int
    prompt_len: int
    steps: int
    layers: Optional[int]
    controls: Tuple[str, ...]


# The model axis, after the LM phases: qwen1.5-32b at full width and depth
# (64 layers, 35.2 B parameters, 65.6 GiB in bf16) and qwen3-moe-30b-a3b at
# full width and depth, each at ``decode_32k`` (the int8 KV cache) under a
# 1 x 4 mesh of slots of the card: every decode step splits the cache's
# 2,056 positions over the 4 model slots (514 each: one split-K launch a
# shard with visible keys, one combine a layer), and qwen3's 128 experts
# run 32 a slot.  Cuts: the cell's batch of 128 to 4 (qwen1.5-32b: its
# weights leave ~13 GiB) or 8, the cache of 32,768 positions to 2,056 (8
# steps, 16 before the pna phase joined the run),
# weights random (qwen3's drawn again from the LM phase's seed: both
# models do not fit at once).
MESH_PHASES = (
    MeshPhase("qwen1.5-32b decode_32k mesh 1x4", "qwen1.5-32b", "decode_32k", "1x4", 4, 2048, 8,
              None, ("shard",)),
    MeshPhase("qwen3-moe-30b-a3b decode_32k mesh 1x4", "qwen3-moe-30b-a3b", "decode_32k", "1x4", 8,
              2048, 8, None, ("shard", "slot")),
)
# The recsys serving path: every recsys arch of the zoo at its published
# widths (``CFG``), seeded random weights, at the family's serving cells
# (``configs/base.py::recsys_cells``): serve_p99 (512 rows, P99_CALLS timed
# calls), serve_bulk (262,144 rows, in slices of SERVE_SLICE_ROWS) and
# retrieval_cand (1 query x 10⁶ candidates).  No cut.
RECSYS_ARCHS = ("dien", "mind", "dcn-v2", "bert4rec")
P99_CALLS = 20
RETRIEVAL_CALLS = 5
# The card against the port on the CPU: the first rows and candidates.
CPU_CHECK_ROWS = 512
CPU_CHECK_CANDIDATES = 10_000
# Scores within RECSYS_RTOL·|want| + RECSYS_ATOL_SHARE·max|want|: the
# tolerance of tests/test_torch_recsys.py (float32 sums in another order).
RECSYS_RTOL, RECSYS_ATOL_SHARE = 2e-5, 2e-6
# The filtered retrieval: the retrieval_cand cell's 10⁶ items, attributes
# as examples/search_service.py:60-68 draws them (2,000 attributes, Zipf
# 1.1, 3-19 draws an item), its filters: one attribute, the example's pair
# and triple (and a rare pair, from the data).  Filtered and unfiltered
# top-10 scores may swap items whose scores lie within TIE_RTOL of the
# largest score.
N_ITEMS = 1_000_000
ITEM_SEED = 0
N_ATTRS = 2000
ATTR_ZIPF = 1.1
ATTR_DRAWS = (3, 20)
FILTERS = {"one attribute": (3,), "example pair": (3, 17), "example triple": (3, 17, 8)}
TIE_RTOL = 1e-6
SOURCES = {
    "segment_fold": ("src/repro_torch/csrc/fold.cu", "src/repro/core/device_engine.py:396"),
    "intersect_members_kernel": (
        "src/repro_torch/csrc/intersect.cu", "src/repro/kernels/intersect/kernel.py:182"),
    "intersect_members_count_kernel": (
        "src/repro_torch/csrc/intersect.cu", "src/repro/kernels/intersect/kernel.py:203"),
    "intersect_count_kernel": (
        "src/repro_torch/csrc/intersect.cu", "src/repro/kernels/intersect/kernel.py:223"),
    "cluster_scores_kernel": (
        "src/repro_torch/csrc/cluster_score.cu", "src/repro/kernels/cluster_score/kernel.py:67"),
    "cluster_scores_staged": (
        "src/repro_torch/csrc/cluster_score.cu", "src/repro/kernels/cluster_score/kernel.py:67"),
    "flash_attention_kernel": (
        "src/repro_torch/csrc/flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:95"),
    "flash_attention_sm90": (
        "src/repro_torch/csrc/flash_attention_sm90.cu",
        "src/repro/kernels/flash_attention/kernel.py:95"),
    "flash_attention_decode": (
        "src/repro_torch/csrc/flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:95"),
    "flash_attention_combine": (
        "src/repro_torch/csrc/flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:95"),
    "flash_attention_resident": (
        "src/repro_torch/csrc/flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:95"),
    "flash_attention_general": (
        "src/repro_torch/csrc/flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:95"),
    # The backward replaces no Pallas kernel: XLA's gradient of the jnp
    # attention the JAX package trains through.
    **{name: ("src/repro_torch/csrc/flash_attention_bwd.cu",
              "none (XLA's gradient of src/repro/models/layers.py:97 attention)")
       for name in ("flash_bwd_prep", "flash_bwd_dkdv", "flash_bwd_dq")},
    **{name: ("src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
              "none (XLA's gradient of src/repro/models/layers.py:97 attention)")
       for name in ("flash_bwd_dkdv_sm90", "flash_bwd_dq_sm90")},
    "flash_bwd_resident": ("src/repro_torch/csrc/flash_attention_bwd_resident.cu",
                           "none (XLA's gradient of src/repro/models/layers.py:97 attention)"),
    # PNA's aggregation replaces no Pallas kernel: XLA's segment_sum and
    # segment_max (and their gradients) in the reference.
    **{name: ("src/repro_torch/csrc/segment_aggregate.cu",
              "none (XLA segment_sum/segment_max of src/repro/models/pna.py:73 _aggregate)")
       for name in ("segment_aggregate_fwd", "segment_aggregate_bwd")},
}
SEARCH_KERNELS = ("segment_fold", "intersect_members_kernel", "intersect_members_count_kernel",
                  "intersect_count_kernel")
# Terms of the queries that take the fold past one launch's 64 stages.
DEEP_QUERY_TERMS = (70, 131)
# The serving tier: shard slots on the one card, and the replays' arrival
# rates (benchmarks/bench_serving.py's settings: 2,000 queries a log, the
# deadline batcher at max_batch 64 and 2 ms).
TIER_SHARDS = 4
TIER_QPS = (2000.0, 8000.0)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean ms per call on the card (CUDA events, after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device ms per call without the host's launch cost: ``reps`` calls
    captured in one CUDA graph (after a warm-up on a side stream), replayed
    once between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def max_abs_err(a, b) -> int:
    """Largest integer difference of two int tensors (0 when equal); raises
    when shapes differ."""
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max().item())


def assert_equal(name: str, got, want) -> int:
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max |err| {err})")
    return err


def assert_close(name: str, got, want) -> float:
    """Largest |got - want| of two float tensors; raises when shapes
    differ, when ``got`` is not finite, or when an element lies outside
    ``SCORE_ATOL + SCORE_RTOL·|want|``."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    if got.numel() == 0:
        return 0.0
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs()
    if bool((err > SCORE_ATOL + SCORE_RTOL * want.abs()).any()):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version beyond rtol={SCORE_RTOL}, "
            f"atol={SCORE_ATOL} (max |err| {float(err.max())})")
    return float(err.max())


# ----------------------------------------------------------------------
# Kernels against their plain versions on random and edge-case inputs
# ----------------------------------------------------------------------


def _rows(rng, b, ls, ll, universe, holes=False):
    from repro_torch.kernels.intersect.ref import PAD

    short = np.full((b, ls), PAD, np.int32)
    long = np.full((b, ll), PAD, np.int32)
    for r in range(b):
        ns, nl = int(rng.integers(0, ls + 1)), int(rng.integers(0, ll + 1))
        s = np.sort(rng.choice(universe, size=min(ns, universe), replace=False))
        l = np.sort(rng.choice(universe, size=min(nl, universe), replace=False))
        short[r, : len(s)] = s
        long[r, : len(l)] = l
    if holes:
        short[rng.random(short.shape) < 0.3] = PAD
    return short, long


def check_intersect_cases(torch, dev) -> None:
    from repro_torch.kernels.intersect import kernel as K
    from repro_torch.kernels.intersect import ref as R
    from repro_torch.kernels.intersect.ref import PAD

    rng = np.random.default_rng(0)
    shapes = [(1, 16, 64), (8, 128, 128), (5, 100, 300), (16, 128, 512),
              (3, 257, 1000), (7, 1, 1), (4, 33, 0), (0, 8, 8), (6, 0, 5)]
    cases = []
    for b, ls, ll in shapes:
        cases.append(_rows(rng, b, ls, ll, universe=max(4 * ll, 8)))
        cases.append(_rows(rng, b, ls, ll, universe=max(4 * ll, 8), holes=True))
    all_pad = np.full((8, 128), PAD, np.int32)
    cases.append((all_pad, all_pad.copy()))
    ident = np.sort(rng.choice(1 << 20, size=(3, 200), replace=False).reshape(3, 200), axis=1).astype(np.int32)
    cases.append((ident, ident.copy()))
    for short_np, long_np in cases:
        s = torch.from_numpy(short_np).to(dev)
        l = torch.from_numpy(np.ascontiguousarray(long_np)).to(dev)
        hit = R.intersect_members_ref(s, l)
        assert_equal("intersect_members_kernel", K.intersect_members_cuda(s, l),
                     torch.where(hit, s, int(PAD)))
        assert_equal("intersect_members_count_kernel", K.intersect_members_count_cuda(s, l),
                     hit.sum(dim=1).to(torch.int32))
        # the count kernel's contract: short rows sorted, PAD last
        s_sorted = torch.sort(s, dim=1).values
        assert_equal("intersect_count_kernel", K.intersect_count_cuda(s_sorted, l),
                     R.intersect_count_ref(s_sorted, l))
    torch.cuda.synchronize()
    print(f"intersect trio: {len(cases)} random/edge cases equal to the plain versions")


def check_fold_cases(torch, dev) -> None:
    """A fold plan over an L = 3 hierarchy with arities 1-5 (duplicate and
    absent terms included), with and without members; the hand-built
    layouts; and queries past the 64 stages of one launch."""
    from repro_torch.core.batched_query import plan_segment_pairs
    from repro_torch.core.device_engine import (device_index, lower_plan, plan_shape_key,
                                                warm_fold)
    from repro_torch.core.queries import ConjunctiveQueries
    from repro_torch.core.seclud import SecludPipeline
    from repro_torch.data.corpus import CorpusSpec, synth_corpus
    from repro_torch.data.query_log import synth_query_log
    from repro_torch.kernels import build as B
    from repro_torch.kernels.intersect import kernel as K
    from repro_torch.kernels.intersect.ref import segment_fold_ref

    corpus = synth_corpus(CorpusSpec(n_docs=3000, n_terms=4000, mean_doc_len=40,
                                     n_topics=8, topicality=0.6, seed=7))
    log = synth_query_log(corpus, n_queries=200, seed=3, arity=[1, 2, 3, 4, 5])
    res = SecludPipeline(tc=800, doc_grained_below=256, seed=0).fit(
        corpus, k=12, log=log, levels=3, device=dev)
    di = device_index(res.hier_index, dev)
    rng = np.random.default_rng(5)
    lists = [list(map(int, t)) for t in log.as_conjunctive()]
    for _ in range(40):
        a = int(rng.integers(1, 6))
        t = rng.integers(0, corpus.n_terms, a).tolist()
        if a >= 2:
            t[1] = t[0]
        lists.append(t)
    batches = [ConjunctiveQueries.from_lists(lists),
               ConjunctiveQueries.from_lists([x[:1] for x in lists])]
    n_checked = 0
    keys = []
    for cq in batches:
        plan = plan_segment_pairs(di.host, cq, track_work=False)
        low = lower_plan(plan)
        keys.append(plan_shape_key(low))
        cells = torch.from_numpy(low.cells).to(dev)
        seg = torch.from_numpy(low.stage_seg).to(dev)
        for members in (False, True):
            args = (di.post_docs, cells, seg, low.group_width, low.stage_iters,
                    low.n_queries_pad, members)
            got, want = K.segment_fold_cuda(*args), segment_fold_ref(*args)
            for g, w in zip(got, want, strict=True):
                if w is not None:
                    assert_equal("segment_fold", g, w)
            n_checked += 1
    # Hand-built layouts (tests/_torch_parity.FOLD_CASES): groups across
    # warp and block edges, long segments, empty segments, PAD holes, chains
    # that thin out, shallow depths, queries beyond a block's count table;
    # the kernel equal to the plain version and to the CPU emulation of its
    # algorithm, twice.
    from _torch_parity import FOLD_CASES, fold_emulation, synthetic_fold_case

    atomics = {}
    for name, spec in FOLD_CASES.items():
        case = synthetic_fold_case(**spec)
        host = [torch.from_numpy(case[key]) for key in ("post_docs", "cells", "stage_seg")]
        rest = (case["group_width"], case["stage_iters"], case["n_queries_pad"], True)
        args = tuple(t.to(dev) for t in host) + rest
        got, again, want = K.segment_fold_cuda(*args), K.segment_fold_cuda(*args), segment_fold_ref(*args)
        *emulated, stats = fold_emulation(*host, *rest)
        for g, a, w, e in zip(got, again, want, emulated, strict=True):
            assert_equal("segment_fold", g, w)
            assert_equal("segment_fold (second launch)", a, g)
            assert_equal("segment_fold (emulation)", g.cpu(), e)
        atomics[name] = stats["count_atomics"]
        n_checked += 1
    # Queries deeper than the 64 stages one launch takes: 70 and 131 terms
    # of the longest documents (each matches at least its document), folded
    # by chained launches, equal to the plain version and the emulation,
    # and through the device engine equal to the host engine.
    from repro_torch.core.batched_query import batched_query
    from repro_torch.core.device_engine import device_counts

    lens = corpus.doc_lengths()
    deep = []
    for n, d in zip(DEEP_QUERY_TERMS, np.argsort(-lens, kind="stable"), strict=False):
        terms = corpus.doc_terms[corpus.doc_ptr[d] : corpus.doc_ptr[d + 1]]
        if len(terms) < n:
            raise AssertionError(f"no document of {n} terms for the deep fold check")
        deep.append([int(t) for t in terms[:n]])
    cq = ConjunctiveQueries.from_lists(deep)
    low = lower_plan(plan_segment_pairs(di.host, cq, track_work=False))
    host = (di.post_docs.cpu(), torch.from_numpy(low.cells), torch.from_numpy(low.stage_seg))
    rest = (low.group_width, low.stage_iters, low.n_queries_pad, True)
    before = B.LAUNCHES["segment_fold"]
    got = K.segment_fold_cuda(di.post_docs, *(t.to(dev) for t in host[1:]), *rest)
    chained = B.LAUNCHES["segment_fold"] - before
    if chained != K.fold_launches(low.n_stages) or chained < 2:
        raise AssertionError(f"{low.n_stages} stages took {chained} fold launches")
    *emulated, _stats = fold_emulation(*host, *rest)
    for g, w, e in zip(got, segment_fold_ref(*host, *rest), emulated, strict=True):
        assert_equal("segment_fold (past 64 stages)", g.cpu(), w)
        assert_equal("segment_fold (past 64 stages, emulation)", g.cpu(), e)
    counts, docs, _info = device_counts(di.host, cq, return_docs=True, device=dev)
    ptr, host_docs, _work = batched_query(di.host, cq)
    if not (np.array_equal(counts, np.diff(ptr)) and np.array_equal(docs, host_docs)):
        raise AssertionError("device engine disagrees with host past 64 stages")
    # Each of these plans' shape keys on dead content (all-PAD cells):
    # warm_fold raises if the kernel counts anything.
    for key in keys + [plan_shape_key(low)]:
        warm_fold(di, key, return_members=True)
    torch.cuda.synchronize()
    print(f"segment_fold: {n_checked} plans (fitted L=3 index, arities 1-5; hand-built layouts, "
          f"3 of them past 64 stages) equal to the plain version, twice; global count atomics "
          f"(emulated) {atomics}; queries of {DEEP_QUERY_TERMS} terms ({low.n_stages} stages, "
          f"{chained} chained launches) equal to the plain version, the emulation and the host "
          f"engine (counts {counts.tolist()}); dead cells of {len(keys) + 1} shape keys "
          f"count nothing")


def serving_tier(torch, svc, logs, corpus, n_queries):
    """The serving tier over the search path's fit, through the launcher's
    functions, on ``TIER_SHARDS`` slots of the card; each part with the
    counters set to 0 just before it and read just after.  Raises on any
    wrong answer, on a fold launch count other than one per shard and
    non-empty batch, and on a clean batch served off the device rung."""
    from repro_torch.kernels import build as B
    from repro_torch.launch import search

    S = TIER_SHARDS
    out = {"n_shards": S}
    t_start = time.perf_counter()
    tier = search.sharded_service(svc, S)
    B.reset_launch_counts()
    served = search.serve_sharded(tier, logs, {})
    torch.cuda.synchronize()
    launches = {name: B.LAUNCHES[name] for name in SEARCH_KERNELS}
    n_batches = sum(served[f"sharded_{name}"]["n_batches"] for name in logs)
    if launches["segment_fold"] != S * n_batches:
        raise AssertionError(f"{launches['segment_fold']} fold launches for {n_batches} "
                             f"batches on {S} shards")
    counting = launches["intersect_count_kernel"] + launches["intersect_members_count_kernel"]
    if counting != S * len(logs):
        raise AssertionError(f"block path over {S} devices: {counting} count launches")
    print(f"sharded serving: {S} slots of one card, {n_batches} batches, launches {launches}",
          flush=True)
    out["sharded"], out["sharded_launches"] = served, launches

    def counted(infos):
        def engine(queries):
            t0 = time.perf_counter()
            res = tier.serve_counts_device(queries)
            infos.append({**res[-1], "service_s": time.perf_counter() - t0})
            return res
        return engine

    spans = {"sharded_serving_s": time.perf_counter() - t_start}
    for rate in TIER_QPS:
        t0 = time.perf_counter()
        log = search.traffic_log(corpus, n_queries, rate)
        infos = []
        B.reset_launch_counts()
        rep = search.replay_sealed(tier, log, engine=counted(infos))
        torch.cuda.synchronize()
        folds = B.LAUNCHES["segment_fold"]
        calls = [info["n_kernel_calls"] for info in infos]
        nonempty = sum(1 for c in calls if c)
        if set(calls) - {0.0, float(S)} or folds != S * nonempty or len(calls) != rep["n_batches"]:
            raise AssertionError(f"replay at {rate:g} qps: {folds} fold launches for {nonempty} "
                                 f"non-empty of {rep['n_batches']} batches")
        rep["fold_launches"], rep["nonempty_batches"] = folds, nonempty
        # A batch's service time on the host clock and its parts (engine info).
        rep["batch_medians_s"] = {key: float(np.median([info[key] for info in infos]))
                                  for key in ("service_s", "t_plan_s", "t_lower_s", "t_fold_s")}
        rep["wall_s"] = time.perf_counter() - t0
        out[f"sealed_r{rate:g}"] = rep
        print(f"  {rate:g} qps: {folds} fold launches = {S} x {nonempty} non-empty batches "
              f"(of {rep['n_batches']}), every batch at the device rung; batch medians (ms) "
              + " ".join(f"{k}={v * 1e3:.3f}" for k, v in rep["batch_medians_s"].items())
              + f"; {rep['wall_s']:.1f}s", flush=True)
    t0 = time.perf_counter()
    log = search.traffic_log(corpus, n_queries, TIER_QPS[0])
    B.reset_launch_counts()
    out[f"async_r{TIER_QPS[0]:g}"] = search.replay_async(tier, log)
    torch.cuda.synchronize()
    out[f"async_r{TIER_QPS[0]:g}"]["fold_launches"] = B.LAUNCHES["segment_fold"]
    spans["async_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log = search.traffic_log(corpus, search.CHAOS_QUERIES, TIER_QPS[0])
    B.reset_launch_counts()
    out.update(search.replay_chaos(svc, log, S))
    torch.cuda.synchronize()
    out["chaos_fold_launches"] = B.LAUNCHES["segment_fold"]
    spans["chaos_s"] = time.perf_counter() - t0
    out["spans_s"] = spans
    print("serving tier spans (s): " + " ".join(f"{k}={v:.1f}" for k, v in spans.items()),
          flush=True)
    return out


def score_inputs(rng, n, l, tc, k):
    """(N, L) ranks with pads (TC and 2**31 - 1) anywhere, an all-pad
    first row and duplicate ranks in the last; p (TC,), tables (TC, K).

    Up to the reference test's L = 128 the tables are standard normal, as
    there.  Above it they are non-negative, as δ⁺ tables are: mixed-sign
    sums over hundreds of slots cancel, and then the fixed tolerance no
    longer bounds the error of an fp32 sum taken in another order."""
    ell = rng.integers(0, tc, size=(n, l)).astype(np.int32)
    holes = rng.random((n, l))
    ell[holes < 0.2] = tc
    ell[(holes >= 0.2) & (holes < 0.3)] = PAD_MAX
    if n and l >= 3:
        ell[0, :] = PAD_MAX
        ell[n - 1, 1:3] = ell[n - 1, 0]
    p = rng.random(tc).astype(np.float32)
    if l <= 128:
        tables = rng.standard_normal((tc, k)).astype(np.float32)
    else:
        tables = rng.random((tc, k)).astype(np.float32)
    return ell, p, tables


def check_cluster_score_cases(torch, dev) -> float:
    """The reference test's shapes, N = 0, L = 0, K = 1, K above 256,
    all-pad rows, pads at 2**31 - 1 and negative, duplicate ranks, TC =
    3000 at K = 8 and K = 256, and the staged variant's edges (K padded to
    a power of two, L in {1, 3, 742}, N = 1, a table just within and just
    beyond its shared-memory budget), each also from an ELL whose base
    sits inside a 16-byte block.  Each case goes through the variant
    ``kernel.score_route`` picks, read from the counters; a second launch
    gives the same bits; the staged variant equals the emulation of its
    summation order (``_torch_parity.staged_scores_emulation``) bit for
    bit."""
    from _torch_parity import staged_scores_emulation
    from repro_torch.kernels import build as B
    from repro_torch.kernels.cluster_score.kernel import cluster_scores_cuda, score_route
    from repro_torch.kernels.cluster_score.ref import cluster_scores_ref

    rng = np.random.default_rng(0)
    shapes = [(4, 8, 32, 4), (16, 128, 128, 8), (10, 50, 300, 33), (32, 64, 1024, 128),
              (0, 8, 32, 4), (6, 0, 32, 4), (9, 40, 64, 1), (20, 100, 500, 300),
              (1000, 742, 3000, 8), (2000, 742, 3000, 256), (3000, 1, 3000, 1),
              (3000, 3, 3000, 2), (500, 742, 3000, 7), (500, 742, 3000, 9), (1, 742, 3000, 8),
              (200, 742, 6144, 8), (200, 742, 6145, 8), (200, 50, 3072, 16), (200, 50, 3073, 16)]
    err, routes = 0.0, {"staged": 0, "general": 0}
    for n, l, tc, k in shapes:
        for offset in (0, 1):
            ell, p, tables = score_inputs(rng, n + offset, l, tc, k)
            if n and l:
                ell[-1, -1] = -3
            ell, p, tables = torch.from_numpy(ell).to(dev)[offset:], *(
                torch.from_numpy(a).to(dev) for a in (p, tables))
            route = score_route(tc, k)
            before = dict(B.LAUNCHES)
            got = cluster_scores_cuda(ell, p, tables)
            launched = {v: B.LAUNCHES[f"cluster_scores_{v}"] - before[f"cluster_scores_{v}"]
                        for v in routes}
            if launched != {v: int(bool(n) and v == route) for v in routes}:
                raise AssertionError(f"cluster_scores {n, l, tc, k}: launched {launched}, "
                                     f"route {route}")
            routes[route] += int(bool(n))
            err = max(err, assert_close("cluster_scores_kernel", got,
                                        cluster_scores_ref(ell, p, tables)))
            assert_equal_float("cluster_scores_kernel (second launch)",
                               cluster_scores_cuda(ell, p, tables), got)
            if route == "staged":
                assert_equal_float("cluster_scores_staged (emulated order)", got.cpu(),
                                   staged_scores_emulation(ell.cpu(), p.cpu(), tables.cpu(),
                                                           (ell.data_ptr() // 4) % 4))
            if n and l >= 3 and offset == 0 and bool(got[0].any()):
                raise AssertionError("cluster_scores_kernel: an all-pad row is not zero")
    tc, k = 16, 4
    ell = torch.tensor([[3, 3, 3, tc, PAD_MAX]], dtype=torch.int32, device=dev)
    p = torch.arange(1, tc + 1, dtype=torch.float32, device=dev)
    tables = torch.eye(tc, k, dtype=torch.float32, device=dev)
    want = torch.zeros((1, k), dtype=torch.float32, device=dev)
    want[0, 3] = 3 * p[3]
    for variant in routes:
        err = max(err, assert_close("cluster_scores_kernel",
                                    cluster_scores_cuda(ell, p, tables, variant=variant), want))
    torch.cuda.synchronize()
    print(f"cluster_scores_kernel: {2 * len(shapes) + 2} random/edge cases within "
          f"rtol={SCORE_RTOL}, atol={SCORE_ATOL} of the plain version (max |err| {err:.3g}), "
          f"launches by variant {routes}, each twice with the same bits, the staged ones "
          "equal to their emulated order", flush=True)
    return err


def assert_equal_float(name: str, got, want) -> None:
    import torch

    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: not bit-equal")


# ----------------------------------------------------------------------
# The clustering path: TopDown with the device K-means
# ----------------------------------------------------------------------


class Spans:
    """Host-clock seconds spent in named functions of the clustering path
    during one run, taken by wrapping them and undone by ``restore``."""

    def __init__(self, torch):
        self.torch = torch
        self.seconds = {}
        self._undo = []

    def _add(self, label, t0):
        self.seconds[label] = self.seconds.get(label, 0.0) + time.perf_counter() - t0

    def wrap(self, owner, attr, label):
        fn = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self._add(label, t0)

        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, fn))

    def wrap_rounds(self, module, label):
        """Time each round that ``module.make_round_fn`` makes, to the end
        of its device work."""
        make = module.make_round_fn

        def timed_make(*args, **kwargs):
            fn = make(*args, **kwargs)

            def timed_round(*rargs):
                t0 = time.perf_counter()
                out = fn(*rargs)
                self.torch.cuda.synchronize()
                self._add(label, t0)
                return out

            return timed_round

        module.make_round_fn = timed_make
        self._undo.append((module, "make_round_fn", make))

    def record_calls(self, owner, attr, describe) -> list:
        """Wrap ``owner.attr`` so each call appends ``describe(*args,
        **kwargs)`` to the returned list (undone by ``restore``)."""
        fn, calls = getattr(owner, attr), []

        def recorded(*args, **kwargs):
            calls.append(describe(*args, **kwargs))
            return fn(*args, **kwargs)

        setattr(owner, attr, recorded)
        self._undo.append((owner, attr, fn))
        return calls

    def restore(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


def device_kmeans(torch, dev, res):
    """TopDown over the host fit's frequent-term view with the device
    K-means as ``kmeans_fn``; returns its report and its launch counts."""
    from repro_torch.core import multilevel
    from repro_torch.core.objective import FrequentTermView, cluster_counts, psi_from_counts
    from repro_torch.core.topdown import topdown_cluster
    from repro_torch.dist import cluster_dist
    from repro_torch.kernels import build as B
    from repro_torch.kernels.cluster_score import ops as score_ops

    view = res.view
    fn = cluster_dist.distributed_kmeans_fn([dev], doc_grained_below=DOC_GRAINED_BELOW)
    calls = {"device_calls": 0, "accepted_rounds": 0, "host_calls": 0}

    def counted(v, k, **kwargs):
        out = fn(v, k, **kwargs)
        if v.n_docs >= kwargs.get("doc_grained_below", DOC_GRAINED_BELOW):
            calls["device_calls"] += 1
            calls["accepted_rounds"] += out.n_iters
        else:
            calls["host_calls"] += 1
        return out

    spans = Spans(torch)
    spans.wrap(cluster_dist, "ell_pack", "ell_pack")
    spans.wrap(cluster_dist, "cluster_counts", "host_psi_check")
    spans.wrap(cluster_dist, "psi_from_counts", "host_psi_check")
    spans.wrap(cluster_dist, "kmeans", "host_kmeans_small_levels")
    spans.wrap(FrequentTermView, "subset", "view_subset")
    for name in ("cluster_counts", "delta_add_tables", "assignment_scores"):
        spans.wrap(multilevel, name, "multilevel_projection")
    spans.wrap_rounds(cluster_dist, "device_rounds")
    score_shapes = spans.record_calls(score_ops, "cluster_scores_cuda", lambda ell, p, tables, **_: (
        int(ell.shape[0]), int(ell.shape[1]), int(tables.shape[0]), int(tables.shape[1]),
        ((ell >= 0) & (ell < tables.shape[0])).sum()))
    B.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        td = topdown_cluster(view, K_CLUSTERS, chi=8, eps=0.1,
                             doc_grained_below=DOC_GRAINED_BELOW, seed=0, kmeans_fn=counted)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        spans.restore()
    launches = dict(B.LAUNCHES)
    if launches["cluster_scores_kernel"] <= 0:
        raise AssertionError("the device TopDown never launched cluster_scores_kernel")
    # every round scores K <= chi = 8 clusters over TC = 3000: the staged variant
    if not (launches["cluster_scores_staged"] == launches["cluster_scores_kernel"]
            == len(score_shapes)) or launches["cluster_scores_general"]:
        raise AssertionError(f"device TopDown: {len(score_shapes)} scoring calls, launches "
                             f"{ {k: v for k, v in launches.items() if 'scores' in k} }")
    labels = td.assign
    if labels.shape != (view.n_docs,) or labels.min() < 0 or labels.max() >= td.k_actual:
        raise AssertionError(f"device TopDown labels outside [0, {td.k_actual})")
    psi = psi_from_counts(cluster_counts(view, labels, td.k_actual), view.p_freq)
    rand = np.random.default_rng(0).integers(0, td.k_actual, view.n_docs)
    psi_random = psi_from_counts(cluster_counts(view, rand, td.k_actual), view.p_freq)
    if not psi < psi_random:
        raise AssertionError(f"device TopDown ψ {psi} does not beat random {psi_random}")
    report = {
        "n_docs": int(view.n_docs), "tc": int(view.tc), "k": K_CLUSTERS,
        "k_actual": int(td.k_actual), "n_splits": int(td.n_splits),
        "psi": float(psi), "psi_host_fit": float(res.psi), "psi_random": float(psi_random),
        "psi_ratio_to_host": float(psi / res.psi), "wall_s": wall_s,
        "host_fit_cluster_time_s": float(res.cluster_time_s),
        "wall_ratio_to_host": wall_s / float(res.cluster_time_s),
        "device_rounds": int(launches["cluster_scores_kernel"]),
        "cluster_scores_launches": int(launches["cluster_scores_kernel"]), **calls,
        "spans_s": spans.seconds,
        "score_shapes": [(n, l, tc, k, int(valid)) for n, l, tc, k, valid in score_shapes],
    }
    return report, launches


def round_check(torch, dev, view):
    """One K-means round over the full ELL at k = 8 from a seeded random
    assignment, through the kernel and through the plain version on the
    card.  Returns the ELL, P and (k, tc) tables on the card and the
    largest score error."""
    from repro_torch.core import torch_ops as T
    from repro_torch.core.objective import cluster_counts
    from repro_torch.kernels.cluster_score.ref import cluster_scores_ref

    k, tc = 8, view.tc
    ell_np, l_pad = T.ell_pack(view)
    ell = torch.from_numpy(ell_np).to(dev)
    p = torch.from_numpy(np.asarray(view.p_freq, np.float32)).to(dev)
    assign_np = np.random.default_rng(0).integers(0, k, view.n_docs).astype(np.int32)
    assign = torch.from_numpy(assign_np).to(dev)
    counts = [T.counts_from_ell(ell, assign, k, tc) for _ in range(2)]
    if not torch.equal(counts[0], counts[1]):
        raise AssertionError("counts_from_ell: two runs on the card differ")
    host_counts = cluster_counts(view, assign_np.astype(np.int64), k)
    if not np.array_equal(counts[0].cpu().numpy(), host_counts):
        raise AssertionError("counts_from_ell: the card's counts differ from the host's")
    tables = [T.delta_add_tables_torch(c, p) for c in counts]
    if not torch.equal(tables[0], tables[1]):
        raise AssertionError("delta_add_tables_torch: the two paths' tables are not bit-equal")
    got = T.scores_from_ell(ell, tables[0], p)  # the kernel
    want = cluster_scores_ref(ell, p, tables[1].T.contiguous())  # the plain version
    err = assert_close("cluster_scores_kernel (round)", got, want)
    a_kernel, a_plain = torch.argmin(got, dim=1), torch.argmin(want, dim=1)
    diff = (a_kernel != a_plain).nonzero().squeeze(1)
    s_plain = want[diff, a_plain[diff]]
    s_kernel = want[diff, a_kernel[diff]]
    far = (s_plain - s_kernel).abs() > SCORE_ATOL + SCORE_RTOL * s_plain.abs()
    if bool(far.any()):
        raise AssertionError("K-means round: assignments differ beyond a near-tie")
    torch.cuda.synchronize()
    n_ties = int(diff.numel())
    print(f"one round at full size ({view.n_docs} x {l_pad}, k={k}): counts equal to the host, "
          f"tables bit-equal, scores within tolerance (max |err| {err:.3g}), "
          f"{n_ties} near-tie documents assigned apart", flush=True)
    return ell, p, tables[0], {"l_pad": int(l_pad), "max_abs_err": err, "near_ties": n_ties}


# ----------------------------------------------------------------------
# Kernel timings at the main path's shapes
# ----------------------------------------------------------------------


def fold_sectors_read(torch, post_docs, cells, seg, group_width, stage_iters) -> int:
    """Distinct sectors of ``post_docs`` that this plan's data needs: each
    real cell's first posting, and every binary-search probe of every live
    cell at every stage inside a non-empty window, replayed with the plain
    version's integer steps.  Probes that several cells share count once."""
    from repro_torch.kernels.intersect.ref import PAD

    n, pad = post_docs.shape[0], int(PAD)
    if n == 0:
        return 0
    per_sector = SECTOR_BYTES // post_docs.element_size()
    post, group, arity = cells[0].long(), cells[1].long(), cells[3]
    real = post != pad
    touched = [post[real].clamp(0, n - 1) // per_sector]
    cur = torch.where(real, post_docs[post.clamp(0, n - 1)], pad)
    group = group.clamp(max=max(group_width - 1, 0))
    for s, iters in enumerate(stage_iters, start=1):
        idx = ((arity > s) & (cur != pad)).nonzero().squeeze(1)
        c = cur[idx]
        cols = seg[:, (s - 1) * group_width : s * group_width].long()
        lo = cols[0][group[idx]]
        hi = lo + cols[1][group[idx]]
        end = hi
        for _ in range(int(iters)):
            mid = (lo + hi) >> 1
            v = post_docs[mid.clamp(max=n - 1)]
            touched.append(mid[lo < hi].clamp(max=n - 1) // per_sector)
            below = v < c
            lo = torch.where(below, mid + 1, lo)
            hi = torch.where(below, hi, mid)
        inside = lo < end
        touched.append(lo[inside].clamp(max=n - 1) // per_sector)
        found = inside & (post_docs[lo.clamp(max=n - 1)] == c)
        cur[idx[~found]] = pad
    return int(torch.unique(torch.cat(touched)).numel())


def fold_rows(torch, svc, logs, launches, batches):
    """The fold at each log's first batch (eager, and as device time from a
    CUDA-graph replay, which the launcher allows since it copies nothing
    from the host), and the excess over the bound summed over every batch
    the search path folded (``batches``: the launcher's arguments, recorded
    while the path ran)."""
    from repro_torch.core.batched_query import plan_segment_pairs
    from repro_torch.core.device_engine import lower_plan
    from repro_torch.core.queries import as_queries
    from repro_torch.kernels.intersect import kernel as K
    from repro_torch.kernels.intersect.ref import segment_fold_ref
    from repro_torch.launch import search

    di = svc.device_index
    dev = di.device
    rows = []
    for name, lg in logs.items():
        cq = as_queries(lg.queries)[:search.SERVE_BATCH]
        low = lower_plan(plan_segment_pairs(di.host, cq, track_work=False))
        cells = torch.from_numpy(low.cells).to(dev)
        seg = torch.from_numpy(low.stage_seg).to(dev)
        args = (di.post_docs, cells, seg, low.group_width, low.stage_iters,
                low.n_queries_pad, True)
        got, want = K.segment_fold_cuda(*args), segment_fold_ref(*args)
        err = max(assert_equal("segment_fold", g, w) for g, w in zip(got, want, strict=True))
        ms = time_ms(lambda: K.segment_fold_cuda(*args))
        device_ms = graph_ms(lambda: K.segment_fold_cuda(*args))
        plain_ms = time_ms(lambda: segment_fold_ref(*args), reps=5)
        # The rest of device_counts' t_fold_s: the plan's upload and the
        # copy of the results back, timed apart from the kernel.
        upload_ms = time_ms(lambda: (torch.from_numpy(low.cells).to(dev),
                                     torch.from_numpy(low.stage_seg).to(dev)), reps=5)
        copyback_ms = time_ms(lambda: [t.cpu() for t in got], reps=5)
        nbytes = fold_bytes(torch, args)
        rows.append({
            "shape": name, "cells": int(low.n_cells), "stages": len(low.stage_iters),
            "stage_iters": list(low.stage_iters), "entering": want[1].cpu().tolist(),
            "bytes": nbytes, "max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": nbytes / MEM_BYTES_PER_S * 1e3,
            "upload_ms": upload_ms, "copyback_ms": copyback_ms,
        })
    # Every batch of the search run: device time against its own bound.
    per_batch = []
    for args in batches:
        bound_ms = fold_bytes(torch, args) / MEM_BYTES_PER_S * 1e3
        per_batch.append({"cells": int(args[1].shape[1]), "stages": len(args[4]),
                          "device_ms": graph_ms(lambda args=args: K.segment_fold_cuda(*args), reps=10),
                          "bound_ms": bound_ms})
    entry = kernel_entry("segment_fold", launches, rows, variant="block-merged counts")
    entry["device_ms"] = rows[0]["device_ms"]
    entry["batches"] = per_batch
    entry["excess_ms"] = sum(b["device_ms"] - b["bound_ms"] for b in per_batch)
    return entry


def fold_bytes(torch, args) -> int:
    """Bytes the fold must move for a plan's data: the cell, segment and
    depth arrays read once, the distinct sectors of post_docs the data
    needs, the counts, stage totals and members written once."""
    _, cells, seg, _, stage_iters, n_queries_pad, _ = args
    sectors = fold_sectors_read(torch, *args[:5])
    return (4 * (cells.numel() + seg.numel()) + 8 * len(stage_iters) + SECTOR_BYTES * sectors
            + 4 * n_queries_pad + 4 * cells.shape[1])


def intersect_rows(torch, svc, logs, launches):
    from repro_torch.kernels.intersect import kernel as K
    from repro_torch.kernels.intersect import ref as R
    from repro_torch.kernels.intersect.ref import PAD
    from repro_torch.launch.search import BLOCK_QUERIES

    dev = svc.device
    packs = {name: svc.pack(lg.queries[:BLOCK_QUERIES]) for name, lg in logs.items()}

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    pairs = [put(b) for b in packs["arity2"].segments]
    mixed = [put(b) for b in packs["arity1to5"].segments]
    cases = {
        # the pairs-only block path: rank 0 against rank 1
        "intersect_count_kernel": (
            pairs[0], pairs[1], K.intersect_count_cuda, R.intersect_count_ref),
        # the mixed fold's first masked stage and its last counted stage
        "intersect_members_kernel": (
            mixed[0], mixed[1], K.intersect_members_cuda,
            lambda s, l: torch.where(R.intersect_members_ref(s, l), s, int(PAD))),
        "intersect_members_count_kernel": (
            mixed[0], mixed[-1], K.intersect_members_count_cuda,
            lambda s, l: R.intersect_members_ref(s, l).sum(dim=1).to(torch.int32)),
    }
    entries = []
    for name, (s, l, kern, plain) in cases.items():
        got, want = kern(s, l), plain(s, l)
        err = assert_equal(name, got, want)
        ms = time_ms(lambda kern=kern, s=s, l=l: kern(s, l))
        plain_ms = time_ms(lambda plain=plain, s=s, l=l: plain(s, l))
        nbytes = (s.numel() + l.numel() + want.numel()) * 4
        entries.append(kernel_entry(name, launches, variant="binary probe", rows=[{
            "shape": f"{tuple(s.shape)} x {tuple(l.shape)}", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": nbytes / MEM_BYTES_PER_S * 1e3,
        }]))
    return entries


def score_bound(ell_numel, tc, k, n, n_valid):
    """Each input read once, the output written once; one multiply-add per
    valid slot and output column.  Returns the bound in ms, what bounds it
    and the bytes."""
    nbytes = 4 * (ell_numel + tc + tc * k + n * k)
    bytes_ms, ops_ms = nbytes / MEM_BYTES_PER_S * 1e3, 2 * n_valid * k / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", nbytes


def cluster_scores_rows(torch, view, ell, p, tables8, launches, checked_err):
    """The top TopDown split's shape (K = 8, the round's own tables) and
    the flat algorithm's (K = 256, tables of a seeded random assignment),
    over the full ELL, each through the variant its route picks (eager
    and as device time from a CUDA-graph replay), with the general
    variant, the first design, re-timed at the same inputs (``old_ms``).
    The entry's ``max_abs_err`` also covers the earlier checks
    (``checked_err``)."""
    import torch.nn.functional as F

    from repro_torch.core import torch_ops as T
    from repro_torch.kernels.cluster_score.kernel import cluster_scores_cuda, score_route
    from repro_torch.kernels.cluster_score.ref import cluster_scores_ref

    tc = view.tc
    assign = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, view.n_docs).astype(np.int32)).to(ell.device)
    tables256 = T.delta_add_tables_torch(T.counts_from_ell(ell, assign, 256, tc), p)
    valid = (ell >= 0) & (ell < tc)
    n_valid = int(valid.sum())
    # The yardstick's inputs: pads mapped to an appended zero row of the
    # table and of P, built once outside its timing.
    ids = torch.where(valid, ell, tc).long()
    weights = torch.cat([p, p.new_zeros(1)])[ids]
    rows = []
    for shape, tables in (("top TopDown split, K=8", tables8), ("flat, K=256", tables256)):
        t = tables.T.contiguous()
        k = t.shape[1]
        route = score_route(tc, k)
        got, want = cluster_scores_cuda(ell, p, t), cluster_scores_ref(ell, p, t)
        err = assert_close("cluster_scores_kernel", got, want)
        t_pad = torch.cat([t, t.new_zeros((1, k))])

        def library(t_pad=t_pad):
            return F.embedding_bag(ids, t_pad, per_sample_weights=weights, mode="sum")

        assert_close("embedding_bag yardstick", library(), want)
        ms = time_ms(lambda t=t: cluster_scores_cuda(ell, p, t))
        device_ms = graph_ms(lambda t=t: cluster_scores_cuda(ell, p, t), reps=10)
        old_ms = time_ms(lambda t=t: cluster_scores_cuda(ell, p, t, variant="general"))
        plain_ms = time_ms(lambda t=t: cluster_scores_ref(ell, p, t), reps=3)
        library_ms = time_ms(library)
        bound_ms, bound_by, nbytes = score_bound(ell.numel(), tc, k, ell.shape[0], n_valid)
        rows.append({
            "shape": f"{shape}: ({ell.shape[0]}, {ell.shape[1]}) x ({tc}, {k})",
            "variant": route, "valid_slots": n_valid, "bytes": nbytes, "ops": 2 * n_valid * k,
            "max_abs_err": err, "ms": ms, "device_ms": device_ms, "old_ms": old_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
        })
    entry = kernel_entry("cluster_scores_kernel", launches, rows, variant=rows[0]["variant"])
    entry["max_abs_err"] = max(entry["max_abs_err"], checked_err)
    entry["device_ms"], entry["old_ms"] = rows[0]["device_ms"], rows[0]["old_ms"]
    return entry


def topdown_score_buckets(torch, dev, score_shapes, launches):
    """The device TopDown's scoring calls (N, L, TC, K, valid slots, as
    recorded while it ran) grouped by N and L rounded up to powers of two
    and by K; each bucket timed once at its median-N call's shape, on ranks
    drawn at that call's share of valid slots (pads elsewhere), through the
    staged variant and the general one (the first design), eager and as
    device time from a CUDA-graph replay, against that shape's bound.
    Returns the buckets and each variant's launches x (time - bound)
    summed over the TopDown, eager and device."""
    from repro_torch.kernels.cluster_score.kernel import cluster_scores_cuda, score_route

    groups = {}
    for n, l, tc, k, n_valid in score_shapes:
        key = (1 << max(n - 1, 0).bit_length(), 1 << max(l - 1, 0).bit_length(), k, tc)
        groups.setdefault(key, []).append((n, l, tc, k, n_valid))
    rng = np.random.default_rng(7)
    buckets = []
    excess = {"staged": 0.0, "general": 0.0, "staged_device": 0.0, "general_device": 0.0}
    for key, calls in sorted(groups.items(), reverse=True):
        n, l, tc, k, n_valid = sorted(calls)[len(calls) // 2]
        share = n_valid / max(n * l, 1)
        ell_np = np.where(rng.random((n, l)) < share, rng.integers(0, tc, (n, l)), tc)
        ell = torch.from_numpy(ell_np.astype(np.int32)).to(dev)
        p = torch.from_numpy(rng.random(tc).astype(np.float32)).to(dev)
        t = torch.from_numpy(rng.random((tc, k)).astype(np.float32)).to(dev)
        bound_ms, bound_by, _nbytes = score_bound(ell.numel(), tc, k, n, int(((ell < tc)).sum()))
        row = {"bucket": list(key[:3]), "launches": len(calls), "shape": [n, l, tc, k],
               "valid_share": share, "route": score_route(tc, k), "bound_ms": bound_ms,
               "bound_by": bound_by}
        for variant in ("staged", "general"):
            def call(v=variant):
                return cluster_scores_cuda(ell, p, t, variant=v)

            row[f"{variant}_ms"] = time_ms(call)
            row[f"{variant}_device_ms"] = graph_ms(call, reps=10)
            excess[variant] += len(calls) * (row[f"{variant}_ms"] - bound_ms)
            excess[f"{variant}_device"] += len(calls) * (row[f"{variant}_device_ms"] - bound_ms)
        buckets.append(row)
    if sum(r["launches"] for r in buckets) != launches["cluster_scores_kernel"]:
        raise AssertionError("TopDown scoring buckets do not cover every launch")
    return buckets, excess


# ----------------------------------------------------------------------
# The LM serving path: flash attention
# ----------------------------------------------------------------------


def plain_attention(q, k, v, causal=True, window=None):
    """The plain version in float32 from the same inputs, cast back to q's
    dtype: what the plain route of the LM path runs (over chunks of query
    rows where the whole score tensor would pass ``SCORE_BYTES``)."""
    from _torch_parity import attention_ref_chunked

    return attention_ref_chunked(q.float(), k.float(), v.float(), causal, window).to(q.dtype)


def global_attention(q, k, v, causal=True, window=None):
    """A fault control: plain attention with the window ignored, so local
    layers attend to every earlier key."""
    return plain_attention(q, k, v, causal, None)


def tail_dropped_attention(q, k, v, causal=True, window=None):
    """A fault control: plain attention without the keys past the last
    whole ``KEY_TILE``: at decode the newest 1-16 tokens, at a prefill of
    whole tiles none."""
    lk = k.shape[2]
    keep = lk - lk % KEY_TILE
    if keep == lk:
        return plain_attention(q, k, v, causal, window)
    if q.shape[2] != 1:
        raise ValueError("the tail control takes one query at a ragged length")
    # The query stays at position lk - 1: its window keeps its lower edge.
    return plain_attention(q, k[:, :, :keep], v[:, :, :keep], causal,
                           None if window is None else window - (lk - keep))


# The LM phases' fault controls: (name, the replay's attention, whether its
# MoE gates are renormalised).  Each must land beyond LOGIT_RTOL.
CONTROLS = {
    "window": ("window ignored on local layers", global_attention, True),
    "tail": ("ragged tail tile of keys dropped", tail_dropped_attention, True),
    "gates": ("MoE gates not renormalised", plain_attention, False),
}


def assert_close_tol(name: str, got, want, tol: float) -> float:
    """Largest |got - want| (in float32); raises when ``got`` is not finite
    or an element lies outside ``tol + tol·|want|``."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    got, want = got.float(), want.float()
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs()
    if bool((err > tol + tol * want.abs()).any()):
        raise AssertionError(f"{name}: disagrees with the plain version beyond rtol=atol={tol} "
                             f"(max |err| {float(err.max())})")
    return float(err.max())


def check_flash_cases(torch, dev) -> dict:
    """Every case of ``FLASH_CASES`` in float32 and bfloat16, half of them
    in the model's strided layout, each through the variant the launcher
    picks (read from the counters); returns the largest error and share of
    the limit per dtype, and the cases per variant."""
    from _torch_parity import (FLASH_CASES, FLASH_VARIANTS, VARIANT_LAUNCHES, flash_close,
                               flash_inputs, p_rounding_term)
    from repro_torch.kernels import build as B
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda, flash_route
    from repro_torch.kernels.flash_attention.ref import attention_ref

    errs, routes = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        err = share = 0.0
        for n, (b, h, hkv, lq, lk, d, causal, window) in enumerate(FLASH_CASES):
            q, k, v = flash_inputs(dev, dtype, b, h, hkv, lq, lk, d, seed=n,
                                   model_layout=n % 2 == 0)
            route = flash_route(dtype, h, hkv, lq, lk, d, causal, window)
            before = {name: B.LAUNCHES[name] for name in FLASH_VARIANTS}
            got = flash_attention_cuda(q, k, v, causal=causal, window=window)
            took = {name: B.LAUNCHES[name] - before[name] for name in FLASH_VARIANTS}
            if took != {name: VARIANT_LAUNCHES[route].get(name, 0) for name in FLASH_VARIANTS}:
                raise AssertionError(f"flash_attention_kernel, case {FLASH_CASES[n]} {dtype}: "
                                     f"launched {took}, the {route} variant expected")
            routes[route] = routes.get(route, 0) + 1
            if got.stride() != q.stride():
                raise AssertionError("flash_attention_kernel: the output lost q's layout")
            want = attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window)
            extra = p_rounding_term(q, k, v, causal, window) if route == "sm90" else None
            try:
                e, sh = flash_close(got, want, extra)
            except AssertionError as exc:
                raise AssertionError(f"flash_attention_kernel ({route}), case {FLASH_CASES[n]} "
                                     f"{dtype}: {exc}") from exc
            err, share = max(err, e), max(share, sh)
            del q, k, v, got, want, extra
        # a window of one key returns that key's value row
        q, k, v = flash_inputs(dev, dtype, 1, 2, 2, 20, 50, 64, seed=99, model_layout=True)
        got = flash_attention_cuda(q, k, v, causal=True, window=1)
        err = max(err, assert_close_tol("flash_attention_kernel (window 1)", got, v[:, :, 30:], 1e-6))
        errs[str(dtype).removeprefix("torch.")] = {"max_abs_err": err, "share_of_limit": share}
    torch.cuda.synchronize()
    print(f"flash_attention_kernel: {len(FLASH_CASES) + 1} random/edge cases in float32 and "
          f"bfloat16 within their limits of the plain version (variants {routes}): " + "; ".join(
              f"{t} max |err| {e['max_abs_err']:.3g} ({e['share_of_limit']:.3g} of the limit)"
              for t, e in errs.items()), flush=True)
    errs["cases_per_variant"] = routes
    return errs


class CheckedPlain:
    """Attention for the plain route: the plain version, in float32 from
    the same inputs and cast to q's dtype.  At every call it also runs the
    kernel on the same inputs and holds it to ``FLASH_TOL`` (plus the
    P-rounding term on the sm90 variant's calls), and, at a decode call
    whose keys end in a ragged tile, reads the tail-dropped control's share
    of the same limit (with the call's number) where a whole tile stays."""

    def __init__(self):
        self.calls, self.max_abs_err, self.share, self.control_shares = 0, 0.0, 0.0, []
        self.share_by_variant = {}

    def __call__(self, q, k, v, causal=True, window=None):
        from _torch_parity import attention_ref_chunked, flash_close, flash_error, p_rounding_term
        from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda, flash_route

        want = attention_ref_chunked(q.float(), k.float(), v.float(), causal, window)
        sm90 = flash_route(q.dtype, q.shape[1], k.shape[1], q.shape[2], k.shape[2], q.shape[3],
                           causal, window) == "sm90"
        extra = p_rounding_term(q, k, v, causal, window) if sm90 else None
        try:
            err, share = flash_close(flash_attention_cuda(q, k, v, causal=causal, window=window),
                                     want, extra)
        except AssertionError as exc:
            raise AssertionError(f"serve path, attention call {self.calls} (q {tuple(q.shape)}, "
                                 f"{k.shape[2]} keys, window {window}): {exc}") from exc
        self.max_abs_err, self.share = max(self.max_abs_err, err), max(self.share, share)
        variant = "sm90" if sm90 else "decode"
        self.share_by_variant[variant] = max(self.share_by_variant.get(variant, 0.0), share)
        if q.shape[2] == 1 and k.shape[2] % KEY_TILE and k.shape[2] > KEY_TILE:
            self.control_shares.append(
                (self.calls, flash_error(tail_dropped_attention(q, k, v, causal, window), want)[1]))
        self.calls += 1
        return want.to(q.dtype)


class RoutingReplay:
    """Teacher-forced routing for a replay of an MoE model, installed as
    ``layers.top_k_routing``: each MoE layer of each model call takes the
    experts the kernel route chose at the same call and layer, with gates
    from this route's own router probabilities, renormalised (or not: a
    fault control).  Where this route's own top-k set differs from the
    forced one it records a routing flip: the token's router-logit gap
    between its k-th and (k+1)-th expert, ``log(p_k / p_k+1)``, and the
    near-tie bound ``ROUTER_TIE_SHARE`` times the spread of its router
    logits, ``log(p_max / p_min)``."""

    def __init__(self, experts, n_layers: int, renormalise: bool = True):
        self.experts, self.n_layers, self.renormalise = iter(experts), n_layers, renormalise
        self.layer_calls, self.flips = 0, []

    def __call__(self, probs, top_k):
        import torch

        forced = next(self.experts)
        vals, own = torch.sort(probs, dim=-1, descending=True, stable=True)
        differ = (own[:, :top_k].sort(dim=1).values != forced.sort(dim=1).values).any(dim=1)
        rows = differ.nonzero().flatten()
        if rows.numel():
            z = torch.log(vals[rows].clamp_min(1e-38))
            gaps = (z[:, top_k - 1] - z[:, top_k]).tolist()
            bounds = (ROUTER_TIE_SHARE * (z[:, 0] - z[:, -1])).tolist()
            for r, gap, bound in zip(rows.tolist(), gaps, bounds, strict=True):
                self.flips.append({"call": self.layer_calls // self.n_layers,
                                   "layer": self.layer_calls % self.n_layers, "token": r,
                                   "gap": gap, "bound": bound})
        self.layer_calls += 1
        gates = probs.gather(1, forced)
        if self.renormalise:
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        return gates, forced


class LogitRecorder:
    """Keeps a float32 copy of the logits of every ``prefill`` and
    ``decode_step`` call made while it is installed, and with an MoE
    ``model`` each MoE layer's experts of that call (call-major, layer
    order: what :class:`RoutingReplay` takes)."""

    def __init__(self, module, model=None):
        self.module, self.model = module, model
        self.logits, self.experts = [], []
        self._fns = {name: getattr(module, name) for name in ("prefill", "decode_step")}
        for name, fn in self._fns.items():
            setattr(module, name, self._wrap(fn))

    def _wrap(self, fn):
        def wrapped(*args, **kwargs):
            logits, cache = fn(*args, **kwargs)
            self.logits.append(logits.detach().float().clone())
            if self.model is not None:
                self.experts.extend(blk.moe.routing.experts for blk in self.model.blocks
                                    if blk.moe is not None)
            return logits, cache
        return wrapped

    def restore(self):
        for name, fn in self._fns.items():
            setattr(self.module, name, fn)


def replay(torch, model, prompts, fed, attention, routing=None):
    """The serve run again with attention through ``attention`` (and with
    ``routing`` as the MoE layers' ``top_k_routing``), fed the tokens
    ``fed`` (requests, steps) instead of its own: the logits of the
    prefill and of every step."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    dev = fed.device
    kernel_attention, L.flash_attention = L.flash_attention, attention
    own_routing = L.top_k_routing
    if routing is not None:
        L.top_k_routing = routing
    try:
        cache = T.init_cache(model.cfg, fed.shape[0], prompts.shape[1] + fed.shape[1], dev)
        logits = [T.prefill(model, torch.from_numpy(prompts).to(dev), cache)[0].float()]
        for s in range(fed.shape[1]):
            logits.append(T.decode_step(model, fed[:, s:s + 1], cache)[0].float())
        torch.cuda.synchronize()
        del cache
        return logits
    finally:
        L.flash_attention, L.top_k_routing = kernel_attention, own_routing


def logit_rel_errs(got, want) -> list:
    """max |a - b| / max |b| of each call's logits."""
    return [float((a - b).abs().max()) / float(b.abs().max())
            for a, b in zip(got, want, strict=True)]


def lm_phase(torch, dev, phase: LMPhase):
    """One LM serving phase through ``launch/serve.py``'s own ``setup`` and
    ``serve`` (counters set to 0 just before ``serve`` and read just
    after), then the same run with attention through the plain version
    (the kernel held to it at every call) and through the phase's faulty
    controls, fed the kernel route's tokens; an MoE model's replays also
    take the kernel route's experts (:class:`RoutingReplay`).  Returns its
    report and the attention kernel's launch count."""
    from _torch_parity import FLASH_VARIANTS
    from repro_torch.kernels import build as B
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    argv = ["--arch", phase.arch, "--config", "full", "--requests", str(phase.requests),
            "--prompt-len", str(phase.prompt_len), "--decode-steps", str(phase.steps),
            "--device", "cuda"]
    argv += ["--cell", phase.cell] if phase.cell else []
    argv += ["--layers", str(phase.layers)] if phase.layers else []
    args = serve.build_parser().parse_args(argv)
    resident = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    model, prompts = serve.setup(args)
    init_s = time.perf_counter() - t0
    cfg = model.cfg
    n_moe = sum(blk.moe is not None for blk in model.blocks)
    torch.cuda.reset_peak_memory_stats(dev)
    rec = LogitRecorder(T, model if n_moe else None)
    B.reset_launch_counts()
    try:
        report = serve.serve(model, prompts, args.decode_steps)
    finally:
        rec.restore()
    torch.cuda.synchronize()
    launches = {name: B.LAUNCHES[name] for name in ("flash_attention_kernel", *FLASH_VARIANTS)}
    peak_bytes = torch.cuda.max_memory_allocated(dev)
    calls = 1 + args.decode_steps
    expected = cfg.n_layers * calls
    # One call a layer a model call: the prefill's on the sm90 variant, each
    # decode step's on the split-K variant and its combine.
    design = {"flash_attention_kernel": expected, "flash_attention_sm90": cfg.n_layers,
              "flash_attention_decode": cfg.n_layers * args.decode_steps,
              "flash_attention_combine": cfg.n_layers * args.decode_steps,
              "flash_attention_resident": 0, "flash_attention_general": 0}
    if launches != design:
        raise AssertionError(f"{phase.name}: attention launches {launches}, the design gives "
                             f"{design}")
    tokens = report["tokens"]
    if tokens.shape != (args.requests, args.decode_steps) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab:
        raise AssertionError(f"{phase.name}: tokens of shape {tokens.shape} outside [0, vocab)")
    kernel_logits = rec.logits
    if len(kernel_logits) != calls or not all(bool(x.isfinite().all()) for x in kernel_logits):
        raise AssertionError(f"{phase.name}: non-finite logits or a model call missing")
    if n_moe and len(rec.experts) != n_moe * calls:
        raise AssertionError(f"{phase.name}: {len(rec.experts)} MoE routings recorded")

    # The plain route and the fault controls, teacher-forced with the
    # kernel route's tokens (and experts).
    fed = torch.from_numpy(tokens).to(dev)
    checked = CheckedPlain()
    routing = RoutingReplay(rec.experts, n_moe) if n_moe else None
    plain_logits = replay(torch, model, prompts, fed, checked, routing)
    rel_errs = logit_rel_errs(kernel_logits, plain_logits)
    controls = {}
    for key in phase.controls:
        name, attention, renormalise = CONTROLS[key]
        forced = RoutingReplay(rec.experts, n_moe, renormalise) if n_moe else None
        controls[name] = logit_rel_errs(replay(torch, model, prompts, fed, attention, forced),
                                        plain_logits)
    print(f"{phase.name} logits against the plain route (max |a - b| / max |b| per call, limit "
          f"{LOGIT_RTOL}): kernel route {max(rel_errs):.4g}; " + "; ".join(
              f"{name} {max(errs):.4g}" for name, errs in controls.items()), flush=True)
    shares = checked.control_shares
    first_step = [share for call, share in shares if cfg.n_layers <= call < 2 * cfg.n_layers]
    flagged = sum(share > 1.0 for _, share in shares)
    print(f"{phase.name} attention calls of the plain route: the kernel on the same inputs "
          f"within {checked.share:.3g} of its limit (max |err| {checked.max_abs_err:.3g}; by "
          f"variant {checked.share_by_variant}) at {checked.calls} calls; the tail-dropped "
          f"control beyond it at {flagged} of {len(shares)} ragged decode calls "
          f"({min(s for _, s in shares):.3g}-{max(s for _, s in shares):.3g} of it)", flush=True)
    if checked.calls != expected:
        raise AssertionError(f"{phase.name}: {checked.calls} checked attention calls, not "
                             f"{expected}")
    if not first_step or max(first_step) <= 1.0:
        raise AssertionError(f"{phase.name}: the per-call check cannot tell the tail-dropped "
                             f"control at the first decode step")
    if max(rel_errs) > LOGIT_RTOL:
        raise AssertionError(f"{phase.name}: logits differ from the plain route by "
                             f"{max(rel_errs):.3g} of their largest value (limit {LOGIT_RTOL})")
    for name, errs in controls.items():
        if max(errs) <= LOGIT_RTOL:
            raise AssertionError(f"{phase.name}: the control '{name}' reads {max(errs):.3g}, "
                                 f"within the limit {LOGIT_RTOL}: the comparison cannot tell it")
    flips = routing_flips(phase.name, routing, calls) if n_moe else None
    near_ties = []
    for s, b in enumerate(plain_logits[:args.decode_steps]):
        plain_top = b.argmax(dim=1)
        kern_tok = fed[:, s].long()
        for r in (plain_top != kern_tok).nonzero().flatten().tolist():
            gap = float(b[r, plain_top[r]] - b[r, kern_tok[r]])
            if gap > LOGIT_RTOL * float(b[r].abs().max()):
                raise AssertionError(f"{phase.name}: request {r} step {s}: token "
                                     f"{int(kern_tok[r])} is {gap:.4g} below the plain "
                                     f"route's top logit, beyond a near-tie")
            near_ties.append({"request": r, "step": s, "gap": gap})
    checks = {"attention_calls_checked": checked.calls,
              "attention_max_abs_err": checked.max_abs_err,
              "attention_share_of_limit": checked.share,
              "attention_share_of_limit_by_variant": checked.share_by_variant}
    del rec, checked, routing, plain_logits, kernel_logits
    decode_ms = [t * 1e3 for t in report["decode_step_s"]]
    trace = decode_trace(torch, model, prompts, dev)
    out = {
        "arch": cfg.name, "cell": phase.cell, "n_layers": cfg.n_layers,
        "n_params": cfg.n_params(), "kv_quant": cfg.kv_quant, "requests": args.requests,
        "prompt_len": args.prompt_len, "decode_steps": args.decode_steps,
        "cache_len": int(report["cache_len"]), "init_s": init_s,
        "prefill_s": report["prefill_s"], "decode_step_ms": decode_ms,
        "decode_step_ms_median": report["decode_step_s_median"] * 1e3,
        "wall_s": report["wall_s"], "tokens_per_s": report["tokens_per_s"],
        "resident_before_bytes": int(resident), "peak_memory_bytes": int(peak_bytes),
        "attention_launches": launches, "launches_expected": design,
        "logit_rel_err": rel_errs, "logit_rel_err_max": max(rel_errs),
        "control_logit_rel_err": controls, **checks,
        "tail_control_share_of_limit": [share for _, share in shares],
        "dropped_slots": report["dropped_slots"], "routing_flips": flips,
        "near_ties": near_ties, "first_request": tokens[0].tolist(), "decode_trace": trace,
    }
    if cfg.kv_quant:
        out["dequantize"] = dequantize_rows(torch, dev, cfg, args.requests, report["cache_len"],
                                            trace)
    print(f"{phase.name}: {cfg.name} ({cfg.n_layers} layers, {cfg.n_params() / 1e9:.3f} B "
          f"parameters{', int8 KV cache' if cfg.kv_quant else ''}), {args.requests} x "
          f"{args.prompt_len} prompt tokens + {args.decode_steps} steps: "
          f"{out['tokens_per_s']:.1f} tok/s, prefill {out['prefill_s']:.3f} s, median decode "
          f"step {out['decode_step_ms_median']:.2f} ms, peak memory "
          f"{peak_bytes / 2**30:.2f} GiB ({resident / 2**30:.2f} GiB resident before it); "
          f"attention launches {launches} (as designed); {len(near_ties)} near-tie tokens"
          + ("" if report["dropped_slots"] is None else
             f"; dropped slots per model call {report['dropped_slots']}"), flush=True)
    return out, launches
def routing_flips(name, routing, calls) -> dict:
    """Checks the plain replay's routing flips against the near-tie bound
    (``ROUTER_TIE_SHARE``) and returns their count, the calls whose own
    routing agreed with the kernel route's everywhere, and the largest
    gap / bound."""
    if routing.layer_calls != routing.n_layers * calls or next(routing.experts, None) is not None:
        raise AssertionError(f"{name}: the replay took {routing.layer_calls} routings, the kernel "
                             f"route made {routing.n_layers * calls}")
    beyond = [f for f in routing.flips if f["gap"] > f["bound"]]
    if beyond:
        raise AssertionError(f"{name}: {len(beyond)} routing flips beyond a near-tie, the first "
                             f"{beyond[0]}")
    flipped = sorted({f["call"] for f in routing.flips})
    out = {"flips": len(routing.flips), "calls_with_flips": flipped,
           "calls_agreeing": calls - len(flipped),
           "max_gap_share_of_bound": max((f["gap"] / f["bound"] for f in routing.flips),
                                         default=0.0),
           "first": routing.flips[:20]}
    print(f"{name} routing: the plain route's own top-k differs from the kernel route's at "
          f"{out['flips']} token-layers (calls {flipped}), every one a near-tie (gap at most "
          f"{out['max_gap_share_of_bound']:.3g} of its bound); {out['calls_agreeing']} of "
          f"{calls} calls agree everywhere", flush=True)
    return out


# ----------------------------------------------------------------------
# The model axis: LM serving under a (data, model) slot mesh
# ----------------------------------------------------------------------


def mesh_decode_launches(mesh, cfg, batch: int, prompt_len: int, steps: int,
                         cache_len: int) -> int:
    """Split-kernel launches the mesh decode's design gives over a serve
    run: per decode step and layer, one per shard with a key the query
    sees (``layers.decode_shards``; a local layer's window may leave a
    shard none)."""
    from repro_torch.models import layers as L

    shards = L.decode_shards(mesh, batch, cache_len)
    total = 0
    for step in range(steps):
        length = prompt_len + step
        for w in cfg.layer_windows():
            for sd in shards:
                lo = max(sd.pos0, length - w + 1) if w else sd.pos0
                total += min(sd.pos1, length + 1) > lo
    return total


class CheckedMeshDecode:
    """``layers._flash_decode`` (the mesh decode through the kernels),
    held at every call to ``FLASH_TOL`` of ``attention_ref`` in float32
    over the visible prefix of the cache as the layer reads it (an int8
    cache dequantized to the activation dtype), after the call's write."""

    def __init__(self, real):
        self.real, self.calls, self.max_abs_err, self.share = real, 0, 0.0, 0.0

    def __call__(self, q, k_new, v_new, cache, window):
        from _torch_parity import attention_ref_chunked, flash_close
        from repro_torch.models import layers as L

        out = self.real(q, k_new, v_new, cache, window)
        start = 0 if window is None else max(0, cache.length - window)
        k, v = L.cache_read(cache, q.dtype, start)
        want = attention_ref_chunked(q.transpose(1, 2).float(), k.transpose(1, 2).float(),
                                     v.transpose(1, 2).float(), True, window)
        try:
            err, share = flash_close(out.transpose(1, 2), want)
        except AssertionError as exc:
            raise AssertionError(f"mesh decode call {self.calls} ({cache.length} keys, window "
                                 f"{window}): {exc}") from exc
        self.max_abs_err, self.share = max(self.max_abs_err, err), max(self.share, share)
        self.calls += 1
        return out


class OneUlpAttention:
    """``layers.attention`` as it is, but the first decode call's output
    (layer 0 of the first step) has its first element moved by one bf16
    unit in the last place: the smallest change a route can make, whose
    distance from the route as it is reads the logit comparison's floor."""

    def __init__(self, real):
        self.real, self.done = real, False

    def __call__(self, q, k, v, causal=True, window=None):
        import torch

        out = self.real(q, k, v, causal=causal, window=window)
        if q.shape[1] == 1 and not self.done:
            if out.dtype != torch.bfloat16:
                raise ValueError(f"the one-unit witness takes bf16 outputs, not {out.dtype}")
            self.done = True
            out = out.clone()
            out.view(torch.int16).view(-1)[0] ^= 1
        return out


def plain_decode_partials(q, k, v):
    """The mesh decode's split kernel through its plain version (on the
    card's tensors): the plain route of a mesh phase."""
    from repro_torch.kernels.flash_attention.kernel import decode_plan, sm_count
    from repro_torch.kernels.flash_attention.ref import decode_partials_ref

    plan = decode_plan(1, k.shape[2], None, k.shape[0] * k.shape[1],
                       sm_count(q.device.index) if q.is_cuda else 1)
    return decode_partials_ref(q, k, v, True, None, plan)


def plain_decode_combine(ml, acc, dims, dtype):
    """The mesh decode's combine through its plain version."""
    from repro_torch.kernels.flash_attention.ref import combine_ref

    b, h, hkv, lq, _d = dims
    return combine_ref(ml, acc, b, h, hkv, lq, dtype)


def shard_dropped_merge(parts, dims, dtype, device):
    """A fault control: the first shard's partials left out of the merge."""
    return MESH_REAL["_merge_partials"](parts[1:], dims, dtype, device)


def slot_dropped_sum(outs, device):
    """A fault control: model slot 1's expert outputs left out of the sum."""
    return MESH_REAL["_sum_slots"](outs[:1] + outs[2:], device)


# The layers' functions the mesh replays patch, as they are.
MESH_REAL = {}
# The mesh phases' fault controls: name -> the layers' functions replaced.
MESH_CONTROLS = {
    "shard": ("one shard's partials dropped from the combine",
              {"_merge_partials": shard_dropped_merge}),
    "slot": ("one slot's expert outputs left out of the sum", {"_sum_slots": slot_dropped_sum}),
}


def mesh_replay(torch, model, prompts, fed, mesh, patches=None):
    """The serve run again, fed the tokens ``fed`` (requests, steps),
    under ``mesh`` (None: one device) with functions of ``layers``
    replaced by ``patches`` (name -> function; ``top_k_routing`` forces
    MoE routing): the logits of the prefill and of every step, and each
    step's host ms (ending in a device sync)."""
    from repro_torch.dist import sharding as sh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    patches = patches or {}
    own = {name: getattr(L, name) for name in patches}
    dev = fed.device
    for name, fn in patches.items():
        setattr(L, name, fn)
    sh.set_mesh(mesh)
    try:
        cache = T.init_cache(model.cfg, fed.shape[0], prompts.shape[1] + fed.shape[1], dev)
        logits = [T.prefill(model, torch.from_numpy(prompts).to(dev), cache)[0].float()]
        step_ms = []
        for s in range(fed.shape[1]):
            t0 = time.perf_counter()
            logits.append(T.decode_step(model, fed[:, s:s + 1], cache)[0].float())
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        del cache
        return logits, step_ms
    finally:
        sh.set_mesh(None)
        for name, fn in own.items():
            setattr(L, name, fn)


def dense_rule_dropped(experts_per_layer, cfg) -> int:
    """Slots the single-device dispatch's capacity rule, ``int(max(1,
    cf·T·k/E))`` an expert over all T tokens, would drop for these
    routings (one (T, k) tensor a layer of one model call)."""
    import torch

    moe = cfg.moe
    dropped = 0
    for experts in experts_per_layer:
        t = experts.shape[0]
        cap = int(max(1, moe.capacity_factor * t * moe.top_k / moe.n_experts))
        counts = torch.bincount(experts.reshape(-1), minlength=moe.n_experts)
        dropped += int((counts - cap).clamp_min(0).sum())
    return dropped


def mesh_phase(torch, dev, phase: MeshPhase):
    """One LM serving phase under a slot mesh of the card through
    ``launch/serve.py``'s own ``setup``, ``build_mesh`` and ``serve``
    (counters set to 0 just before ``serve`` and read just after: one
    sm90 prefill a layer, then per decode step and layer one split-K
    launch a shard with visible keys and one combine).  Then the same run
    again, fed the served tokens: through the kernels with the mesh
    decode held to ``FLASH_TOL`` at every call (:class:`CheckedMeshDecode`);
    the reference route (a dense model: its single-device route, kernels
    and all; MoE: the plain route under the same mesh, both decode kernels
    and the prefill's attention through their plain versions, the
    kernel route's experts forced); and the phase's faulty controls,
    which must land beyond ``LOGIT_RTOL``.  Returns its report and the
    attention kernels' launch counts."""
    from _torch_parity import FLASH_VARIANTS
    from repro_torch.kernels import build as B
    from repro_torch.kernels.flash_attention.kernel import decode_plan, sm_count
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    MESH_REAL.update({name: getattr(L, name) for name in ("_merge_partials", "_sum_slots")})
    argv = ["--arch", phase.arch, "--config", "full", "--requests", str(phase.requests),
            "--prompt-len", str(phase.prompt_len), "--decode-steps", str(phase.steps),
            "--device", "cuda", "--cell", phase.cell, "--mesh", phase.mesh]
    argv += ["--layers", str(phase.layers)] if phase.layers else []
    args = serve.build_parser().parse_args(argv)
    resident = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    model, prompts = serve.setup(args)
    mesh = serve.build_mesh(args.mesh, dev)
    init_s = time.perf_counter() - t0
    cfg = model.cfg
    n_moe = sum(blk.moe is not None for blk in model.blocks)
    cache_len = args.prompt_len + args.decode_steps
    torch.cuda.reset_peak_memory_stats(dev)
    rec = LogitRecorder(T, model if n_moe else None)
    B.reset_launch_counts()
    try:
        report = serve.serve(model, prompts, args.decode_steps, mesh=mesh)
    finally:
        rec.restore()
    torch.cuda.synchronize()
    launches = {name: B.LAUNCHES[name] for name in ("flash_attention_kernel", *FLASH_VARIANTS)}
    peak_bytes = torch.cuda.max_memory_allocated(dev)
    calls = 1 + args.decode_steps
    decode_design = mesh_decode_launches(mesh, cfg, args.requests, args.prompt_len,
                                         args.decode_steps, cache_len)
    design = {"flash_attention_kernel": cfg.n_layers, "flash_attention_sm90": cfg.n_layers,
              "flash_attention_decode": decode_design,
              "flash_attention_combine": cfg.n_layers * args.decode_steps,
              "flash_attention_resident": 0, "flash_attention_general": 0}
    if launches != design:
        raise AssertionError(f"{phase.name}: attention launches {launches}, the design gives "
                             f"{design}")
    tokens = report["tokens"]
    if tokens.shape != (args.requests, args.decode_steps) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab:
        raise AssertionError(f"{phase.name}: tokens of shape {tokens.shape} outside [0, vocab)")
    kernel_logits = rec.logits
    if len(kernel_logits) != calls or not all(bool(x.isfinite().all()) for x in kernel_logits):
        raise AssertionError(f"{phase.name}: non-finite logits or a model call missing")
    if n_moe and len(rec.experts) != n_moe * calls:
        raise AssertionError(f"{phase.name}: {len(rec.experts)} MoE routings recorded")
    fed = torch.from_numpy(tokens).to(dev)

    # The kernel route again, the mesh decode held to FLASH_TOL at every call.
    checked = CheckedMeshDecode(L._flash_decode)
    checked_logits, _ = mesh_replay(torch, model, prompts, fed, mesh, {"_flash_decode": checked})
    if checked.calls != cfg.n_layers * args.decode_steps:
        raise AssertionError(f"{phase.name}: {checked.calls} mesh decode calls, not "
                             f"{cfg.n_layers * args.decode_steps}")
    replay_err = max(logit_rel_errs(checked_logits, kernel_logits))
    del checked_logits
    print(f"{phase.name}: the mesh decode within {checked.share:.3g} of its limit (max |err| "
          f"{checked.max_abs_err:.3g}) of attention_ref over the dequantized visible prefix at "
          f"all {checked.calls} calls; the replay's logits {replay_err:.3g} from the served ones",
          flush=True)

    # The reference: MoE, the plain route under the same mesh (the
    # prefill's attention and both decode kernels through their plain
    # versions, the prefill's held to the kernel at every call) with the
    # kernel route's experts (the sharded capacity differs from the
    # single-device one), within LOGIT_RTOL; a dense model, its
    # single-device route, kernels and all, and the plain route under the
    # mesh, both within the limit the model's floor gives (FLOOR_MARGIN).
    def forced(renormalise=True):
        return {"top_k_routing": RoutingReplay(rec.experts, n_moe, renormalise)} if n_moe else {}

    checked_plain = CheckedPlain()
    plain_patches = {"flash_attention": checked_plain,
                     "flash_decode_partials": plain_decode_partials,
                     "flash_decode_combine": plain_decode_combine, **forced()}
    plain_logits, _ = mesh_replay(torch, model, prompts, fed, mesh, plain_patches)
    if checked_plain.calls != cfg.n_layers:
        raise AssertionError(f"{phase.name}: {checked_plain.calls} prefill attention calls on "
                             f"the plain route, not {cfg.n_layers}")
    print(f"{phase.name} prefill attention calls of the plain route: the kernel on the same "
          f"inputs within {checked_plain.share:.3g} of its limit (max |err| "
          f"{checked_plain.max_abs_err:.3g}; by variant {checked_plain.share_by_variant}) at "
          f"{checked_plain.calls} calls", flush=True)
    flips = routing_flips(phase.name, plain_patches["top_k_routing"], calls) if n_moe else None
    plain_errs = logit_rel_errs(kernel_logits, plain_logits)
    single = floor = None
    if n_moe:
        reference, limit, ref_logits = ("the plain route under the same mesh and experts",
                                        LOGIT_RTOL, plain_logits)
    else:
        reference = "the single-device route (no mesh, the same kernels)"
        ref_logits, single_step_ms = mesh_replay(torch, model, prompts, fed, None)
        witness = OneUlpAttention(L.attention)
        floor_errs = logit_rel_errs(
            mesh_replay(torch, model, prompts, fed, None, {"attention": witness})[0], ref_logits)
        if not witness.done:
            raise AssertionError(f"{phase.name}: the one-unit witness met no decode call")
        floor = max(floor_errs)
        limit = max(LOGIT_RTOL, FLOOR_MARGIN * floor)
        single = {"plain_logit_rel_err": logit_rel_errs(ref_logits, plain_logits),
                  "step_ms": single_step_ms, "step_ms_median": float(np.median(single_step_ms)),
                  "one_unit_floor_logit_rel_err": floor_errs}
        print(f"{phase.name}: one bf16 unit in one attention output of the first decode call "
              f"moves the single-device route's logits by {floor:.4g} (per call "
              f"{[round(e, 4) for e in floor_errs]}): the limit is max({LOGIT_RTOL}, "
              f"{FLOOR_MARGIN} x {floor:.4g}) = {limit:.4g}", flush=True)
    del plain_logits
    rel_errs = logit_rel_errs(kernel_logits, ref_logits)
    controls = {}
    for key in phase.controls:
        name, patches = MESH_CONTROLS[key]
        controls[name] = logit_rel_errs(
            mesh_replay(torch, model, prompts, fed, mesh, {**patches, **forced()})[0], ref_logits)
    print(f"{phase.name} logits against {reference} (max |a - b| / max |b| per call, limit "
          f"{limit:.4g}): mesh route {max(rel_errs):.4g} (per call "
          f"{[round(e, 4) for e in rel_errs]}); " + "; ".join(
              f"{name} {max(errs):.4g}" for name, errs in controls.items())
          + f"; the mesh route against the plain route under the mesh {max(plain_errs):.4g}"
          + ("" if single is None else f", the single-device route against it "
             f"{max(single['plain_logit_rel_err']):.4g}"), flush=True)
    held = {reference: rel_errs}
    if single is not None:
        held["the plain route under the mesh"] = plain_errs
        held["the plain route (the single-device route's distance)"] = single[
            "plain_logit_rel_err"]
    for what, errs in held.items():
        if max(errs) > limit:
            raise AssertionError(f"{phase.name}: logits differ from {what} by {max(errs):.3g} "
                                 f"of their largest value (limit {limit:.4g})")
    for name, errs in controls.items():
        if max(errs) <= limit:
            raise AssertionError(f"{phase.name}: the control '{name}' reads {max(errs):.3g}, "
                                 f"within the limit {limit:.4g}: the comparison cannot tell it")
    near_ties = []
    for s, b in enumerate(ref_logits[:args.decode_steps]):
        ref_top = b.argmax(dim=1)
        kern_tok = fed[:, s].long()
        for r in (ref_top != kern_tok).nonzero().flatten().tolist():
            gap = float(b[r, ref_top[r]] - b[r, kern_tok[r]])
            if gap > limit * float(b[r].abs().max()):
                raise AssertionError(f"{phase.name}: request {r} step {s}: token "
                                     f"{int(kern_tok[r])} is {gap:.4g} below the reference "
                                     f"route's top logit, beyond a near-tie")
            near_ties.append({"request": r, "step": s, "gap": gap})
    dropped_dense = None
    if n_moe:
        per_call = [rec.experts[c * n_moe:(c + 1) * n_moe] for c in range(calls)]
        dropped_dense = [dense_rule_dropped(e, cfg) for e in per_call]
    del rec, ref_logits, kernel_logits

    # The splits: each shard's plan at the last step, and the combine's total.
    sms = sm_count(dev.index)
    length = cache_len - 1
    shard_plans = []
    for sd in L.decode_shards(mesh, args.requests, cache_len):
        keys = max(0, min(sd.pos1, length + 1) - sd.pos0)
        plan = (decode_plan(1, keys, None, (sd.row1 - sd.row0) * cfg.n_kv_heads, sms)
                if keys else None)
        shard_plans.append({"slot": sd.slot.id, "positions": [sd.pos0, sd.pos1],
                            "visible_keys": keys, "plan": plan})
    combine_splits = sum(p["plan"][3] for p in shard_plans if p["plan"])
    single_plan = decode_plan(1, length + 1, None, args.requests * cfg.n_kv_heads, sms)
    trace = decode_trace(torch, model, prompts, dev, cache_len=cache_len, mesh=mesh)
    decode_ms = [t * 1e3 for t in report["decode_step_s"]]
    out = {
        "arch": cfg.name, "cell": phase.cell, "mesh": mesh.shape, "n_layers": cfg.n_layers,
        "n_params": cfg.n_params(), "kv_quant": cfg.kv_quant, "requests": args.requests,
        "prompt_len": args.prompt_len, "decode_steps": args.decode_steps,
        "cache_len": int(report["cache_len"]), "decode_shards": report["decode_shards"],
        "init_s": init_s, "prefill_s": report["prefill_s"], "decode_step_ms": decode_ms,
        "decode_step_ms_median": report["decode_step_s_median"] * 1e3,
        "single_device_route": single,
        "wall_s": report["wall_s"], "tokens_per_s": report["tokens_per_s"],
        "resident_before_bytes": int(resident), "peak_memory_bytes": int(peak_bytes),
        "attention_launches": launches, "launches_expected": design,
        "shard_plans_last_step": shard_plans, "combine_splits_last_step": combine_splits,
        "single_device_plan_last_step": single_plan,
        "reference": reference, "logit_limit": limit, "logit_floor": floor,
        "logit_rel_err": rel_errs,
        "logit_rel_err_max": max(rel_errs), "plain_route_logit_rel_err": plain_errs,
        "control_logit_rel_err": controls, "replay_logit_rel_err": replay_err,
        "mesh_decode_calls_checked": checked.calls,
        "mesh_decode_max_abs_err": checked.max_abs_err,
        "mesh_decode_share_of_limit": checked.share,
        "prefill_calls_checked": checked_plain.calls,
        "prefill_max_abs_err": checked_plain.max_abs_err,
        "prefill_share_of_limit": checked_plain.share,
        "dropped_slots_sharded_rule": report["dropped_slots"],
        "dropped_slots_dense_rule": dropped_dense, "routing_flips": flips,
        "near_ties": near_ties, "first_request": tokens[0].tolist(), "decode_trace": trace,
    }
    print(f"{phase.name}: {cfg.name} ({cfg.n_layers} layers, {cfg.n_params() / 1e9:.3f} B "
          f"parameters, int8 KV cache) under mesh {mesh.shape}, {args.requests} x "
          f"{args.prompt_len} prompt tokens + {args.decode_steps} steps: "
          f"{out['tokens_per_s']:.1f} tok/s, prefill {out['prefill_s']:.3f} s, median decode "
          f"step {out['decode_step_ms_median']:.2f} ms"
          + ("" if single is None else
             f" (the single-device route's, teacher-forced: {single['step_ms_median']:.2f} ms)")
          + f", peak memory {peak_bytes / 2**30:.2f} GiB "
          f"({resident / 2**30:.2f} GiB resident before it); attention launches {launches} (as "
          f"designed); splits at the last step per shard "
          f"{[p['plan'][3] if p['plan'] else 0 for p in shard_plans]}, combine of "
          f"{combine_splits} (one device: {single_plan[3]}); {len(near_ties)} near-tie tokens"
          + ("" if dropped_dense is None else
             f"; dropped slots per model call, sharded rule {report['dropped_slots']}, "
             f"single-device rule {dropped_dense}"), flush=True)
    return out, launches


def dequantize_rows(torch, dev, cfg, batch, cache_len, trace) -> dict:
    """``layers._dequantize`` of one layer's K and V alone at a decode
    step's shapes: a global layer's whole cache and, with a window, a local
    layer's window; ms (eager and CUDA graph) beside the byte bound (int8
    codes and float32 scales read once, the activation dtype written
    once), and the step's sum over the layers from those times beside the
    traced one."""
    from repro_torch.models import layers as L

    windows = cfg.layer_windows()
    kinds = {"global layer": (cache_len, windows.count(0))}
    if cfg.window is not None:
        kinds["local layer"] = (min(cfg.window, cache_len), len(windows) - windows.count(0))
    rows = {}
    for kind, (keys, layers) in kinds.items():
        gen = torch.Generator(device=dev).manual_seed(keys)
        shape = (batch, keys, cfg.n_kv_heads, cfg.head_dim)
        codes = [torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
                 for _ in range(2)]
        scales = [torch.rand(shape[:-1], generator=gen, device=dev) for _ in range(2)]

        def both(codes=codes, scales=scales):
            return [L._dequantize(q, sc, cfg.adtype) for q, sc in zip(codes, scales)]

        nbytes = 2 * (codes[0].numel() * (1 + cfg.adtype.itemsize) + scales[0].numel() * 4)
        rows[kind] = {"keys": keys, "layers": layers, "bytes": nbytes, "ms": time_ms(both),
                      "device_ms": graph_ms(both), "bound_ms": nbytes / MEM_BYTES_PER_S * 1e3}
        del codes, scales
    step = sum(r["device_ms"] * r["layers"] for r in rows.values())
    out = {"rows": rows, "step_device_ms": step, "traced_ms": trace.get("dequantize_ms")}
    print("dequantize, one layer's K and V at the decode step: " + "; ".join(
        f"{kind} ({r['keys']} keys, x{r['layers']}): {r['ms']:.4f} ms eager, {r['device_ms']:.4f} "
        f"device, bound {r['bound_ms']:.4f} ({r['bytes']} bytes)" for kind, r in rows.items())
        + f"; {step:.3f} ms a step by these times, traced {trace.get('dequantize_ms')}", flush=True)
    return out


# The decode trace's labelled spans: label -> the function of
# ``models.layers`` that it wraps.
TRACE_SPANS = {"dequantize": "_dequantize", "moe": "moe_apply", "expert products": "_expert_ffn"}


def decode_trace(torch, model, prompts, dev, steps: int = 4, cache_len: Optional[int] = None,
                 mesh=None) -> dict:
    """The decode step under ``torch.profiler``: a fresh cache and the
    prompts prefilled (not traced), one warm step, then ``steps`` greedy
    steps traced, with ``TRACE_SPANS``' functions in labelled spans.
    Returns ms per step on the host clock, the device's kernel ms per step
    (the kernels' own events, one stream, so they do not overlap), its
    parts (attention's kernels; each span's kernels, from the launching
    ops under it; MoE dispatch = the MoE span less its expert products;
    the rest), the device's idle share, and the sum of every
    ``key_averages`` entry's self device time (which counts an aten op's
    kernels twice: once under the op, once as the kernel); None where the
    profiler saw no device time.  ``cache_len`` (default: prompt + steps
    + 1 positions) and ``mesh`` (the ambient mesh of the run) serve the
    mesh phases."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    def spanned(fn, label):
        def wrapped(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapped

    from repro_torch.dist import sharding as sh

    sh.set_mesh(mesh)
    cache = T.init_cache(model.cfg, prompts.shape[0], cache_len or prompts.shape[1] + steps + 1,
                         dev)
    logits, cache = T.prefill(model, torch.from_numpy(prompts).to(dev), cache)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    logits, cache = T.decode_step(model, nxt, cache)
    torch.cuda.synchronize()
    originals = {attr: getattr(L, attr) for attr in TRACE_SPANS.values()}
    for label, attr in TRACE_SPANS.items():
        setattr(L, attr, spanned(originals[attr], label))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
                logits, cache = T.decode_step(model, nxt, cache)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    finally:
        for attr, fn in originals.items():
            setattr(L, attr, fn)
        sh.set_mesh(None)
    del cache
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and e.name not in TRACE_SPANS]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    attention_us = sum(e.time_range.elapsed_us() for e in kernels if "flash_" in e.name)
    span_us = {label: sum(e.device_time_total for e in events
                          if e.name == label and e.device_type == DeviceType.CPU)
               for label in TRACE_SPANS}
    key_averages_us = sum(float(getattr(e, "self_device_time_total", 0.0) or 0.0)
                          for e in prof.key_averages())
    if device_us <= 0.0:
        print("decode trace: the profiler saw no device time (not measured)", flush=True)
        return {"step_ms": wall_ms, "device_ms": None, "attention_ms": None, "idle_share": None}
    ms = {label: us / 1e3 / steps for label, us in span_us.items()}
    out = {"step_ms": wall_ms, "device_ms": device_us / 1e3 / steps,
           "attention_ms": attention_us / 1e3 / steps, "dequantize_ms": ms["dequantize"],
           "moe_dispatch_ms": ms["moe"] - ms["expert products"],
           "expert_products_ms": ms["expert products"],
           "idle_share": 1.0 - device_us / 1e3 / steps / wall_ms,
           "key_averages_self_device_ms": key_averages_us / 1e3 / steps}
    out["rest_ms"] = out["device_ms"] - out["attention_ms"] - ms["dequantize"] - ms["moe"]
    print(f"decode trace ({steps} steps, torch.profiler): {out['step_ms']:.2f} ms a step on the "
          f"host clock, device kernels {out['device_ms']:.3f} ms: attention "
          f"{out['attention_ms']:.3f}, dequantize {out['dequantize_ms']:.3f}, MoE dispatch "
          f"{out['moe_dispatch_ms']:.3f}, expert products {out['expert_products_ms']:.3f}, rest "
          f"{out['rest_ms']:.3f}; device idle {out['idle_share']:.1%} (key_averages' self device "
          f"time summed: {out['key_averages_self_device_ms']:.3f} ms)", flush=True)
    return out


def visible_pairs(lq: int, lk: int, causal: bool, window) -> int:
    """(query, key) pairs the masks leave visible, counted exactly."""
    p = np.arange(lq, dtype=np.int64) + (lk - lq)
    hi = np.minimum(p, lk - 1) if causal else np.full(lq, lk - 1, np.int64)
    lo = np.maximum(p - window + 1, 0) if window is not None else np.zeros(lq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


# The attention's shapes on the LM path, timed by ``flash_rows``: (label,
# B, H, Hkv, Lq, Lk, D, window, input copies).  gemma3-4b with the bf16
# cache: a local and a global layer's prefill, a global and a local
# layer's last decode step; qwen3-moe-30b-a3b and arctic-480b (global
# layers): prefill and last decode step; gemma3-4b at decode_32k: a global
# and a local layer's prefill of 32,760 tokens and last decode step (the
# int8 cache hands a local layer its window of keys).  Decode rotates over
# enough copies of its inputs to exceed the L2 cache, as each layer's own
# cache would.
FLASH_ROW_SHAPES = (
    ("gemma3-4b prefill, local layer (window 1024)", 8, 8, 4, 2048, 2048, 256, 1024, 1),
    ("gemma3-4b prefill, global layer", 8, 8, 4, 2048, 2048, 256, 2**30, 1),
    ("gemma3-4b decode, global layer", 8, 8, 4, 1, 2056, 256, 2**30, 4),
    ("gemma3-4b decode, local layer (window 1024)", 8, 8, 4, 1, 2056, 256, 1024, 4),
    ("qwen3-moe-30b-a3b prefill", 8, 32, 4, 2048, 2048, 128, 2**30, 1),
    ("qwen3-moe-30b-a3b decode", 8, 32, 4, 1, 2056, 128, 2**30, 4),
    ("arctic-480b prefill", 8, 56, 8, 2048, 2048, 128, 2**30, 1),
    ("arctic-480b decode (group 7)", 8, 56, 8, 1, 2056, 128, 2**30, 4),
    ("gemma3-4b decode_32k prefill, global layer", 4, 8, 4, 32760, 32760, 256, 2**30, 1),
    ("gemma3-4b decode_32k prefill, local layer (window 1024)", 4, 8, 4, 32760, 32760, 256, 1024,
     1),
    ("gemma3-4b decode_32k decode, global layer", 4, 8, 4, 1, 32768, 256, 2**30, 2),
    ("gemma3-4b decode_32k decode, local layer (its window of keys)", 4, 8, 4, 1, 1024, 256, 1024,
     8),
    ("qwen1.5-32b prefill", 4, 40, 40, 2048, 2048, 128, 2**30, 1),
    ("qwen1.5-32b mesh 1x4 decode, one shard's 514 keys", 4, 40, 40, 1, 514, 128, 2**30, 4),
    ("qwen3-moe-30b-a3b mesh 1x4 decode, one shard's 514 keys", 8, 32, 4, 1, 514, 128, 2**30, 8),
)
# Above this many (query, key) pairs per (B, H) the plain version is timed
# once: at a 32k-token prefill one call takes seconds.
PLAIN_ONCE_PAIRS = 10**8


def flash_rows(torch, dev, launches, checked_errs):
    """The attention at the LM path's shapes (``FLASH_ROW_SHAPES``) in bf16
    (the model's strided layout).  Returns four entries: the attention call
    (``flash_attention_kernel``) at every shape, the sm90 variant at the
    prefill shapes, and the decode variant's split kernel and combine, each
    alone against its plain version, at the decode shapes."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from _torch_parity import attention_ref_chunked, flash_close, flash_inputs, p_rounding_term
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import combine_ref, decode_partials_ref

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    call_rows, sm90_rows, decode_rows, combine_rows = [], [], [], []
    for n, (shape, b, h, hkv, lq, lk, d, window, copies) in enumerate(FLASH_ROW_SHAPES):
        sets = [flash_inputs(dev, torch.bfloat16, b, h, hkv, lq, lk, d, seed=100 + n + c,
                             model_layout=True)
                for c in range(copies)]
        q, k, v = sets[0]
        route = FK.flash_route(q.dtype, h, hkv, lq, lk, d, True, window)
        got = FK.flash_attention_cuda(q, k, v, causal=True, window=window)
        extra = p_rounding_term(q, k, v, True, window) if route == "sm90" else None
        want = attention_ref_chunked(q.float(), k.float(), v.float(), True, window)
        err, share = flash_close(got, want, extra)
        plain = want.to(q.dtype)
        del extra, want
        big = lq * lk > PLAIN_ONCE_PAIRS
        i = torch.arange(lq, device=dev)[:, None] + (lk - lq)
        j = torch.arange(lk, device=dev)[None, :]
        mask = (j <= i) & (j > i - window)
        if big:
            # With a mask and enable_gqa the library may take its math
            # backend, which forms the (B, H, Lq, Lk) scores (137 GB at
            # 32k): here the efficient backend is required, over K/V heads
            # repeated beforehand (not timed).
            kr, vr = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))

            def library_mask(q=q, kr=kr, vr=vr, mask=mask):
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    return F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask)
        else:
            def library_mask(q=q, k=k, v=v, mask=mask):
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)

        # The fastest single call of the same function: no boolean mask
        # where none is needed (it keeps the library off its flash backend).
        if window < lk:
            library, library_call = library_mask, "attn_mask (the window needs it)"
        elif lq == lk:
            library, library_call = (lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)), "is_causal=True"
        else:  # one query at the end of the keys sees every key
            library, library_call = (lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True)), "no mask"
        assert_close_tol("scaled_dot_product_attention yardstick", library_mask(), plain,
                         LIBRARY_TOL)
        assert_close_tol(f"scaled_dot_product_attention ({library_call}) yardstick", library(),
                         plain, LIBRARY_TOL)
        turn = iter(range(10**9))

        def kernel(sets=sets, window=window):
            qq, kk, vv = sets[next(turn) % len(sets)]
            return FK.flash_attention_cuda(qq, kk, vv, causal=True, window=window)

        ms = time_ms(kernel)
        plain_reps = 1 if big else 3
        plain_ms = time_ms(lambda q=q, k=k, v=v, window=window: plain_attention(q, k, v, True, window),
                           reps=plain_reps, warmup=plain_reps)
        library_mask_ms = time_ms(library_mask, reps=5)
        library_ms = library_mask_ms if library is library_mask else time_ms(library, reps=5)
        device = {"ms": graph_ms(kernel), "library_ms": graph_ms(library, reps=5),
                  "library_mask_ms": graph_ms(library_mask, reps=5)}
        pairs = visible_pairs(lq, lk, True, window)
        ops = 4 * b * h * d * pairs
        # Each input read once: q, and the K/V rows some query row sees
        # (a local decode needs the window's 1024 of 2056); o written once.
        visible_keys = lk - max(0, lk - lq - window + 1)
        kv_bytes = 2 * 2 * b * hkv * visible_keys * d
        nbytes = 2 * (q.numel() + got.numel()) + kv_bytes
        bytes_ms, ops_ms = nbytes / MEM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
        row = {
            "shape": f"{shape}: q ({b}, {h}, {lq}, {d}), k/v ({b}, {hkv}, {lk}, {d}) bf16",
            "variant": route, "visible_pairs": pairs, "visible_keys": visible_keys, "ops": ops,
            "bytes": nbytes, "max_abs_err": err, "share_of_limit": share, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "library_call": library_call,
            "library_mask_ms": library_mask_ms, "device_ms": device,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        call_rows.append(row)
        if route == "sm90":
            sm90_rows.append(row)  # the call is the variant's one launch
        else:
            decode_rows.append(decode_split_row(torch, FK, decode_partials_ref, sets, shape,
                                                window, FK.decode_plan(lq, lk, window, b * hkv,
                                                                       sms), q.numel() * 2 + kv_bytes,
                                                ops))
            combine_rows.append(decode_combine_row(torch, FK, combine_ref, sets[0], shape, window,
                                                   decode_rows[-1]["plan"]))
        del sets, q, k, v, got, mask, plain, library, library_mask
        if big:
            del kr, vr
    entries = [kernel_entry("flash_attention_kernel", launches, call_rows,
                            variant=call_rows[0]["variant"]),
               kernel_entry("flash_attention_sm90", launches, sm90_rows, variant="sm90"),
               kernel_entry("flash_attention_decode", launches, decode_rows, variant="decode"),
               kernel_entry("flash_attention_combine", launches, combine_rows, variant="decode")]
    entries[0]["max_abs_err"] = max(entries[0]["max_abs_err"],
                                    *(checked_errs[t]["max_abs_err"] for t in ("float32",
                                                                               "bfloat16")))
    return entries


def decode_split_row(torch, FK, decode_partials_ref, sets, shape, window, plan, in_bytes, ops):
    """The decode variant's split kernel alone against its plain version:
    partials within rtol 1e-4 and 1e-4 of the largest |acc| (fp32 sums in
    another order)."""
    q, k, v = sets[0]
    ml, acc = FK.decode_partials_cuda(q, k, v, True, window, plan)
    want_ml, want_acc = decode_partials_ref(q, k, v, True, window, plan)
    torch.testing.assert_close(ml, want_ml, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(acc, want_acc, rtol=1e-4, atol=1e-4 * float(want_acc.abs().max()))
    err = max(float((ml - want_ml).abs().max()), float((acc - want_acc).abs().max()))
    turn = iter(range(10**9))

    def kernel():
        qq, kk, vv = sets[next(turn) % len(sets)]
        return FK.decode_partials_cuda(qq, kk, vv, True, window, plan)

    ms = time_ms(kernel)
    device_ms = graph_ms(kernel)
    plain_ms = time_ms(lambda: decode_partials_ref(q, k, v, True, window, plan), reps=3)
    # q and the visible K/V rows read once, the fp32 partials written once.
    nbytes = in_bytes + 4 * (ml.numel() + acc.numel())
    bytes_ms, ops_ms = nbytes / MEM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return {"shape": f"{shape}: split-K partials, plan (j_begin, j_end, chunk, splits) {plan}",
            "plan": plan, "bytes": nbytes, "ops": ops, "max_abs_err": err, "ms": ms,
            "device_ms": device_ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def decode_combine_row(torch, FK, combine_ref, qkv, shape, window, plan):
    """The decode variant's combine alone, on the plain version's partials,
    against the plain combine (``FLASH_TOL``: one rounding to bf16)."""
    from _torch_parity import flash_close
    from repro_torch.kernels.flash_attention.ref import decode_partials_ref

    q, k, v = qkv
    b, h, lq, _ = q.shape
    hkv = k.shape[1]
    ml, acc = decode_partials_ref(q, k, v, True, window, plan)
    out = torch.empty_like(q)
    FK.combine_cuda(ml, acc, out, hkv)
    err, _share = flash_close(out, combine_ref(ml, acc, b, h, hkv, lq, torch.float32))
    ms = time_ms(lambda: FK.combine_cuda(ml, acc, out, hkv))
    device_ms = graph_ms(lambda: FK.combine_cuda(ml, acc, out, hkv))
    plain_ms = time_ms(lambda: combine_ref(ml, acc, b, h, hkv, lq, q.dtype), reps=5)
    nbytes = 4 * (ml.numel() + acc.numel()) + 2 * out.numel()
    return {"shape": f"{shape}: combine of {plan[3]} splits", "bytes": nbytes,
            "max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": nbytes / MEM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


# ----------------------------------------------------------------------
# The recsys serving path: dien, mind, dcn-v2, bert4rec and the SeCluD
# filter
# ----------------------------------------------------------------------


def attention_bhld(q, k, v, causal, window):
    """The plain version in float32 on ``layers.attention``'s (B, L, H, D)
    tensors, returned in their layout (over chunks of query rows past
    ``SCORE_BYTES``)."""
    from _torch_parity import attention_ref_chunked

    return attention_ref_chunked(q.transpose(1, 2).float(), k.transpose(1, 2).float(),
                                 v.transpose(1, 2).float(), causal, window).transpose(1, 2)


def plain_route_attention(q, k, v, causal=True, window=None):
    """``layers.attention`` through the plain version: BERT4Rec's plain
    route."""
    return attention_bhld(q, k, v, causal, window).to(q.dtype)


class CheckedKernel:
    """``layers.attention`` through the kernel (the model's own call),
    held at every call to ``FLASH_TOL`` of the plain version on the same
    inputs; keeps the first call's q, k, v (B, H, L, D) when asked."""

    def __init__(self, original, keep_inputs: bool = False):
        self.original, self.keep_inputs = original, keep_inputs
        self.calls, self.max_abs_err, self.share, self.inputs = 0, 0.0, 0.0, None

    def __call__(self, q, k, v, causal=True, window=None):
        from _torch_parity import flash_close

        got = self.original(q, k, v, causal, window)
        try:
            err, share = flash_close(got, attention_bhld(q, k, v, causal, window))
        except AssertionError as exc:
            raise AssertionError(f"bert4rec attention call {self.calls} (q {tuple(q.shape)}): "
                                 f"{exc}") from exc
        self.max_abs_err, self.share = max(self.max_abs_err, err), max(self.share, share)
        if self.keep_inputs and self.inputs is None:
            self.inputs = tuple(t.transpose(1, 2) for t in (q, k, v))
        self.calls += 1
        return got


def with_attention(L, attention, fn):
    """``fn()`` with ``layers.attention`` replaced by ``attention``."""
    original = L.attention
    L.attention = attention
    try:
        return fn()
    finally:
        L.attention = original


def recsys_close(name: str, got, want) -> float:
    """Largest |got - want| / max |want| of two score tensors; raises when
    ``got`` is not finite or an element lies outside ``RECSYS_RTOL·|want|
    + RECSYS_ATOL_SHARE·max|want|`` (the CPU parity tests' tolerance)."""
    got, want = got.float().cpu(), want.float().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: non-finite scores")
    top = float(want.abs().max())
    err = (got - want).abs()
    if bool((err > RECSYS_RTOL * want.abs() + RECSYS_ATOL_SHARE * top).any()):
        raise AssertionError(f"{name}: beyond rtol={RECSYS_RTOL}, atol={RECSYS_ATOL_SHARE} x "
                             f"max|want| (max |err| {float(err.max()):.3g} of max|want| {top:.3g})")
    return float(err.max()) / max(top, 1e-30)


def traced_calls(torch, fn, calls: int) -> dict:
    """``calls`` calls of ``fn`` (each ending in a device sync, as a
    request's answer returns to the host) under ``torch.profiler``:
    host-clock ms a call, the device's kernel ms a call from the kernels'
    own events (one stream, so they do not overlap), attention's share
    of it, and the device's idle share; None where the profiler saw no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    if device_us <= 0.0:
        return {"call_ms": wall_ms, "device_ms": None, "attention_ms": None, "idle_share": None,
                "kernels_per_call": None}
    device_ms = device_us / 1e3 / calls
    return {"call_ms": wall_ms, "device_ms": device_ms,
            "attention_ms": sum(e.time_range.elapsed_us() for e in kernels
                                if "flash_" in e.name) / 1e3 / calls,
            "idle_share": 1.0 - device_ms / wall_ms, "kernels_per_call": len(kernels) / calls}


def make_items(n_items: int, seed: int):
    """``n_items`` items with attributes drawn as the example search
    service draws them (``examples/search_service.py:60-68``: 3-19 draws
    an item from ``N_ATTRS`` attributes of Zipf exponent ``ATTR_ZIPF``,
    duplicates merged), vectorised: the item CSR that ``items_as_corpus``
    builds, and each posting's item."""
    from repro_torch.data.corpus import Corpus

    rng = np.random.default_rng(seed)
    p = np.arange(1, N_ATTRS + 1, dtype=np.float64) ** -ATTR_ZIPF
    p /= p.sum()
    draws = rng.integers(ATTR_DRAWS[0], ATTR_DRAWS[1], n_items)
    attrs = rng.choice(N_ATTRS, size=int(draws.sum()), p=p)
    key = np.unique(np.repeat(np.arange(n_items, dtype=np.int64), draws) * N_ATTRS + attrs)
    item, attr = key // N_ATTRS, key % N_ATTRS
    ptr = np.zeros(n_items + 1, np.int64)
    np.cumsum(np.bincount(item, minlength=n_items), out=ptr[1:])
    return Corpus(doc_ptr=ptr, doc_terms=attr.astype(np.int32), n_terms=N_ATTRS), item


def brute_force(items, item_of, attrs) -> np.ndarray:
    """Items holding every attribute of ``attrs``, by a mask over the item
    CSR: each item's count of postings among the attributes."""
    want = np.unique(np.asarray(attrs))
    hits = np.bincount(item_of[np.isin(items.doc_terms, want)], minlength=items.n_docs)
    return np.flatnonzero(hits == len(want))


def filtered_retrieval_setup(torch) -> dict:
    """The items of ``retrieval_cand`` (``N_ITEMS``, attributes from the
    seed), ``FilteredRetriever(items)`` with its defaults on the card, and
    each filter of ``FILTERS`` (plus the rare pair: the two rarest
    attributes of item 0) run once: its ids held exactly to the brute
    force, its work and time.  The control: a 2-attribute filter with one
    attribute dropped must fail that exactness check."""
    from repro_torch.serve.retrieval import FilteredRetriever, items_as_corpus

    t0 = time.perf_counter()
    items, item_of = make_items(N_ITEMS, ITEM_SEED)
    draw_s = time.perf_counter() - t0
    head = items_as_corpus([items.doc(i) for i in range(1000)], N_ATTRS)
    if not (np.array_equal(head.doc_ptr, items.doc_ptr[:1001])
            and np.array_equal(head.doc_terms, items.doc_terms[:items.doc_ptr[1000]])):
        raise AssertionError("the vectorised item draw is not the CSR items_as_corpus builds")
    t0 = time.perf_counter()
    retriever = FilteredRetriever(items, device="cuda")
    fit_s = time.perf_counter() - t0
    freq = np.bincount(items.doc_terms, minlength=N_ATTRS)
    first = items.doc(0)
    rare = tuple(int(a) for a in first[np.argsort(freq[first], kind="stable")[:2]])
    filters = {**FILTERS, "rare pair (item 0's two rarest)": rare}
    rows = []
    for label, attrs in filters.items():
        t0 = time.perf_counter()
        ids, report = retriever.filter(*attrs)
        filter_ms = (time.perf_counter() - t0) * 1e3
        brute = brute_force(items, item_of, attrs)
        if len(ids) != len(brute) or not np.array_equal(np.sort(ids), brute):
            raise AssertionError(f"filter {label} {attrs}: {len(ids)} ids, brute force "
                                 f"{len(brute)}: not the exact set")
        rows.append({"label": label, "attrs": list(attrs), "ids": ids, "brute": brute,
                     "n_filtered": report.n_filtered, "filter_work": report.filter_work,
                     "baseline_work": report.baseline_work, "speedup": report.speedup,
                     "filter_ms": filter_ms, "score_ms": {}})
    pair = FILTERS["example pair"]
    brute_pair = next(r["brute"] for r in rows if r["label"] == "example pair")
    dropped, _ = retriever.filter(pair[0])
    if len(dropped) == len(brute_pair) and np.array_equal(np.sort(dropped), brute_pair):
        raise AssertionError(f"control: the filter {pair} without {pair[1]} passes the "
                             f"exactness check")
    out = {"items": items.n_docs, "postings": items.nnz, "draw_s": draw_s, "fit_s": fit_s,
           "k_actual": retriever.res.k, "filters": rows, "retriever": retriever,
           "control_dropped_attr_ids": len(dropped)}
    print(f"filtered retrieval: {out['items']} items, {out['postings']} postings, drawn in "
          f"{draw_s:.1f}s, FilteredRetriever fit {fit_s:.1f}s (k_actual {out['k_actual']}); "
          + "; ".join(f"{r['label']} {tuple(r['attrs'])}: n_filtered {r['n_filtered']}, work "
                      f"{r['filter_work']:.0f} vs {r['baseline_work']:.0f} "
                      f"({r['speedup']:.2f}x), {r['filter_ms']:.2f} ms" for r in rows)
          + f"; every filter equal to the brute force; control {pair[0]} alone "
          f"({len(dropped)} ids) caught", flush=True)
    return out


def score_filtered(torch, dev, model, query, filt: dict, cands: np.ndarray,
                   full_scores: np.ndarray) -> None:
    """Each filter's survivors scored by the model's ``score_candidates``
    (``FilteredRetriever.retrieve``; item i is candidate ``cands[i]`` of
    ``retrieval_cand``): the top 10 must be the top 10 of the unfiltered
    scores ``full_scores`` restricted to the brute-force set, ties within
    ``TIE_RTOL`` of the largest score in either order."""
    name = model.cfg.name
    retriever = filt["retriever"]
    scale = float(np.abs(full_scores).max())
    for row in filt["filters"]:
        def score_fn(cand):
            out = model.score_candidates(query, torch.from_numpy(cands[cand]).to(dev))
            torch.cuda.synchronize()
            return out

        t0 = time.perf_counter()
        ids, scores, _ = retriever.retrieve(score_fn, *row["attrs"], top_k=10)
        row["score_ms"][name] = (time.perf_counter() - t0) * 1e3
        brute = row["brute"]
        want = np.sort(full_scores[brute])[::-1][:10]
        if not np.isin(ids, brute).all() or len(np.unique(ids)) != len(ids) \
                or len(ids) != len(want):
            raise AssertionError(f"{name}, filter {row['label']}: top ids outside the exact set")
        tol = TIE_RTOL * scale
        if np.abs(full_scores[ids] - want).max(initial=0.0) > tol \
                or np.abs(scores - full_scores[ids]).max(initial=0.0) > tol:
            raise AssertionError(f"{name}, filter {row['label']}: the filtered top 10 is not the "
                                 f"top 10 of the unfiltered scores on the exact set")


def bert4rec_attention_rows(torch, launches, q, k, v) -> tuple:
    """BERT4Rec's attention call (the first bulk slice's first block: q, k,
    v as the model handed them) through the ``resident`` variant the route
    takes and the ``general`` kernel forced on the same inputs: each held
    to ``FLASH_TOL`` of the plain version, eager and graph ms against the
    bound, beside the plain version and SDPA (float32, not causal, its
    efficient backend: its flash backend takes no float32), all timed in
    this one call.  Returns the two rows (resident, general)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from _torch_parity import attention_ref_chunked, flash_close
    from repro_torch.kernels.flash_attention import kernel as FK

    b, h, lq, d = q.shape
    lk = k.shape[2]
    if FK.flash_route(q.dtype, h, k.shape[1], lq, lk, d, False, None) != "resident":
        raise AssertionError("bert4rec's attention call does not take the resident variant")
    want = attention_ref_chunked(q.float(), k.float(), v.float(), False)
    kernels = {"resident": lambda: FK.flash_attention_cuda(q, k, v, causal=False),
               "general": lambda: FK._general_forced(q, k, v, causal=False)}
    errs = {}
    for name, fn in kernels.items():
        try:
            errs[name] = flash_close(fn(), want)
        except AssertionError as exc:
            raise AssertionError(f"flash_attention_{name} at bert4rec's call: {exc}") from exc

    def library():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v)

    assert_close_tol("scaled_dot_product_attention (efficient, fp32) yardstick", library(),
                     want, LIBRARY_TOL)
    del want
    ops = 4 * b * h * d * lq * lk
    nbytes = 4 * (q.numel() + k.numel() + v.numel() + q.numel())
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    # Each at the rate of the unit that does its products: the resident
    # kernel's on the tensor cores (3xTF32), the general kernel's on the
    # fp32 cores.
    ops_ms = {"resident": TF32_PRODUCTS_PER_FP32 * ops / TF32_OPS_PER_S * 1e3,
              "general": ops / FP32_OPS_PER_S * 1e3}
    # In turns on the same inputs: resident, general, general, resident.
    ms = {name: [] for name in kernels}
    for name in ("resident", "general", "general", "resident"):
        ms[name].append(time_ms(kernels[name], reps=10))
    device_ms = {name: graph_ms(fn, reps=10) for name, fn in kernels.items()}
    shared = {
        "shape": f"bert4rec serve_bulk slice: q, k, v ({b}, {h}, {lq}, {d}) fp32, not causal",
        "ops": ops, "bytes": nbytes,
        "plain_ms": time_ms(lambda: attention_ref_chunked(q, k, v, False), reps=1, warmup=1),
        "library_ms": time_ms(library, reps=10), "library_device_ms": graph_ms(library, reps=10),
        "library_call": "scaled_dot_product_attention, EFFICIENT_ATTENTION backend, fp32",
        "bytes_bound_ms": bytes_ms,
    }
    return tuple(dict(shared, variant=name, max_abs_err=errs[name][0],
                      bound_ms=max(bytes_ms, ops_ms[name]), ops_bound_ms=ops_ms[name],
                      bound_by="bytes" if bytes_ms >= ops_ms[name] else "operations",
                      share_of_limit=errs[name][1], ms=sum(ms[name]) / 2, ms_turns=ms[name],
                      device_ms=device_ms[name], launches=int(launches[f"flash_attention_{name}"]))
                 for name in ("resident", "general"))


def recsys_phase(torch, dev, name: str, filt: dict) -> tuple:
    """One recsys arch at its published widths through ``launch/serve.py``
    (``setup_recsys``, ``recsys_batch``, ``forward_sliced``,
    ``candidate_ids``, the model's ``score_candidates``): counters set to
    0 just before and read just after ``serve_p99`` (``P99_CALLS`` timed
    calls after a warm-up), ``serve_bulk`` (262,144 rows in slices) and
    ``retrieval_cand`` (1 query x 10⁶ candidates); then the traced p99
    window and the checks (the CPU port on the first rows and candidates,
    BERT4Rec's attention at every p99 call and the first bulk slice and
    its plain route, the slicing, the filtered top 10).  Returns its
    report, the attention launches and (BERT4Rec) the rows of the resident
    variant and the general kernel at its attention call."""
    from _torch_parity import FLASH_VARIANTS
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import build as B
    from repro_torch.launch import serve
    from repro_torch.models import layers as L

    args = serve.build_parser().parse_args(["--arch", name, "--config", "full",
                                            "--device", str(dev)])
    t0 = time.perf_counter()
    model, _ = serve.setup_recsys(args)
    init_s = time.perf_counter() - t0
    cfg = model.cfg
    cells = get_arch(name).cells
    bulk_rows, p99_rows = cells["serve_bulk"].batch, cells["serve_p99"].batch
    n_cand = cells["retrieval_cand"].extra["n_candidates"]
    host = serve.recsys_batch(name, cfg, bulk_rows, np.random.default_rng(serve.BATCH_SEED))
    bulk = serve.to_device(host, dev)
    p99 = {k: v[:p99_rows] for k, v in bulk.items()}
    query = {k: v[:1] for k, v in bulk.items()}
    cands = torch.from_numpy(serve.candidate_ids(cfg, n_cand)).to(dev)
    torch.cuda.synchronize()

    counted = ("flash_attention_kernel", *FLASH_VARIANTS)
    B.reset_launch_counts()
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats(dev)
        serve.forward_sliced(model, p99)  # warm-up
        call_ms = []
        for _ in range(P99_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p99_scores = serve.forward_sliced(model, p99)
            torch.cuda.synchronize()
            call_ms.append((time.perf_counter() - t0) * 1e3)
        p99_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        bulk_scores = serve.forward_sliced(model, bulk)
        torch.cuda.synchronize()
        bulk_s = time.perf_counter() - t0
        bulk_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        retrieval_ms = []
        for _ in range(1 + RETRIEVAL_CALLS):  # the first call warms up
            t0 = time.perf_counter()
            full = model.score_candidates(query, cands)
            torch.cuda.synchronize()
            retrieval_ms.append((time.perf_counter() - t0) * 1e3)
        retrieval_peak = torch.cuda.max_memory_allocated(dev)
    launches = {n: B.LAUNCHES[n] for n in counted}
    slices = -(-bulk_rows // serve.SERVE_SLICE_ROWS)
    if name == "bert4rec":
        model_calls = 1 + P99_CALLS + slices + 1 + RETRIEVAL_CALLS
        per = cfg.n_blocks * model_calls
        design = {n: 0 for n in counted}
        design.update(flash_attention_kernel=per, flash_attention_resident=per)
    else:
        design = {n: 0 for n in counted}
    if launches != design:
        raise AssertionError(f"{name}: attention launches {launches}, the design gives {design}")
    if bulk_scores.shape != (bulk_rows,) or full.shape != (1, n_cand) \
            or not bool(bulk_scores.isfinite().all()) or not bool(full.isfinite().all()):
        raise AssertionError(f"{name}: scores of the wrong shape or not finite")

    with torch.no_grad():
        trace = traced_calls(torch, lambda: serve.forward_sliced(model, p99), 5)
        # The card against the port on the CPU, with the same weights.
        cpu_model = type(model)(cfg, "cpu")
        cpu_model.load_state_dict(model.state_dict())
        cpu_batch = {k: v[:CPU_CHECK_ROWS].cpu() for k, v in p99.items()}
        cpu_query = {k: v.cpu() for k, v in query.items()}
        errs = {"forward_vs_cpu": recsys_close(f"{name} forward, card vs CPU", p99_scores,
                                               cpu_model(cpu_batch)),
                "score_candidates_vs_cpu": recsys_close(
                    f"{name} score_candidates, card vs CPU", full[:, :CPU_CHECK_CANDIDATES],
                    cpu_model.score_candidates(cpu_query, cands[:CPU_CHECK_CANDIDATES].cpu())),
                "bulk_head_vs_p99": recsys_close(f"{name} serve_bulk's first rows vs serve_p99",
                                                 bulk_scores[:p99_rows], p99_scores)}
        del cpu_model
        rows = None
        attention = {}
        if name == "bert4rec":
            checked = CheckedKernel(L.attention)
            with_attention(L, checked, lambda: model(p99))
            first = {k: v[:serve.SERVE_SLICE_ROWS] for k, v in bulk.items()}
            checked_bulk = CheckedKernel(L.attention, keep_inputs=True)
            with_attention(L, checked_bulk, lambda: model(first))
            plain = with_attention(L, plain_route_attention, lambda: model(p99))
            errs["plain_route_vs_kernel_route"] = recsys_close(
                f"{name} forward, plain attention vs the kernel", p99_scores, plain)
            attention = {"p99_calls_checked": checked.calls, "p99_share": checked.share,
                         "p99_max_abs_err": checked.max_abs_err,
                         "bulk_slice_calls_checked": checked_bulk.calls,
                         "bulk_slice_share": checked_bulk.share,
                         "bulk_slice_max_abs_err": checked_bulk.max_abs_err}
            if checked.calls != cfg.n_blocks or checked_bulk.calls != cfg.n_blocks:
                raise AssertionError(f"{name}: {checked.calls} and {checked_bulk.calls} checked "
                                     f"attention calls, not {cfg.n_blocks} each")
            del first
        score_filtered(torch, dev, model, query, filt, cands.cpu().numpy(),
                       full[0].cpu().numpy())
        if name == "bert4rec":
            rows = bert4rec_attention_rows(torch, launches, *checked_bulk.inputs)
            del checked_bulk
    call_ms_sorted = sorted(call_ms)
    out = {
        "arch": name, "n_params": cfg.n_params(), "init_s": init_s,
        "p99": {"rows": p99_rows, "calls": P99_CALLS,
                "p50_ms": float(np.percentile(call_ms_sorted, 50)),
                "p99_ms": float(np.percentile(call_ms_sorted, 99)),
                "rows_per_s": p99_rows / (float(np.median(call_ms_sorted)) / 1e3),
                "peak_gib": p99_peak / 2**30, "trace": trace},
        "bulk": {"rows": bulk_rows, "slices": slices, "wall_s": bulk_s,
                 "rows_per_s": bulk_rows / bulk_s, "peak_gib": bulk_peak / 2**30},
        "retrieval": {"candidates": n_cand, "first_ms": retrieval_ms[0],
                      "median_ms": float(np.median(retrieval_ms[1:])),
                      "peak_gib": retrieval_peak / 2**30},
        "launches": launches, "checks_rel_err": errs, "attention": attention,
    }
    t = trace
    # The profiler slows the host (each launch is recorded): the idle share
    # against the untraced p50 is the one to read for a host-bound call.
    out["p99"]["idle_share_untraced"] = (None if t["device_ms"] is None
                                         else 1.0 - t["device_ms"] / out["p99"]["p50_ms"])
    print(f"recsys {name} ({cfg.n_params() / 1e6:.1f} M parameters, init {init_s:.1f}s): "
          f"serve_p99 {p99_rows} rows p50 {out['p99']['p50_ms']:.2f} ms p99 "
          f"{out['p99']['p99_ms']:.2f} ms ({out['p99']['rows_per_s']:.0f} rows/s, peak "
          f"{out['p99']['peak_gib']:.2f} GiB; traced: {t['call_ms']:.2f} ms a call, device "
          + (f"{t['device_ms']:.3f} ms (attention {t['attention_ms']:.3f}), idle "
             f"{t['idle_share']:.1%} (against the untraced p50 "
             f"{out['p99']['idle_share_untraced']:.1%}), {t['kernels_per_call']:.0f} kernels a call"
             if t["device_ms"] is not None else "not measured")
          + f"); serve_bulk {bulk_rows} rows in {slices} slices {bulk_s:.3f} s "
          f"({out['bulk']['rows_per_s']:.0f} rows/s, peak {out['bulk']['peak_gib']:.2f} GiB); "
          f"retrieval_cand 1 x {n_cand}: median {out['retrieval']['median_ms']:.3f} ms of "
          f"{RETRIEVAL_CALLS} (first call {retrieval_ms[0]:.3f} ms); launches {launches} (as "
          f"designed); checks (max |err| / max |want|): "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + ("" if not attention else
             f"; attention within {attention['p99_share']:.3g} / "
             f"{attention['bulk_slice_share']:.3g} of FLASH_TOL at p99 / the first bulk slice"),
          flush=True)
    del model, bulk, p99, query, cands, full, bulk_scores
    return out, launches, rows


# ----------------------------------------------------------------------
# Training: the attention's backward kernels, the train steps, the
# checkpoint restart and the sanitizer (TRAIN_PHASES)
# ----------------------------------------------------------------------

# The backward's training shapes: (label, dtype, B, H, Hkv, Lq, Lk, D,
# causal, window).  gemma3-4b's local and global layer at one 4,096-token
# sequence (train_4k, one microbatch), BERT4Rec's encoder call at 32,768
# rows of 200 positions (its train_batch in slices: B·H = 65,536 passes
# one launch chunk of 65,535).
BWD_TRAIN_SHAPES = (
    ("gemma3-4b train_4k, local layer (window 1024)", "bfloat16", 1, 8, 4, 4096, 4096, 256,
     True, 1024),
    ("gemma3-4b train_4k, global layer", "bfloat16", 1, 8, 4, 4096, 4096, 256, True, None),
    ("bert4rec train_batch slice of 32,768 rows", "float32", 32768, 2, 2, 200, 200, 32, False,
     None),
)
BWD_KERNELS = ("flash_bwd_prep", "flash_bwd_dkdv", "flash_bwd_dq", "flash_bwd_dkdv_sm90",
               "flash_bwd_dq_sm90", "flash_bwd_resident")
# The kernels one backward call launches on each route (kernel.bwd_route):
# the fp32 resident kernel alone (given the forward's log-sum-exp), or
# prep, then the bf16 tensor-core dK/dV and dQ, or the general pair.
BWD_ROUTE_KERNELS = {"sm90": ("flash_bwd_prep", "flash_bwd_dkdv_sm90", "flash_bwd_dq_sm90"),
                     "general": ("flash_bwd_prep", "flash_bwd_dkdv", "flash_bwd_dq"),
                     "resident": ("flash_bwd_resident",)}
# Flops a visible (row, key) pair and head, per unit of D, that each kernel
# needs (products of length D, two flops a multiply-add): prep S (none when
# the forward saved the log-sum-exp: delta alone, bound by its bytes);
# dkdv S, dP, dV, dK; dq S, dP, dQ.  The minimal backward does S, dP, dV,
# dK, dQ: 10·D (BWD_MIN_FLOPS), and the resident kernel computes the whole
# backward given the lse, so 10·D is its bound.  It does 14·D
# (RESIDENT_BWD_OWN_FLOPS: S, dP, dV, dK in its phase 2 and S, dP, dQ
# again in its phase 3), reported beside the bound, not as it.
BWD_MIN_FLOPS = 10
RESIDENT_BWD_OWN_FLOPS = 14
BWD_FLOPS = {"flash_bwd_prep": 2, "flash_bwd_dkdv": 8, "flash_bwd_dq": 6,
             "flash_bwd_dkdv_sm90": 8, "flash_bwd_dq_sm90": 6,
             "flash_bwd_resident": BWD_MIN_FLOPS}
class TrainPhase(NamedTuple):
    """A train phase: the arch, its train cell, rows a step, sequential
    microbatches, steps (the first warms up, the last is traced), the
    learning rate (one warmup step: a few steps must move the loss; the
    launcher's default warms up over 100), the rows of the first step's
    route comparison (None: the whole batch) and a depth cut (None: full
    depth)."""

    arch: str
    cell: str
    batch: int
    microbatches: int
    steps: int
    lr: float
    route_rows: Optional[int]
    layers: Optional[int]


# gemma3-4b at full width and depth: 2 microbatches of one 4,096-token
# sequence (train_4k's 256 x 4,096 in 8 cut to 2 x 4,096 in 2: the card
# holds 62 GB of state; at lr 3e-4 its second step's loss rose to 20.9
# before falling, so 1e-4); dien and dcn-v2 at train_batch's 65,536 rows;
# mind at 32,768 (its in-batch (B, B) logits take 17.2 GB at 65,536 rows
# and their softmax's gradient as much again: the step ran out of the
# card's 80 GB); bert4rec at 16,384 (its sampled-softmax logits take
# 6.7 GB and their gradient as much again), its route comparison on the
# first 4,096 rows (the plain attention's score tensors at 16,384 rows,
# 5.2 GB each, did not fit beside the step).
TRAIN_PHASES = (
    TrainPhase("gemma3-4b", "train_4k", 2, 2, 4, 1e-4, None, None),
    TrainPhase("dien", "train_batch", 65536, 1, 4, 3e-4, None, None),
    TrainPhase("mind", "train_batch", 32768, 1, 4, 3e-4, None, None),
    TrainPhase("dcn-v2", "train_batch", 65536, 1, 4, 3e-4, None, None),
    TrainPhase("bert4rec", "train_batch", 16384, 1, 4, 3e-4, 4096, None),
)
TRAIN_SEED = 0
# One warmup step (TrainPhase.lr).
TRAIN_WARMUP = 1
# The first step's loss and gradients through the kernels against the same
# step through the plain attention (float32) on the card.  A leaf is
# compared by its relative max error, max |a - b| / max |b|, as
# LOGIT_RTOL compares logits.  bf16 model (gemma3-4b): both routes round
# every activation, every weight gradient and every attention output and
# gradient to bf16 (a step is 2**-8 to 2**-7 of the value), the kernels'
# fp32 sums and the sm90 forward's bf16 P differ from the plain route's,
# and 34 layers carry the flipped roundings on through the backward;
# TRAIN_GRAD_RTOL allows that and no more, and the run's faulty control
# (the backward with the local layers' window dropped) must land beyond
# it.  float32 models: the plain route differs by float32 sum order only.
TRAIN_GRAD_RTOL = {"bfloat16": 5e-2, "float32": 1e-4}
TRAIN_LOSS_RTOL = {"bfloat16": 2e-3, "float32": 1e-5}
# A recsys step's loss and gradients on the card against the port on the
# CPU, on the first CPU_TRAIN_ROWS rows: float32 sums in other orders (and
# the embedding gradients' atomics on the card): an element within
# TRAIN_GRAD_RTOL["float32"] of (its magnitude + the gradient tree's
# largest), the CPU parity tests' metric.
CPU_TRAIN_ROWS = 256
# The checkpoint restart on dcn-v2 (train_batch, 4 steps, a checkpoint
# every 2): the continued run's losses against the uninterrupted run's.
# Embedding gradients are sums by atomics on the card, in an order that
# changes from run to run, so the restart is held to CKPT_LOSS_RTOL, not
# bit for bit (the run reports which).
CKPT_STEPS, CKPT_EVERY = 4, 2
CKPT_LOSS_RTOL = 1e-5


def plain_bwd_parts(torch, q, k, v, out, dout, causal, window, part="all", lse=None,
                    delta=None):
    """The plain backward (``ref.py``: ``attention_bwd_ref`` or one of its
    parts) on the card in float32, over chunks of the batch whose score
    tensors stay within ``SCORE_BYTES`` (BERT4Rec's call would take 10.5 GB
    at once)."""
    from _torch_parity import SCORE_BYTES
    from repro_torch.kernels.flash_attention import ref as R

    b, h, lq, _ = q.shape
    lk = k.shape[2]
    rows = max(1, SCORE_BYTES // (4 * h * lq * lk))
    f = [t.float() if t is not None else None for t in (q, k, v, out, dout)]
    outs = []
    for c0 in range(0, b, rows):
        c1 = min(b, c0 + rows)
        qc, kc, vc, oc, gc = (t[c0:c1] if t is not None else None for t in f)
        if part == "prep":
            outs.append(R.bwd_prep_ref(qc, kc, oc, gc, causal, window))
            continue
        if part == "all":
            outs.append(R.attention_bwd_ref(qc, kc, vc, oc, gc, causal, window))
            continue
        lc, dc = lse[c0 * h:c1 * h], delta[c0 * h:c1 * h]
        fn = R.bwd_dkdv_ref if part == "dkdv" else R.bwd_dq_ref
        res = fn(qc, kc, vc, gc, lc, dc, causal, window)
        outs.append(res if isinstance(res, tuple) else (res,))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def bwd_inputs(torch, dev, dtype, b, h, hkv, lq, lk, d, causal, window, seed):
    """q, k, v (model layout where Lk is even), the forward's output
    through its route with its log-sum-exp where that route saves one
    (``kernel.flash_attention_lse_cuda``: the sm90 variant), and a
    standard-normal output gradient."""
    from _torch_parity import flash_inputs
    from repro_torch.kernels.flash_attention import kernel as FK

    q, k, v = flash_inputs(dev, dtype, b, h, hkv, lq, lk, d, seed=seed, model_layout=lk % 2 == 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
    out, lse = FK.flash_attention_lse_cuda(q, k, v, causal=causal, window=window)
    return q, k, v, out, dout, lse


def rounding_terms(torch, q, k, v, dout, lse, delta, causal, window):
    """``_torch_parity.bwd_rounding_terms`` (the sm90 route's extra limit)
    over chunks of the batch, as ``plain_bwd_parts`` chunks."""
    from _torch_parity import SCORE_BYTES, bwd_rounding_terms

    b, h, lq, _ = q.shape
    rows = max(1, SCORE_BYTES // (4 * h * lq * k.shape[2]))
    parts = [bwd_rounding_terms(q[c0:c0 + rows], k[c0:c0 + rows], v[c0:c0 + rows],
                                dout[c0:c0 + rows], lse[c0 * h:(c0 + rows) * h],
                                delta[c0 * h:(c0 + rows) * h], causal, window)
             for c0 in range(0, b, rows)]
    return tuple(torch.cat(t) for t in zip(*parts))


def check_flash_bwd_cases(torch, dev) -> dict:
    """The backward kernels against the plain backward on the card at
    ``FLASH_BWD_CASES`` (fp32 and bf16), ``RESIDENT_BWD_CASES`` and the
    training shapes.  Each case runs through its route (``kernel.bwd_route``;
    launches read from the counters): the whole backward against
    ``attention_bwd_ref`` within ``FLASH_BWD_TOL``, plus on the sm90 route
    the rounding term of P and dS (``_torch_parity.bwd_rounding_terms``);
    on the resident route one kernel, given the resident forward's lse,
    whose rerun must give the same bits; on the others each kernel alone
    against its own plain part — prep's lse and delta against
    ``bwd_prep_ref`` (and, on the sm90 route, its delta alone given the
    forward's lse), dkdv's dK, dV and dq's dQ against ``bwd_dkdv_ref`` and
    ``bwd_dq_ref`` fed the same lse and delta; the sm90 and resident
    forwards' lse against ``bwd_prep_ref``'s within
    ``FLASH_BWD_TOL["float32"]``.  The sm90 and resident cases also run the
    general backward forced (``kernel._general_bwd_forced``), held to
    ``FLASH_BWD_TOL`` with no rounding term, its kernels alone too.  Then
    the faulty controls, which must land beyond their route's limit: on the
    sm90 route the window dropped (a local layer's backward computed as a
    global one's) and the group sum dropped (dK and dV from the first
    query head of each group), on the resident route delta dropped (the
    kernel handed O = 0) and the group sum dropped, each in every case it
    applies to.  Returns per route the largest error and share of the limit
    of the whole backward and of each kernel (``kernels``)."""
    from _torch_parity import (FLASH_BWD_CASES, FLASH_BWD_TOL, RESIDENT_BWD_CASES,
                               flash_bwd_close, flash_bwd_error)
    from repro_torch.kernels import build as B
    from repro_torch.kernels.flash_attention import kernel as FK

    t0 = time.perf_counter()
    routes = ("float32 resident", "float32 general", "float32 general (forced)",
              "bfloat16 sm90", "bfloat16 general", "bfloat16 general (forced)")
    worst = {r: {"max_abs_err": 0.0, "share": 0.0, "cases": 0,
                 "kernels": {name: {"max_abs_err": 0.0, "share": 0.0}
                             for name in (*BWD_KERNELS, "forward_lse")}}
             for r in routes}

    def hold(key, label, name, got, want, extra=None, kernel=None):
        mine = worst[key] if kernel is None else worst[key]["kernels"][kernel]
        try:
            err, share = flash_bwd_close(name, got, want, extra)
        except AssertionError as exc:
            raise AssertionError(f"{kernel or 'backward'} {label} ({key}): {exc}") from exc
        mine["max_abs_err"] = max(mine["max_abs_err"], err)
        mine["share"] = max(mine["share"], share)

    def counted(fn, label, want):
        before = {name: B.LAUNCHES[name] for name in BWD_KERNELS}
        out = fn()
        torch.cuda.synchronize()
        launched = {name: B.LAUNCHES[name] - before[name] for name in BWD_KERNELS}
        if launched != {n: int(n in want) for n in BWD_KERNELS}:
            raise AssertionError(f"backward {label}: launches {launched}, want {want}")
        return out

    def kernels_alone(key, label, q, k, v, out, dout, causal, window, route, lse_fwd, terms):
        """Each kernel of ``route`` (sm90 or general) against its plain part."""
        lse, delta = FK.bwd_prep_cuda(q, k, out, dout, causal, window, v=v)
        plain_lse, plain_delta = plain_bwd_parts(torch, q, k, v, out, dout, causal, window,
                                                 "prep")
        hold(key, label, "lse", lse, plain_lse, kernel="flash_bwd_prep")
        hold(key, label, "delta", delta, plain_delta, kernel="flash_bwd_prep")
        if lse_fwd is not None:  # delta alone, given the forward's lse
            same, delta2 = FK.bwd_prep_cuda(q, k, out, dout, causal, window, v=v, lse=lse_fwd)
            if same is not lse_fwd:
                raise AssertionError("prep with the forward's lse returned another lse")
            hold(key, label, "delta", delta2, plain_delta, kernel="flash_bwd_prep")
        sm90 = route == "sm90"
        dkdv = FK.bwd_dkdv_sm90_cuda if sm90 else FK.bwd_dkdv_cuda
        dq_fn = FK.bwd_dq_sm90_cuda if sm90 else FK.bwd_dq_cuda
        names = BWD_ROUTE_KERNELS[route]
        dk, dv = dkdv(q, k, v, dout, lse, delta, causal, window)
        want_k = plain_bwd_parts(torch, q, k, v, out, dout, causal, window, "dkdv", lse, delta)
        for name, g, w, t in zip(("dk", "dv"), (dk, dv), want_k, terms[1:], strict=True):
            hold(key, label, name, g, w, t if sm90 else None, kernel=names[1])
        dq = dq_fn(q, k, v, dout, lse, delta, causal, window)
        (want_q,) = plain_bwd_parts(torch, q, k, v, out, dout, causal, window, "dq", lse, delta)
        hold(key, label, "dq", dq, want_q, terms[0] if sm90 else None, kernel=names[2])

    def control(name, got, want, terms=(None, None, None)):
        """A faulty control's share of the limit; the least over its cases."""
        share = max(flash_bwd_error(g, w, t)[1] for g, w, t in zip(got, want, terms))
        controls[name] = min(controls.get(name, share), share)

    cases = [(f"case {c}", dt, *c) for c in FLASH_BWD_CASES for dt in ("float32", "bfloat16")]
    cases += [(f"resident case {c}", "float32", *c, False, None) for c in RESIDENT_BWD_CASES
              if (*c, False, None) not in FLASH_BWD_CASES]
    cases += [(label, dt, b, h, hkv, lq, lk, d, causal, window)
              for label, dt, b, h, hkv, lq, lk, d, causal, window in BWD_TRAIN_SHAPES]
    controls = {}
    for n, (label, dt, b, h, hkv, lq, lk, d, causal, window) in enumerate(cases):
        dtype = getattr(torch, dt)
        route = FK.bwd_route(dtype, h, hkv, lq, lk, d, causal, window)
        key = f"{dt} {route}"
        q, k, v, out, dout, lse_fwd = bwd_inputs(torch, dev, dtype, b, h, hkv, lq, lk, d, causal,
                                                 window, seed=500 + n)
        got = counted(lambda: FK.flash_attention_bwd_cuda(q, k, v, out, dout, causal, window,
                                                          lse=lse_fwd),
                      label, BWD_ROUTE_KERNELS[route])
        want = plain_bwd_parts(torch, q, k, v, out, dout, causal, window)
        plain_lse, plain_delta = plain_bwd_parts(torch, q, k, v, out, dout, causal, window,
                                                 "prep")
        terms = (rounding_terms(torch, q, k, v, dout, plain_lse, plain_delta, causal, window)
                 if route == "sm90" else (None, None, None))
        for name, g, w, t in zip(("dq", "dk", "dv"), got, want, terms, strict=True):
            hold(key, label, name, g, w, t)
        worst[key]["cases"] += 1
        if lse_fwd is not None:  # the sm90 or resident forward's log-sum-exp
            rtol, atol = FLASH_BWD_TOL["float32"]
            err = (lse_fwd - plain_lse).abs()
            share = float((err / (atol + rtol * plain_lse.abs())).max())
            mine = worst[key]["kernels"]["forward_lse"]
            mine["max_abs_err"] = max(mine["max_abs_err"], float(err.max()))
            mine["share"] = max(mine["share"], share)
            if share > 1.0:
                raise AssertionError(f"the forward's lse at {label} ({key}): {share:.3g} of the "
                                     f"limit")
        if route == "resident":  # one kernel: the whole backward is the kernel alone
            for name, g, w in zip(("dq", "dk", "dv"), got, want, strict=True):
                hold(key, label, name, g, w, kernel="flash_bwd_resident")
            again = FK.bwd_resident_cuda(q, k, v, out, dout, lse_fwd)
            if not all(torch.equal(a, c) for a, c in zip(got, again, strict=True)):
                raise AssertionError(f"the resident backward at {label}: a rerun differs")
            control("delta dropped (resident)", FK.bwd_resident_cuda(
                q, k, v, torch.zeros_like(out), dout, lse_fwd), want)
            if h > hkv:
                g = h // hkv
                lse0 = lse_fwd.reshape(b, h, lq)[:, ::g].reshape(b * hkv, lq).contiguous()
                bad = FK.bwd_resident_cuda(q[:, ::g], k, v, out[:, ::g], dout[:, ::g], lse0)
                control("group sum dropped (resident)", bad[1:], want[1:])
        else:
            kernels_alone(key, label, q, k, v, out, dout, causal, window, route, lse_fwd, terms)
        if route != "general":  # the general backward on the same inputs
            gkey = f"{dt} general (forced)"
            forced = counted(lambda: FK._general_bwd_forced(q, k, v, out, dout, causal, window),
                             label, BWD_ROUTE_KERNELS["general"])
            for name, g, w in zip(("dq", "dk", "dv"), forced, want, strict=True):
                hold(gkey, label, name, g, w)
            worst[gkey]["cases"] += 1
            kernels_alone(gkey, label, q, k, v, out, dout, causal, window, "general", None,
                          (None, None, None))
        if label.startswith("gemma3-4b") and window is not None:
            bad = FK.flash_attention_bwd_cuda(q, k, v, out, dout, causal, None)
            control("window dropped (sm90)", bad, want, terms)
        if label.startswith("gemma3-4b") and window is None:
            g = h // hkv
            q0, o0, d0 = q[:, ::g], out[:, ::g], dout[:, ::g]
            lse0, delta0 = FK.bwd_prep_cuda(q0, k, o0, d0, causal, window, v=v)
            bad = FK.bwd_dkdv_sm90_cuda(q0, k, v, d0, lse0, delta0, causal, window)
            control("group sum dropped (sm90)", bad, want[1:], terms[1:])
        del q, k, v, out, dout, lse_fwd, got, want, terms, plain_lse, plain_delta
        torch.cuda.empty_cache()
    for name, share in controls.items():
        print(f"attention backward control ({name}): {share:.3g} of the limit", flush=True)
        if share <= 1.0:
            raise AssertionError(f"the backward's control ({name}) was not caught: {share:.3g}")
    worst["controls"] = controls
    for r in routes:
        w = worst[r]
        print(f"attention backward, {r}: {w['cases']} cases, max |err| {w['max_abs_err']:.3g} "
              f"({w['share']:.3g} of the limit); each kernel alone: " + ", ".join(
                  f"{n} {e['max_abs_err']:.3g} ({e['share']:.3g})"
                  for n, e in w["kernels"].items() if e["share"] > 0), flush=True)
    phase_line("attention backward cases", time.perf_counter() - t0)
    return worst


def sdpa_backward(torch, q, k, v, dout, causal, window):
    """``scaled_dot_product_attention``'s backward on the same inputs (K
    and V repeated over the group inside the graph, so the group sum is
    its own): a callable computing (dq, dk, dv), the library yardstick."""
    import torch.nn.functional as F

    g = q.shape[1] // k.shape[1]
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    kr = ks.repeat_interleave(g, dim=1) if g > 1 else ks
    vr = vs.repeat_interleave(g, dim=1) if g > 1 else vs
    lq, lk = q.shape[2], k.shape[2]
    if window is not None:
        i = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        j = torch.arange(lk, device=q.device)[None, :]
        out = F.scaled_dot_product_attention(qs, kr, vr, attn_mask=(j <= i) & (j > i - window))
    else:
        out = F.scaled_dot_product_attention(qs, kr, vr, is_causal=causal and lq == lk)
    return lambda: torch.autograd.grad(out, (qs, ks, vs), dout, retain_graph=True)


def flash_bwd_rows(torch, dev, launches, checked) -> list:
    """The backward's kernels at the training shapes (``BWD_TRAIN_SHAPES``),
    each alone, eager and as a graph replay, against its plain version (its
    part of ``attention_bwd_ref``) and its bound (its own flops,
    ``BWD_FLOPS``·D a visible pair and head, at the rate of the unit its
    products run on: 989 TFLOP/s bf16, 67 fp32 outside the tensor cores,
    495 TF32 over ``TF32_PRODUCTS_PER_FP32`` for the resident kernel's
    3xTF32 products; or its bytes): at gemma3-4b's shapes the sm90 route's
    kernels (prep computing delta alone, given the forward's lse), at
    BERT4Rec's the resident kernel (given the resident forward's lse), and
    at both the general kernels forced on the same inputs (prep
    recomputing the lse).  Beside them the whole backward of the route and
    the forced general one (bound 10·D a pair and head at the route's
    rate), ``scaled_dot_product_attention``'s backward (the resident
    kernel's library call: it computes the same function) and the plain
    version.  Returns the kernels' entries."""
    from repro_torch.kernels.flash_attention import kernel as FK

    rates = {"sm90": BF16_OPS_PER_S, "general": FP32_OPS_PER_S,
             "resident": TF32_OPS_PER_S / TF32_PRODUCTS_PER_FP32}
    rows = {name: [] for name in BWD_KERNELS}
    for n, (label, dt, b, h, hkv, lq, lk, d, causal, window) in enumerate(BWD_TRAIN_SHAPES):
        dtype = getattr(torch, dt)
        route = FK.bwd_route(dtype, h, hkv, lq, lk, d, causal, window)
        item = 2 if dt == "bfloat16" else 4
        peak = BF16_OPS_PER_S if dt == "bfloat16" else FP32_OPS_PER_S
        q, k, v, out, dout, lse_fwd = bwd_inputs(torch, dev, dtype, b, h, hkv, lq, lk, d, causal,
                                                 window, seed=700 + n)
        lse, delta = FK.bwd_prep_cuda(q, k, out, dout, causal, window, v=v, lse=lse_fwd)
        pairs = visible_pairs(lq, lk, causal, window) * b * h
        big = pairs > 4 * PLAIN_ONCE_PAIRS
        reps = 1 if big else 3
        qb, kb = item * q.numel(), item * k.numel()
        stat = 4 * b * h * lq  # lse or delta
        # Bytes each call must move: inputs read once, outputs written once.
        nbytes = {"prep": 2 * qb + kb + qb + 2 * stat,  # q, k, o, dO; lse, delta
                  "prep (delta)": 2 * qb + stat,  # o, dO; delta
                  "dkdv": 2 * qb + 2 * kb + 2 * stat + 2 * kb,  # q, k, v, dO, lse, delta; dk, dv
                  "dq": 2 * qb + 2 * kb + 2 * stat + qb,  # ...; dq
                  # q, o, dO, k, v, lse; dq, dk, dv
                  "resident": 3 * qb + 2 * kb + stat + qb + 2 * kb}
        plain = {
            "resident": lambda: plain_bwd_parts(torch, q, k, v, out, dout, causal, window),
            "prep": lambda: plain_bwd_parts(torch, q, k, v, out, dout, causal, window, "prep"),
            "dkdv": lambda: plain_bwd_parts(torch, q, k, v, out, dout, causal, window, "dkdv",
                                            lse, delta),
            "dq": lambda: plain_bwd_parts(torch, q, k, v, out, dout, causal, window, "dq", lse,
                                          delta),
        }
        # (kernel, its part, the call, whose row, the row's label suffix)
        calls = [("flash_bwd_prep", "prep",
                  lambda: FK.bwd_prep_cuda(q, k, out, dout, causal, window, v=v), "general"),
                 ("flash_bwd_dkdv", "dkdv",
                  lambda: FK.bwd_dkdv_cuda(q, k, v, dout, lse, delta, causal, window), "general"),
                 ("flash_bwd_dq", "dq",
                  lambda: FK.bwd_dq_cuda(q, k, v, dout, lse, delta, causal, window), "general")]
        if route == "sm90":
            calls = [("flash_bwd_prep", "prep (delta)",
                      lambda: FK.bwd_prep_cuda(q, k, out, dout, causal, window, v=v, lse=lse_fwd),
                      "sm90"),
                     ("flash_bwd_dkdv_sm90", "dkdv",
                      lambda: FK.bwd_dkdv_sm90_cuda(q, k, v, dout, lse, delta, causal, window),
                      "sm90"),
                     ("flash_bwd_dq_sm90", "dq",
                      lambda: FK.bwd_dq_sm90_cuda(q, k, v, dout, lse, delta, causal, window),
                      "sm90")] + calls
        if route == "resident":
            calls = [("flash_bwd_resident", "resident",
                      lambda: FK.bwd_resident_cuda(q, k, v, out, dout, lse_fwd),
                      "resident")] + calls
        library = sdpa_backward(torch, q, k, v, dout, causal, window)
        want = plain_bwd_parts(torch, q, k, v, out, dout, causal, window)
        lib_share = max(float((g.float() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                        for g, w in zip(library(), want, strict=True))
        if lib_share > LIBRARY_TOL:
            raise AssertionError(f"SDPA's backward yardstick at {label}: {lib_share:.3g}")
        del want
        library_ms = time_ms(library, reps=5, warmup=2)
        whole = lambda: FK.flash_attention_bwd_cuda(q, k, v, out, dout, causal, window,  # noqa: E731
                                                    lse=lse_fwd)
        general = lambda: FK._general_bwd_forced(q, k, v, out, dout, causal, window)  # noqa: E731
        whole_ms, whole_device = time_ms(whole, reps=5), graph_ms(whole, reps=5)
        if route != "general":
            general_ms, general_device = time_ms(general, reps=3), graph_ms(general, reps=3)
        else:
            general_ms, general_device = whole_ms, whole_device
        whole_plain = time_ms(lambda: plain_bwd_parts(torch, q, k, v, out, dout, causal, window),
                              reps=reps, warmup=1)
        whole_ops = BWD_MIN_FLOPS * d * pairs
        whole_bytes = item * (3 * q.numel() + 2 * k.numel()) + item * (q.numel() + 2 * k.numel())
        whole_bound = max(whole_ops / rates[route], whole_bytes / MEM_BYTES_PER_S) * 1e3
        general_bound = max(whole_ops / rates["general"], whole_bytes / MEM_BYTES_PER_S) * 1e3
        print(f"attention backward {label}: q ({b}, {h}, {lq}, {d}) over ({b}, {hkv}, {lk}, {d}) "
              f"{dt}, {pairs} visible pair-heads, route {route}: the backward {whole_ms:.4f} ms "
              f"(graph {whole_device:.4f}), the general backward {general_ms:.4f} (graph "
              f"{general_device:.4f}), plain {whole_plain:.4f}, SDPA's backward "
              f"{library_ms:.4f} (rel. max err {lib_share:.2g}); bound {whole_bound:.5f} ms "
              f"({BWD_MIN_FLOPS}·D flops a pair-head at {rates[route] / 1e12:.0f} TFLOP/s; the "
              f"general backward's {general_bound:.5f} at {rates['general'] / 1e12:.0f}; bytes "
              f"{whole_bytes / MEM_BYTES_PER_S * 1e3:.5f})", flush=True)
        for name, part, kernel, which in calls:
            ops = 0 if part == "prep (delta)" else BWD_FLOPS[name] * d * pairs
            bytes_ms = nbytes[part] / MEM_BYTES_PER_S * 1e3
            ops_ms = ops / (rates[which] if which == "resident" else peak) * 1e3
            key = f"{dt} {which}" + ("" if which == route else " (forced)")
            row = {
                "shape": f"{label}: q ({b}, {h}, {lq}, {d}), k/v ({b}, {hkv}, {lk}, {d}) {dt}"
                         + ("" if which == route else ", the general backward forced"),
                "part": part, "ms": time_ms(kernel, reps=3 if which == "general" else 5),
                "device_ms": graph_ms(kernel, reps=3 if which == "general" else 5),
                "plain_ms": time_ms(plain[part.split()[0]], reps=reps, warmup=1), "ops": ops,
                "bytes": nbytes[part], "visible_pair_heads": pairs,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": library_ms if which == "resident" else None,
                "sdpa_backward_ms": library_ms,
                "whole_backward_ms": whole_ms, "whole_backward_device_ms": whole_device,
                "general_backward_ms": general_ms, "general_backward_device_ms": general_device,
                "general_backward_bound_ms": general_bound,
                "whole_backward_plain_ms": whole_plain, "whole_backward_bound_ms": whole_bound,
                "max_abs_err": checked[key]["kernels"][name]["max_abs_err"],
            }
            own = ""
            if name == "flash_bwd_resident":
                own_ms = RESIDENT_BWD_OWN_FLOPS * d * pairs / rates["resident"] * 1e3
                row["own_products_bound_ms"] = max(bytes_ms, own_ms)
                own = (f"; its own {RESIDENT_BWD_OWN_FLOPS}·D products' bound "
                       f"{row['own_products_bound_ms']:.5f}")
            rows[name].append(row)
            print(f"{name} {row['shape']} [{part}]: ms={row['ms']:.4f} "
                  f"device_ms={row['device_ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                  f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}; "
                  f"{0 if not ops else BWD_FLOPS[name]}·D flops a pair-head, bytes "
                  f"{bytes_ms:.5f}{own})", flush=True)
        del q, k, v, out, dout, lse, delta, lse_fwd, library
        torch.cuda.empty_cache()
    return [kernel_entry(name, launches, rows[name], variant="backward") for name in BWD_KERNELS]


class FaultyBackward:
    """A faulty control of the train phases: ``layers.attention`` through
    the kernel's forward, with the backward kernels called on another mask:
    ``"window dropped"`` (no window: a local layer's backward computed as a
    global one's) or ``"made causal"`` (BERT4Rec's bidirectional call)."""

    def __init__(self, torch, fault: str):
        from repro_torch.kernels.flash_attention import kernel as FK

        self.fault = fault

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v, causal, window):
                out = FK.flash_attention_cuda(q, k, v, causal=causal, window=window)
                ctx.save_for_backward(q, k, v, out)
                ctx.mask = (causal, None) if fault == "window dropped" else (True, window)
                return out

            @staticmethod
            def backward(ctx, dout):
                q, k, v, out = ctx.saved_tensors
                return (*FK.flash_attention_bwd_cuda(q, k, v, out, dout.contiguous(), *ctx.mask),
                        None, None)

        self.fn = Fn

    def __call__(self, q, k, v, causal=True, window=None):
        out = self.fn.apply(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal,
                            window)
        return out.transpose(1, 2)


def _grads_of(torch, model, batches, loss_fn, attention=None):
    """The loss (mean over the microbatches) and the model's gradients
    (summed over them), no update; with ``attention`` in place of
    ``layers.attention``."""
    from repro_torch.models import layers as L

    for p in model.parameters():
        p.grad = None

    def run():
        losses = []
        for mb in batches:
            loss = loss_fn(model, mb)
            loss.backward()
            losses.append(float(loss.detach()))
        return sum(losses) / len(losses)

    loss = run() if attention is None else with_attention(L, attention, run)
    torch.cuda.synchronize()
    return loss


def _host_grads(model) -> dict:
    """The model's gradients copied to the host, by parameter name (a
    gemma3-4b copy takes 7.8 GB of host memory)."""
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters()}


def _rel_errs(torch, dev, got: dict, want: dict) -> dict:
    """Per leaf max |a - b| / max |b| of ``got`` against ``want`` (host
    tensors by name), each leaf compared on the card."""
    out = {}
    for name, w in want.items():
        a, b = got[name].to(dev).float(), w.to(dev).float()
        out[name] = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    return out


def train_phase(torch, dev, phase: TrainPhase) -> tuple:
    """One train phase through ``launch/train.py``'s own ``train_setup``
    and ``launch.steps.train_step``: seeded random weights at full width;
    the first step's loss and gradients through the kernels against the
    same step through the plain attention on the card (TRAIN_GRAD_RTOL;
    the faulty control beyond it), for a recsys arch also a slice of
    rows against the port on the CPU; then ``phase.steps`` steps with the
    counters set to 0 just before and read just after (launches as
    designed), the last one traced; the loss on the first batch must fall
    over the steps.  Returns its report and the kernels' launches."""
    from repro_torch.data.pipeline import PipelineState
    from repro_torch.kernels import build as B
    from repro_torch.launch import serve
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as TL

    argv = ["--arch", phase.arch, "--config", "full", "--cell", phase.cell,
            "--batch", str(phase.batch), "--microbatches", str(phase.microbatches),
            "--steps", str(phase.steps), "--device", str(dev)]
    argv += ["--layers", str(phase.layers)] if phase.layers else []
    setup = TL.train_setup(TL.build_parser().parse_args(argv))
    # The cell's AdamW warms up over 100 steps; a few steps must move the loss.
    setup.opt_cfg = dataclasses.replace(setup.opt_cfg, lr=phase.lr, warmup_steps=TRAIN_WARMUP,
                                        total_steps=phase.steps)
    cfg = setup.cfg
    lm = setup.spec.family == "lm"
    t0 = time.perf_counter()
    model = setup.init_model_fn(torch.Generator(device=dev).manual_seed(TRAIN_SEED))
    model.requires_grad_(True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    dtype = str(cfg.adtype).removeprefix("torch.")
    micro = setup.microbatches
    batches = [serve.to_device(setup.pipeline.batch(PipelineState(s)), dev)
               for s in range(phase.steps)]
    first = [S.microbatch(batches[0], i, micro) for i in range(micro)]
    route = first if phase.route_rows is None else [
        {k: v[:phase.route_rows] for k, v in batches[0].items()}]
    n_attn = cfg.n_layers if lm else (cfg.n_blocks if phase.arch == "bert4rec" else 0)
    # The backward's kernels: gemma3-4b's bf16 D = 256 takes the sm90 pair
    # (kernel.bwd_route), BERT4Rec's fp32 bidirectional encoder the resident
    # kernel alone; the launch counts below hold each arch to its own.  The
    # other archs have no attention.
    from repro_torch.kernels.flash_attention import kernel as FK

    if lm:
        seq = setup.pipeline.seq_len
        bwd_kernels = BWD_ROUTE_KERNELS[FK.bwd_route(cfg.adtype, cfg.n_heads, cfg.n_kv_heads, seq,
                                                     seq, cfg.head_dim, True, None)]
    else:
        bwd_kernels = BWD_ROUTE_KERNELS["resident"] if n_attn else ()
    report = {"arch": phase.arch, "cell": phase.cell, "rows": phase.batch, "microbatches": micro,
              "layers": cfg.n_layers if lm else None, "dtype": dtype, "init_s": init_s,
              "params": cfg.n_params()}
    print(f"train {phase.arch} [{phase.cell}: {phase.batch} rows in {micro} microbatch(es)"
          f"{', ' + str(cfg.n_layers) + ' layers' if lm else ''}, {dtype}]: "
          f"{cfg.n_params() / 1e9:.3f} B parameters, init {init_s:.1f}s", flush=True)

    # The first step's gradients, kernel route against the plain route.
    if lm or phase.arch == "bert4rec":
        B.reset_launch_counts()
        loss_k = _grads_of(torch, model, route, setup.loss_fn)
        first_launches = {n: B.LAUNCHES[n] for n in BWD_KERNELS}
        if first_launches != {n: n_attn * len(route) * (n in bwd_kernels) for n in BWD_KERNELS}:
            raise AssertionError(f"{phase.arch}: first step's backward launches "
                                 f"{first_launches}, want {n_attn * len(route)} of each of "
                                 f"{bwd_kernels} and none of the others")
        kernel_grads = _host_grads(model)
        loss_p = _grads_of(torch, model, route, setup.loss_fn, plain_route_attention)
        plain_grads = _host_grads(model)
        control = FaultyBackward(torch, "window dropped" if lm else "made causal")
        loss_c = _grads_of(torch, model, route, setup.loss_fn, control)
        ctrl_errs = _rel_errs(torch, dev, _host_grads(model), plain_grads)
        for p in model.parameters():
            p.grad = None
        errs = _rel_errs(torch, dev, kernel_grads, plain_grads)
        del kernel_grads, plain_grads
        worst = max(errs, key=errs.get)
        ctrl_worst = max(ctrl_errs, key=ctrl_errs.get)
        loss_err = abs(loss_k - loss_p) / abs(loss_p)
        report["first_step"] = {
            "rows": sum(next(iter(mb.values())).shape[0] for mb in route),
            "loss_kernels": loss_k, "loss_plain": loss_p, "loss_rel_err": loss_err,
            "grad_rel_err_max": errs[worst], "grad_worst_leaf": worst,
            "grad_rel_err_median": float(np.median(list(errs.values()))),
            "control": control.fault, "control_loss": loss_c,
            "control_grad_rel_err_max": ctrl_errs[ctrl_worst], "control_worst_leaf": ctrl_worst,
            "limit": TRAIN_GRAD_RTOL[dtype],
        }
        print(f"  first step: loss {loss_k:.6f} (plain route {loss_p:.6f}, rel. {loss_err:.3g}); "
              f"gradients' relative max error per leaf: max {errs[worst]:.4g} ({worst}), median "
              f"{report['first_step']['grad_rel_err_median']:.4g}, limit "
              f"{TRAIN_GRAD_RTOL[dtype]}; control ({report['first_step']['control']}) "
              f"{ctrl_errs[ctrl_worst]:.4g} ({ctrl_worst})", flush=True)
        if not loss_err <= TRAIN_LOSS_RTOL[dtype]:
            raise AssertionError(f"{phase.arch}: first loss {loss_k} vs plain {loss_p}")
        if not errs[worst] <= TRAIN_GRAD_RTOL[dtype]:
            raise AssertionError(f"{phase.arch}: gradient {worst} off the plain route's by "
                                 f"{errs[worst]:.4g} > {TRAIN_GRAD_RTOL[dtype]}")
        if not ctrl_errs[ctrl_worst] > TRAIN_GRAD_RTOL[dtype]:
            raise AssertionError(f"{phase.arch}: the faulty control was not caught "
                                 f"({ctrl_errs[ctrl_worst]:.4g})")
    if not lm:
        report["cpu_slice"] = recsys_cpu_slice(torch, model, setup, batches[0])

    # The train steps, through the kernels.
    opt = S.train_state(model, setup.opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    B.reset_launch_counts()
    losses, step_s = [], []
    for s in range(phase.steps - 1):
        t0 = time.perf_counter()
        losses.append(float(S.train_step(model, opt, batches[s], micro, setup.loss_fn)))
        step_s.append(time.perf_counter() - t0)
    trace = train_trace(torch, model, opt, batches[-1], micro, setup.loss_fn)
    losses.append(trace.pop("loss"))
    torch.cuda.synchronize()
    launches = {n: B.LAUNCHES[n] for n in (*BWD_KERNELS, "flash_attention_sm90",
                                           "flash_attention_resident", "flash_attention_kernel")}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    design = {n: n_attn * micro * phase.steps * (n in bwd_kernels) for n in BWD_KERNELS}
    if lm:  # the forward and its replay under the block remat
        design["flash_attention_sm90"] = 2 * n_attn * micro * phase.steps
    elif n_attn:
        design["flash_attention_resident"] = n_attn * phase.steps
    got = {n: launches[n] for n in design}
    if got != design:
        raise AssertionError(f"{phase.arch}: train launches {got}, designed {design}")
    with torch.no_grad():
        after = sum(float(setup.loss_fn(model, mb)) for mb in first) / micro
    before = losses[0]  # the first step's loss: the first batch at the initial weights
    if not (all(np.isfinite(losses)) and np.isfinite(after) and after < before):
        raise AssertionError(f"{phase.arch}: losses {losses}, first batch {before} -> {after}")
    tokens = phase.batch * (setup.pipeline.seq_len if lm else 1)
    steady = float(np.median(step_s[1:])) if len(step_s) > 1 else step_s[0]
    report.update({
        "losses": losses, "first_batch_loss_before": before, "first_batch_loss_after": after,
        "step_s": step_s, "step_s_median": steady, "rows_or_tokens_per_s": tokens / steady,
        "peak_gib": peak, "launches": launches, "launches_design": design, **trace,
    })
    if lm:
        # 6·N·T, N counting the embedding table once: tied (gemma3-4b), it
        # is the head's product; its lookup adds no flops.
        flops = 6 * cfg.n_params() * tokens
        report["model_flops_share"] = flops / steady / BF16_OPS_PER_S
    print(f"  steps: losses {[round(x, 5) for x in losses]}; first batch {before:.5f} -> "
          f"{after:.5f}; step {steady:.3f} s ({tokens / steady:,.0f} "
          f"{'tokens' if lm else 'rows'}/s), peak {peak:.2f} GiB"
          + (f", model FLOPs {report['model_flops_share']:.1%} of 989 TFLOP/s" if lm else "")
          + f"; launches {launches}", flush=True)
    del opt, model, batches, first
    return report, {n: launches[n] for n in BWD_KERNELS}


def recsys_cpu_slice(torch, model, setup, batch) -> dict:
    """A recsys model's loss and gradients on its first ``CPU_TRAIN_ROWS``
    rows on the card against its copy on the CPU (the same state dict)."""
    rows = {k: v[:CPU_TRAIN_ROWS] for k, v in batch.items()}
    host = type(model)(model.cfg, "cpu")
    host.load_state_dict({k: v.detach().cpu() for k, v in model.state_dict().items()})
    host.requires_grad_(True)
    for p in model.parameters():
        p.grad = None
    loss = setup.loss_fn(model, rows)
    loss.backward()
    host_loss = setup.loss_fn(host, {k: v.cpu() for k, v in rows.items()})
    host_loss.backward()
    card = dict(model.named_parameters())
    scale = max(float(p.grad.abs().max()) for p in host.parameters())
    worst = 0.0
    for name, p in host.named_parameters():
        err = (card[name].grad.float().cpu() - p.grad).abs() / (p.grad.abs() + scale)
        worst = max(worst, float(err.max()))
    for p in model.parameters():
        p.grad = None
    lerr = abs(float(loss.detach()) - float(host_loss.detach())) / abs(float(host_loss.detach()))
    print(f"  {CPU_TRAIN_ROWS} rows against the CPU port: loss rel. {lerr:.3g}, gradients "
          f"{worst:.3g} (limit {TRAIN_GRAD_RTOL['float32']})", flush=True)
    if lerr > TRAIN_LOSS_RTOL["float32"] or worst > TRAIN_GRAD_RTOL["float32"]:
        raise AssertionError(f"{model.cfg.name}: the card's step disagrees with the CPU port's "
                             f"(loss {lerr:.3g}, gradients {worst:.3g})")
    return {"rows": CPU_TRAIN_ROWS, "loss_rel_err": lerr, "grad_err": worst}


def train_trace(torch, model, opt, batch, micro, loss_fn, groups=None) -> dict:
    """One train step under ``torch.profiler``, with CUDA events recorded on
    the stream around each microbatch's forward pass and around the
    optimizer: the step's host-clock s; its device time by part — the
    stream's ms between those events (kernels and the gaps between them):
    the forward passes, the backward passes (from a forward's end to the
    next forward or the optimizer; the block remat's replayed forward
    included), of which the attention backward's kernels (their own
    profiler events), and the optimizer; the kernels' total, the device's
    idle share, and the step's loss.  ``groups`` ({label: name parts})
    adds the device ms of the kernels whose names hold any part, as
    ``<label>_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps as S

    marks = []

    def marked(fn, label):
        def wrapped(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            marks.append((label, start, end))
            return out
        return wrapped

    original = S.adamw_update
    S.adamw_update = marked(original, "optimizer")
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            loss = float(S.train_step(model, opt, batch, micro, marked(loss_fn, "forward")))
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        S.adamw_update = original
    parts = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    for (label, start, end), nxt in zip(marks, marks[1:] + [None]):
        parts[label] += start.elapsed_time(end)
        if label == "forward" and nxt is not None:
            parts["backward"] += end.elapsed_time(nxt[1])
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    out = {"loss": loss, "traced_step_s": wall_s, "forward_ms": parts["forward"],
           "backward_ms": parts["backward"], "optimizer_ms": parts["optimizer"]}
    if device_us <= 0.0:
        print("  train trace: the profiler saw no device time (not measured)", flush=True)
        out.update({"device_ms": None, "attention_backward_ms": None, "idle_share": None})
        return out
    out.update({"device_ms": device_us / 1e3,
                "attention_backward_ms": sum(e.time_range.elapsed_us() for e in kernels
                                             if "flash_bwd" in e.name) / 1e3,
                "idle_share": 1.0 - device_us / 1e6 / wall_s})
    for label, parts in (groups or {}).items():
        out[f"{label}_ms"] = sum(e.time_range.elapsed_us() for e in kernels
                                 if any(part in e.name for part in parts)) / 1e3
    out["other_backward_ms"] = out["backward_ms"] - out["attention_backward_ms"]
    print(f"  traced step: {wall_s:.3f} s; stream ms: forward {out['forward_ms']:.1f}, backward "
          f"{out['backward_ms']:.1f} (attention backward kernels {out['attention_backward_ms']:.1f}, "
          f"the rest {out['other_backward_ms']:.1f}, remat replay included), optimizer "
          f"{out['optimizer_ms']:.1f}; device kernels {out['device_ms']:.1f} ms, idle "
          f"{out['idle_share']:.1%}", flush=True)
    return out


def checkpoint_phase(torch, dev) -> dict:
    """Checkpoint and restart on the card through ``launch/train.py``'s
    ``train_setup``/``make_trainer`` and the ``Trainer``: dcn-v2 at
    ``train_batch``, ``CKPT_STEPS`` steps with a checkpoint every
    ``CKPT_EVERY``; the state at the first checkpoint kept at its save, then
    restored from disk (params, moments, step: bit-equal) with the next
    batch (bit-equal to the one the run fed); the later checkpoint
    removed, a new trainer resumes, and its losses must match the
    uninterrupted run's (``CKPT_LOSS_RTOL``; bit for bit is reported)."""
    import shutil

    from repro_torch.data.pipeline import PipelineState
    from repro_torch.launch import train as TL
    from repro_torch.train.checkpoint import CheckpointManager

    ckdir = ROOT / "build" / "chip_smoke_ckpt"
    args = TL.build_parser().parse_args(
        ["--arch", "dcn-v2", "--config", "full", "--cell", "train_batch", "--steps",
         str(CKPT_STEPS), "--ckpt-dir", str(ckdir), "--device", str(dev)])
    setup = TL.train_setup(args)
    setup.trainer_cfg = dataclasses.replace(setup.trainer_cfg, ckpt_every=CKPT_EVERY,
                                            log_every=10**9)
    shutil.rmtree(setup.trainer_cfg.ckpt_dir, ignore_errors=True)
    fed = []
    real_batch = setup.pipeline.batch

    def recording(state, shard=0):
        out = real_batch(state, shard)
        fed.append((state.step, out))
        return out

    setup.pipeline.batch = recording
    t0 = time.perf_counter()
    first = TL.make_trainer(setup)
    saved = {}

    def keep(step, loss):
        if step + 1 == CKPT_EVERY:  # just saved
            saved.update(first.state_of(first.opt, step + 1))
            saved["params"] = {k: v.detach().cpu().clone() for k, v in first.opt.params.items()}
            saved["opt"] = {"mu": {k: v.cpu().clone() for k, v in first.opt.opt["mu"].items()},
                            "nu": {k: v.cpu().clone() for k, v in first.opt.opt["nu"].items()},
                            "step": first.opt.opt["step"].cpu().clone()}

    first.run(on_step=keep)
    full = [loss for _, loss, _ in first.history]
    mgr = CheckpointManager(setup.trainer_cfg.ckpt_dir)
    step, restored = mgr.restore(first.state_of(first.opt, 0), CKPT_EVERY)
    bit_equal = {
        "params": all(torch.equal(restored["params"][k].cpu(), v)
                      for k, v in saved["params"].items()),
        "moments": all(torch.equal(restored["opt"][m][k].cpu(), v)
                       for m in ("mu", "nu") for k, v in saved["opt"][m].items()),
        "step": torch.equal(restored["opt"]["step"].cpu(), saved["opt"]["step"]),
        "pipeline_step": int(restored["pipeline_step"]) == int(saved["pipeline_step"])
        == CKPT_EVERY}
    nxt = real_batch(PipelineState(int(restored["pipeline_step"])))
    fed_next = dict(fed)[CKPT_EVERY]
    batch_equal = all(np.array_equal(nxt[k], fed_next[k]) for k in fed_next)
    del restored, saved
    shutil.rmtree(Path(setup.trainer_cfg.ckpt_dir) / f"ckpt_{CKPT_STEPS:08d}")
    second = TL.make_trainer(setup)
    second.run()
    resumed = [loss for _, loss, _ in second.history]
    steps_resumed = [s for s, _, _ in second.history]
    wall_s = time.perf_counter() - t0
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, full[CKPT_EVERY:], strict=True))
    out = {"arch": "dcn-v2", "rows": setup.pipeline.batch_per_shard, "steps": CKPT_STEPS,
           "ckpt_every": CKPT_EVERY, "restored_bit_equal": bit_equal,
           "next_batch_bit_equal": batch_equal, "losses_full": full, "losses_resumed": resumed,
           "steps_resumed": steps_resumed, "loss_rel_err": rel,
           "losses_bit_equal": resumed == full[CKPT_EVERY:], "wall_s": wall_s,
           "state_mib": sum(p.numel() * 4 * 3 for p in first.opt.params.values()) / 2**20}
    print(f"checkpoint restart (dcn-v2, {out['rows']} rows, {out['state_mib']:.0f} MiB of "
          f"params and moments): restored bit-equal {bit_equal}, next batch bit-equal "
          f"{batch_equal}; resumed steps {steps_resumed} losses {resumed} vs "
          f"{full[CKPT_EVERY:]} (rel. {rel:.3g}, bit for bit {out['losses_bit_equal']}) in "
          f"{wall_s:.1f}s", flush=True)
    shutil.rmtree(setup.trainer_cfg.ckpt_dir, ignore_errors=True)
    if not (all(bit_equal.values()) and batch_equal and steps_resumed == list(range(CKPT_EVERY, CKPT_STEPS))
            and rel <= CKPT_LOSS_RTOL):
        raise AssertionError(f"checkpoint restart failed: {out}")
    return out


def sanitizer_phase(torch, svc, cq) -> dict:
    """The sanitizer on the warm fold of the search service: a warm batch
    inside ``no_implicit_transfers`` (``set_sync_debug_mode("error")`` and
    the sentinel) is clean and equal; a planted ``.item()`` in the fold's
    path raises (the sentinel), and so does a planted ``torch.nonzero``
    (a sync inside an operator, which only the CUDA guard sees)."""
    from repro_torch.analysis.sanitize import ImplicitTransferError, no_implicit_transfers
    from repro_torch.core import device_engine

    want, _ = svc.serve_counts_device(cq)  # warm
    with no_implicit_transfers():
        counts, _ = svc.serve_counts_device(cq)
    if not np.array_equal(counts, want):
        raise AssertionError("the sanitized warm fold changed the counts")
    real = device_engine.device_fold
    caught = {}
    plants = {"item": lambda out: out[0].sum().item(),
              "nonzero": lambda out: torch.nonzero(out[0])}
    for name, plant in plants.items():
        def leaky(*args, plant=plant, **kwargs):
            out = real(*args, **kwargs)
            plant(out)
            return out

        device_engine.device_fold = leaky
        try:
            with no_implicit_transfers():
                svc.serve_counts_device(cq)
            caught[name] = None
        except (ImplicitTransferError, RuntimeError) as exc:
            caught[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:120]}"
        finally:
            device_engine.device_fold = real
    print(f"sanitizer on the warm fold ({len(cq)} queries): clean and equal; planted "
          f"{caught}", flush=True)
    if any(v is None for v in caught.values()):
        raise AssertionError(f"a planted sync was not caught: {caught}")
    return {"queries": len(cq), "clean": True, "caught": caught}


# ----------------------------------------------------------------------
# PNA: full-batch ogb_products training through the aggregation kernels
# ----------------------------------------------------------------------

# The pna phase (after the train phases, on the emptied card): ogb_products
# at its full graph (2,449,029 nodes; synth_graph at degree round(61,859,140
# / 2,449,029) = 25 gives 61,225,725 edges, the one cut) and full width,
# PNA_STEPS steps (the first warms up, the last is traced); its layer-1
# aggregation kernel against its plain version's formulas in float64 in
# destination ranges of at most PNA_RANGE_EDGES edges and PNA_RANGE_NODES
# nodes (a node's edges are never split: node 0's 11.5 M edges make one
# range), with dropped-record controls at node 0 and at the split node whose
# in-degree is nearest PNA_CONTROL_EDGES; a step through the kernels against the same step
# through the plain version at PNA_ROUTE_CELLS (minibatch_lg: one sampled
# batch of 1,024 seeds over its 232,965-node graph at degree 492, built on
# the host while the card trains ogb_products).
PNA_STEPS = 4
PNA_RANGE_EDGES = 8_000_000
PNA_RANGE_NODES = 300_000  # ~40 (nodes, 75) float64 tensors of the reference: 7 GB
PNA_CONTROL_EDGES = 100_000
# The merge records left out by the dropped-record controls: one run's
# (record 1) and the first past the merge's 32 warps (record 32, which a
# mis-strided merge would skip).
PNA_DROPPED_RECORDS = ((1, "dropped_run"), (32, "dropped_record_past_warp_32"))
# The reference takes its edges this many at a time (each (edges, 75)
# float64 temporary 1.2 GB).
PNA_CHUNK_EDGES = 2_000_000
PNA_ROUTE_CELLS = ("full_graph_sm", "molecule", "minibatch_lg")
PNA_SEED = 0
PNA_KERNELS = ("segment_aggregate_fwd", "segment_aggregate_bwd")
# Operations a message and feature costs, float32 and float64: the
# forward's add, relu, weight multiply and two compares, and its two
# float64 sums (one of a square); the backward's recompute and dv (~11 with
# the ties and the mask) and its float64 sum into d hd.
AGG_FWD_OPS, AGG_BWD_OPS = (5, 3), (11, 1)
# H100 SXM float64 rate outside the tensor cores (NVIDIA data sheet; the
# measurement guide's table has no float64 row): the peak for the sums.
FP64_OPS_PER_S = 34e12
PNA_TRACE_GROUPS = {"aggregation_forward": ("seg_agg_fwd", "seg_agg_fill"),
                    "aggregation_backward": ("seg_agg_bwd",),
                    "matmul": ("gemm", "Gemm", "GEMM")}


def pna_args(cell: str, dev, steps: int = 1) -> list:
    return ["--arch", "pna", "--config", "full", "--cell", cell, "--steps", str(steps),
            "--device", str(dev)]


def plain_aggregate(hs, hd, csr, run_edges=None):
    """``ops.segment_aggregate`` through the plain version on any device
    (the route the card's parity runs compare against)."""
    from repro_torch.kernels.segment_aggregate.ref import segment_aggregate_ref

    return segment_aggregate_ref(hs, hd, csr.src, csr.dst, csr.w, csr.n_nodes)


def destination_ranges(indptr, budget: int, max_nodes: int) -> list:
    """Node ranges [lo, hi) of at most ``max_nodes`` nodes whose edges
    number at most ``budget`` (or one node alone past it), from the host's
    indptr."""
    ranges, lo = [], 0
    n = len(indptr) - 1
    while lo < n:
        hi = int(np.searchsorted(indptr, indptr[lo] + budget, side="right")) - 1
        hi = min(max(hi, lo + 1), n, lo + max_nodes)
        ranges.append((lo, hi))
        lo = hi
    return ranges


def aggregate_bytes(n: int, e: int, d: int) -> dict:
    """Bytes each kernel's function must move, each input read once and
    each output written once: forward hs, hd, the edges and indptr in,
    mean, max, min, std and deg out; backward those inputs, the forward's
    outputs and the four cotangents in, d hs and d hd out.  Besides: the
    state this design saves between them (the tie counts and q's sign,
    written by the forward and read by the backward), and the source rows
    gathered once an edge."""
    fp = 4 * n * d
    inputs = 2 * fp + 3 * 4 * e + 4 * (n + 1)  # hs, hd, src/dst/w, indptr
    outputs = 4 * fp + 4 * n  # mean..std, deg
    return {"fwd": inputs + outputs, "bwd": inputs + outputs + 4 * fp + 2 * fp,
            "saved": 2 * fp + n * d, "gathered": 4 * e * d}


def dropped_record_edges(indptr, node: int, run_edges: int, k: int) -> tuple:
    """The edges of ``node``'s k-th merge record (k >= 1: the head of the
    k-th run after the one holding its first edge; record k is summed by
    the merge's warp k mod 32), as positions in the sorted edges."""
    start, end = int(indptr[node]), int(indptr[node + 1])
    e0 = (start // run_edges + k) * run_edges
    if e0 >= end:
        raise ValueError(f"node {node} ({end - start} edges) has no record {k}")
    return e0, min(e0 + run_edges, end)


def aggregation_check(torch, dev, hs, hd, csr, run_edges) -> dict:
    """Layer 1's aggregation at the path's graph: the kernels against the
    plain version's formulas in float64 over destination ranges
    (``_torch_parity.AggregateCheck``: max, min, deg and the tie counts bit
    for bit, mean, std, d hs and d hd within the limits of the kernels'
    float64 sums), the faulty controls beyond them (ties not averaged; at
    node 0 and at the split node nearest PNA_CONTROL_EDGES in-edges, one
    run's record dropped from the merge and the first record past its 32nd
    warp dropped), and each kernel's time eager and as a graph replay
    beside its bounds and the plain version's time on the largest range."""
    from _torch_parity import AggregateCheck, dropped_edges_shares

    from repro_torch.kernels.segment_aggregate import kernel as AK
    from repro_torch.kernels.segment_aggregate.ref import segment_aggregate_ref

    n, d = hs.shape
    e = csr.src.shape[0]
    gen = torch.Generator(device=dev).manual_seed(PNA_SEED + 1)
    grads = [torch.randn((n, d), generator=gen, device=dev) for _ in range(4)]
    saved = AK.segment_aggregate_fwd_cuda(hs, hd, csr, run_edges)
    d_hs, d_hd = AK.segment_aggregate_bwd_cuda(hs, hd, csr, saved, *grads, run_edges=run_edges)
    torch.cuda.synchronize()
    indptr = csr.indptr.cpu().numpy().astype(np.int64)
    ranges = destination_ranges(indptr, PNA_RANGE_EDGES, PNA_RANGE_NODES)
    in_deg = np.diff(indptr)
    split = np.nonzero((in_deg > 0) & ((indptr[1:] - 1) // run_edges > indptr[:-1] // run_edges))[0]
    mid = int(split[np.argmin(np.abs(in_deg[split] - PNA_CONTROL_EDGES))])
    planted = {x: {f"{label}_node{x}": dropped_record_edges(indptr, x, run_edges, k)
                   for k, label in PNA_DROPPED_RECORDS} for x in (0, mid)}
    check = AggregateCheck(hs, d_hs, chunk=PNA_CHUNK_EDGES)
    controls = {}
    t0 = time.perf_counter()
    for lo, hi in ranges:
        e0, e1 = int(indptr[lo]), int(indptr[hi])
        src, dst, w = csr.src[e0:e1], csr.dst[e0:e1] - lo, csr.w[e0:e1]
        with torch.no_grad():
            ref = check.add(hd[lo:hi], src, dst, w, [g[lo:hi] for g in grads],
                            tuple(t[lo:hi] for t in saved[:7]), d_hd[lo:hi], lo)
            for x, records in planted.items():
                if lo <= x < hi:
                    for name, (r0, r1) in records.items():
                        mean_share, d_hd_share = dropped_edges_shares(
                            hs, hd[lo:hi], src, dst, w, ref, x - lo, r0 - e0, r1 - e0,
                            saved.mean[x], d_hd[x])
                        controls[name] = {"edges": [r0, r1], "mean": mean_share,
                                          "d_hd": d_hd_share}
        del ref
        torch.cuda.empty_cache()
    result = check.finish()
    plain_check_s = time.perf_counter() - t0
    shares = result["shares"]
    if not check.within():
        raise AssertionError(f"segment_aggregate: off the float64 reference beyond its derived "
                             f"limit: {shares}")
    low = {k: v for k, v in shares.items() if k.startswith("ties_control") and not v > 1.0}
    low.update({f"{k} {f}": c[f] for k, c in controls.items() for f in ("mean", "d_hd")
                if not c[f] > 1.0})
    if low or len(controls) != 4:
        raise AssertionError(f"segment_aggregate: faulty controls not caught: {low} "
                             f"({len(controls)} of 4 planted)")
    report = {"ranges": len(ranges), "largest_range_edges": max(int(indptr[h] - indptr[l])
                                                                for l, h in ranges),
              "node0_edges": int(in_deg[0]), "split_destinations": int(len(split)),
              "control_node": mid, "control_node_edges": int(in_deg[mid]),
              "shares_of_limit": shares, "controls": controls,
              "max_abs_err": result["max_abs_err"], "plain_check_s": plain_check_s}
    del check
    torch.cuda.empty_cache()

    # Times: each kernel eager and as a graph replay; the plain version on the
    # largest range (node 0's), forward and forward + backward.
    big = max(ranges, key=lambda r: indptr[r[1]] - indptr[r[0]])
    lo, hi = big
    e0, e1 = int(indptr[lo]), int(indptr[hi])
    sub = (csr.src[e0:e1], csr.dst[e0:e1] - lo, csr.w[e0:e1])
    plain_fwd = time_ms(lambda: segment_aggregate_ref(hs, hd[lo:hi], *sub, hi - lo), reps=2,
                        warmup=1)
    hs_g, hd_g = hs.detach().requires_grad_(True), hd[lo:hi].detach().requires_grad_(True)

    def plain_both():
        out = segment_aggregate_ref(hs_g, hd_g, *sub, hi - lo)
        torch.autograd.grad(out[:4], (hs_g, hd_g), [g[lo:hi] for g in grads])

    plain_bwd = time_ms(plain_both, reps=1, warmup=0)  # seconds at node 0 (its atomics)
    fwd = lambda: AK.segment_aggregate_fwd_cuda(hs, hd, csr, run_edges)  # noqa: E731
    bwd = lambda: AK.segment_aggregate_bwd_cuda(hs, hd, csr, saved, *grads,  # noqa: E731
                                                run_edges=run_edges)
    nbytes = aggregate_bytes(n, e, d)
    errs = result["max_abs_err"]
    rows = {}
    for name, fn, (ops32, ops64), byts, plain_ms, err in (
            ("segment_aggregate_fwd", fwd, AGG_FWD_OPS, nbytes["fwd"], plain_fwd,
             max(errs["mean"], errs["std"])),
            ("segment_aggregate_bwd", bwd, AGG_BWD_OPS, nbytes["bwd"], plain_bwd,
             max(errs["d_hs"], errs["d_hd"]))):
        bytes_ms = byts / MEM_BYTES_PER_S * 1e3
        ops_ms = (ops32 / FP32_OPS_PER_S + ops64 / FP64_OPS_PER_S) * e * d * 1e3
        rows[name] = {
            "shape": f"N={n} E={e} d={d} run_edges={run_edges}", "ms": time_ms(fn, reps=5),
            "device_ms": graph_ms(fn, reps=5), "plain_ms": plain_ms,
            "plain_range": f"nodes [{lo}, {hi}), {e1 - e0} edges",
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms
            else "operations", "bytes": byts, "bytes_bound_ms": bytes_ms,
            "ops_bound_ms": ops_ms, "saved_state_bytes": nbytes["saved"],
            "with_saved_state_bound_ms": (byts + nbytes["saved"]) / MEM_BYTES_PER_S * 1e3,
            "gather_bound_ms": (byts + nbytes["gathered"]) / MEM_BYTES_PER_S * 1e3,
            "library_ms": None, "max_abs_err": err}
    report["rows"] = rows
    return report


def plain_ties_whole(hs, hd, csr, run_edges=None):
    """A faulty control: the plain version with each tied max's and min's
    gradient given whole to every tied edge (the same values forward)."""
    import torch

    from repro_torch.kernels.segment_aggregate.ref import messages_ref, segment_aggregate_ref

    mean, mx, mn, std, deg = segment_aggregate_ref(hs, hd, csr.src, csr.dst, csr.w, csr.n_nodes)
    v = messages_ref(hs, hd, csr.src, csr.dst, csr.w)
    idx = csr.dst.long()
    pos = (csr.w > 0)[:, None]
    out = []
    for ext in (mx, mn):
        tie = (pos & (v.detach() == ext.detach()[idx])).to(v.dtype)
        whole = torch.zeros_like(ext).index_add(0, idx, v * tie)
        out.append(ext.detach() + whole - whole.detach())
    return mean, out[0], out[1], std, deg


class AggregateRecorder:
    """Wraps ``models.pna.segment_aggregate`` (the kernels): records each
    call's ``hs``, ``hd`` and, through hooks, the gradients its outputs
    receive (the backward's recompute under the layer checkpoint is the
    call whose outputs get them)."""

    def __init__(self, pna):
        self.pna, self.original, self.calls = pna, pna.segment_aggregate, []
        pna.segment_aggregate = self

    def __call__(self, hs, hd, csr, run_edges=None):
        outs = self.original(hs, hd, csr) if run_edges is None else \
            self.original(hs, hd, csr, run_edges)
        call = {"hs": hs.detach(), "hd": hd.detach(), "grads": [None] * 4}
        self.calls.append(call)
        for i, out in enumerate(outs[:4]):
            if out.requires_grad:
                out.register_hook(lambda g, i=i, call=call: call["grads"].__setitem__(i, g))
        return outs

    def restore(self):
        self.pna.segment_aggregate = self.original


def pna_route_check(torch, dev, cell: str, host_batch=None) -> dict:
    """One step's loss and gradients at ``cell`` through the kernels against
    the same step through the plain version, on the card: the loss within
    TRAIN_LOSS_RTOL["float32"]; each leaf's gradients, max |a - b| / max |b|
    (the train phases' metric), within TRAIN_GRAD_RTOL["float32"], or
    FLOOR_MARGIN times that leaf's floor read in the run where that is
    larger, and a faulty control (ties not averaged) beyond some leaf's
    limit.  PNA's variance, Σv²/denom − mean², cancels where a node's
    messages are close (with-replacement sampling repeats a source), and
    its gradient divides by std ≥ sqrt(1e-5), so rounding alone moves such
    nodes' gradients by percents, and four layers carry it on (1.2e-4 per
    leaf between two summation orders of the plain version at
    full_graph_sm on the CPU).  The floor of a leaf: the largest distance
    from the plain route of the plain version with the backward in the
    kernels' form (``_torch_parity.aggregate_in_kernel_form``: one product
    for the std's term where autograd takes the difference of two large
    ones), summed in float32 in the same and in the reverse order, and in
    float64 as the kernels sum.  Each layer's aggregation is also held, with
    the step's own inputs and cotangents, to the float64 reference
    (``_torch_parity.AggregateCheck``)."""
    from _torch_parity import AggregateCheck, aggregate_in_kernel_form

    from repro_torch.kernels.segment_aggregate import kernel as AK
    from repro_torch.launch import train as TL
    from repro_torch.launch.serve import to_device
    from repro_torch.models import pna

    setup = TL.graph_setup(TL.build_parser().parse_args(pna_args(cell, dev)))
    batch = (setup.batch(0) if host_batch is None
             else pna.with_csr(to_device(host_batch, dev)))
    model = setup.init_model_fn(torch.Generator(device=dev).manual_seed(PNA_SEED))
    model.requires_grad_(True)
    recorder = AggregateRecorder(pna)
    try:
        loss_k = _grads_of(torch, model, [batch], pna.loss_fn)
    finally:
        recorder.restore()
    grads = {"kernels": _host_grads(model)}
    original = pna.segment_aggregate
    losses = {}
    floor_forms = [f"kernel form {o}" for o in ("sorted", "reversed", "float64")]
    try:
        for name, agg in (("plain", plain_aggregate), ("control", plain_ties_whole),
                          *((f, aggregate_in_kernel_form(f.split()[-1])) for f in floor_forms)):
            pna.segment_aggregate = agg
            losses[name] = _grads_of(torch, model, [batch], pna.loss_fn)
            grads[name] = _host_grads(model)
    finally:
        pna.segment_aggregate = original
    for p in model.parameters():
        p.grad = None
    leaf = _rel_errs(torch, dev, grads["kernels"], grads["plain"])
    control = _rel_errs(torch, dev, grads["control"], grads["plain"])
    floors = [_rel_errs(torch, dev, grads[f], grads["plain"]) for f in floor_forms]
    floor = {k: max(f[k] for f in floors) for k in leaf}
    limit = {k: max(TRAIN_GRAD_RTOL["float32"], FLOOR_MARGIN * floor[k]) for k in leaf}
    over = {k: leaf[k] / limit[k] for k in leaf}
    worst = max(over, key=over.get)
    control_over = max(control[k] / limit[k] for k in leaf)
    loss_err = abs(loss_k - losses["plain"]) / abs(losses["plain"])
    # Each layer's aggregation with the step's own inputs and cotangents.
    csr = pna.csr_of(batch)
    layers = [c for c in recorder.calls if all(g is not None for g in c["grads"])]
    if len(layers) != model.cfg.n_layers:
        raise AssertionError(f"pna {cell}: {len(layers)} aggregations received gradients")
    shares = {}
    for call in layers:
        hs, hd = call["hs"], call["hd"]
        g = [x.contiguous() for x in call["grads"]]
        saved = AK.segment_aggregate_fwd_cuda(hs, hd, csr)
        d_hs, d_hd = AK.segment_aggregate_bwd_cuda(hs, hd, csr, saved, *g)
        check = AggregateCheck(hs, d_hs)
        with torch.no_grad():
            check.add(hd, csr.src, csr.dst, csr.w, g, tuple(saved[:7]), d_hd)
        layer_shares = check.finish()["shares"]
        if not check.within():
            raise AssertionError(f"pna {cell}: a layer's aggregation beyond its limit: "
                                 f"{layer_shares}")
        for k, v in layer_shares.items():
            shares[k] = max(shares.get(k, 0.0), v)
    n, e = batch["feats"].shape[0], batch["edges"].shape[0]
    print(f"  pna {cell} ({n:,} nodes, {e:,} edges): loss {loss_k:.6f} (plain "
          f"{losses['plain']:.6f}, rel. {loss_err:.3g}); gradients per leaf (max |a - b| / max "
          f"|b|): worst {leaf[worst]:.4g} at {worst} against its limit {limit[worst]:.4g} (floor "
          f"{floor[worst]:.4g}); largest {max(leaf.values()):.4g}, largest floor "
          f"{max(floor.values()):.4g}; control, ties not averaged, {control_over:.4g} of its "
          f"limit; each layer's aggregation against float64: exact fields equal, shares of the "
          f"derived limit " + ", ".join(f"{k} {v:.3g}" for k, v in shares.items()), flush=True)
    if not loss_err <= TRAIN_LOSS_RTOL["float32"]:
        raise AssertionError(f"pna {cell}: loss {loss_k} vs plain {losses['plain']}")
    if not over[worst] <= 1.0:
        raise AssertionError(f"pna {cell}: gradient {worst} off the plain route's by "
                             f"{leaf[worst]:.4g} > {limit[worst]:.4g}")
    if not control_over > 1.0:
        raise AssertionError(f"pna {cell}: the faulty control was not caught ({control_over:.4g})")
    return {"nodes": n, "edges": e, "loss_kernels": loss_k, "loss_plain": losses["plain"],
            "loss_rel_err": loss_err, "grad_leaf_rel_err": leaf, "grad_leaf_floor": floor,
            "grad_leaf_limit": limit, "grad_worst_leaf": worst,
            "grad_leaf_max": max(leaf.values()),
            "leaves_within_train_grad_rtol": sum(v <= TRAIN_GRAD_RTOL["float32"]
                                                 for v in leaf.values()),
            "leaves": len(leaf), "control_share_of_limit": control_over,
            "layer_shares_of_limit": shares}


PNA_GRAPH_CELLS = ("ogb_products", "minibatch_lg")
PNA_GRAPH_DIR = ROOT / "build" / "pna_graphs"


def write_pna_graphs(out_dir: str) -> None:
    """Build ogb_products' full graph and minibatch_lg's first sampled
    batch on the host as ``launch/train.py``'s ``graph_setup`` builds them
    (numpy, the reference's calls), into ``<cell>.npz`` and their info into
    ``<cell>.json`` under ``out_dir``.  Run in a process of its own
    (``start_pna_graphs``): ~80 s of host work that overlaps the train
    phases."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import train as TL

    out = Path(out_dir)
    for cell in PNA_GRAPH_CELLS:
        setup = TL.graph_setup(TL.build_parser().parse_args(pna_args(cell, "cpu")))
        t0 = time.perf_counter()
        host = setup.host_batch(0)
        info = dict(setup.info, host_batch_s=time.perf_counter() - t0)
        np.savez(out / f"{cell}.npz", **host)
        (out / f"{cell}.json").write_text(json.dumps(info, default=float))


def start_pna_graphs():
    """Start ``write_pna_graphs`` in its own process (killed at exit if it
    still runs); returns the process."""
    import atexit
    import shutil

    shutil.rmtree(PNA_GRAPH_DIR, ignore_errors=True)
    PNA_GRAPH_DIR.mkdir(parents=True)
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
            f"chip_smoke.write_pna_graphs({str(PNA_GRAPH_DIR)!r})")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT)

    def stop():
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    atexit.register(stop)
    return proc


def load_pna_graph(proc, cell: str) -> tuple:
    """The host batch and info ``write_pna_graphs`` wrote for ``cell``,
    after its process ends."""
    t0 = time.perf_counter()
    if proc.wait(timeout=600) != 0:
        raise RuntimeError(f"building the pna graphs failed ({proc.returncode})")
    with np.load(PNA_GRAPH_DIR / f"{cell}.npz") as z:
        host = {k: z[k] for k in z.files}
    info = json.loads((PNA_GRAPH_DIR / f"{cell}.json").read_text())
    info["waited_s"] = time.perf_counter() - t0
    return host, info


def pna_phase(torch, dev, graphs) -> tuple:
    """PNA through ``launch/train.py``'s own ``graph_setup`` and
    ``launch.steps.train_step``: ogb_products at its full graph and width
    (the host batch from ``graphs``, the process ``start_pna_graphs``
    started; counters set to 0 just before the steps and read just after:
    per step 2 forward launches a layer, the layer's recompute under the
    checkpoint included, and 1 backward), its last step traced; then
    ``aggregation_check`` at layer 1 and ``pna_route_check`` at
    PNA_ROUTE_CELLS.  Returns its report, the kernels' launches and their
    rows."""
    from repro_torch.kernels import build as B
    from repro_torch.kernels.segment_aggregate import kernel as AK
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as TL
    from repro_torch.launch.serve import to_device
    from repro_torch.models import pna

    report = {}
    setup = TL.graph_setup(TL.build_parser().parse_args(pna_args("ogb_products", dev,
                                                                 PNA_STEPS)))
    host, info = load_pna_graph(graphs, "ogb_products")
    t0 = time.perf_counter()
    batch = pna.with_csr(to_device(host, dev))
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    del host
    host_s = info["host_batch_s"]
    cfg = setup.cfg
    n, e = batch["feats"].shape[0], batch["edges"].shape[0]
    print(f"pna ogb_products: {n:,} nodes, {e:,} edges (the cell's {info['cell_edges']:,}: "
          f"synth_graph at degree {info['degree']}), d_feat {cfg.d_feat}, d_hidden "
          f"{cfg.d_hidden}, {cfg.n_layers} layers, {cfg.n_params():,} parameters; host graph "
          f"{host_s:.1f}s (synth_graph {info['graph_s']:.1f}s) in its own process (waited "
          f"{info['waited_s']:.1f}s for it), upload and sort {upload_s:.1f}s", flush=True)
    model = setup.init_model_fn(torch.Generator(device=dev).manual_seed(PNA_SEED))
    model.requires_grad_(True)
    opt = S.train_state(model, setup.opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    B.reset_launch_counts()
    losses, step_s = [], []
    for _ in range(PNA_STEPS - 1):
        t0 = time.perf_counter()
        losses.append(float(S.train_step(model, opt, batch, 1, pna.loss_fn)))
        step_s.append(time.perf_counter() - t0)
    trace = train_trace(torch, model, opt, batch, 1, pna.loss_fn, PNA_TRACE_GROUPS)
    losses.append(trace.pop("loss"))
    torch.cuda.synchronize()
    launches = {k: B.LAUNCHES[k] for k in PNA_KERNELS}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    design = {"segment_aggregate_fwd": 2 * cfg.n_layers * PNA_STEPS,
              "segment_aggregate_bwd": cfg.n_layers * PNA_STEPS}
    if launches != design:
        raise AssertionError(f"pna: launches {launches}, designed {design}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"pna: losses {losses}")
    steady = float(np.median(step_s[1:]))
    flops = 3 * pna.matmul_flops(cfg, n)  # forward, and twice that in the backward
    report["ogb_products"] = {
        "nodes": n, "edges": e, "cell_edges": info["cell_edges"], "degree": info["degree"],
        "host_graph_s": host_s, "synth_graph_s": info["graph_s"],
        "graph_wait_s": info["waited_s"], "upload_sort_s": upload_s,
        "losses": losses, "step_s": step_s, "step_s_median": steady,
        "edges_per_s": e / steady, "nodes_per_s": n / steady, "peak_gib": peak,
        "matmul_tflop_per_step": flops / 1e12, "launches": launches, "launches_design": design,
        **trace}
    if trace.get("device_ms") is not None:
        trace["other_ms"] = trace["device_ms"] - sum(
            trace[f"{k}_ms"] for k in PNA_TRACE_GROUPS) - trace["optimizer_ms"]
        report["ogb_products"]["other_ms"] = trace["other_ms"]
        print(f"  device ms by part: aggregation forward {trace['aggregation_forward_ms']:.1f} "
              f"(recompute included), aggregation backward "
              f"{trace['aggregation_backward_ms']:.1f}, matrix products {trace['matmul_ms']:.1f}, "
              f"optimizer (stream) {trace['optimizer_ms']:.1f}, the rest {trace['other_ms']:.1f}",
              flush=True)
    print(f"  steps: losses {[round(x, 5) for x in losses]}; step {steady:.3f} s "
          f"({e / steady:,.0f} "
          f"edges/s, {n / steady:,.0f} nodes/s), peak {peak:.2f} GiB; launches {launches}",
          flush=True)

    # Layer 1's aggregation, kernel against plain, at the same graph.
    with torch.no_grad():
        h0 = torch.relu(model.encode(batch["feats"]))
        layer = model.layers[0]
        hs, hd = layer.w_src(h0).contiguous(), layer.w_dst(h0).contiguous()
    csr = pna.csr_of(batch)
    del opt, h0
    model.requires_grad_(False)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["layer1"] = aggregation_check(torch, dev, hs, hd, csr, AK.RUN_EDGES)
    report["layer1"]["wall_s"] = time.perf_counter() - t0
    lay = report["layer1"]
    print(f"  layer 1 aggregation, kernels against the plain version over {lay['ranges']} "
          f"destination ranges (largest {lay['largest_range_edges']:,} edges; node 0 "
          f"{lay['node0_edges']:,}; {lay['split_destinations']:,} destinations span runs): max, "
          f"min, deg and tie counts equal; shares of the derived limit "
          + ", ".join(f"{k} {v:.3g}" for k, v in lay["shares_of_limit"].items())
          + f" ({lay['wall_s']:.1f}s)", flush=True)
    for name, row in lay["rows"].items():
        print(f"  {name} {row['shape']}: ms={row['ms']:.4f} device_ms={row['device_ms']:.4f} "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}; with the gathered source "
              f"rows {row['gather_bound_ms']:.4f}) plain_ms={row['plain_ms']:.4f} on "
              f"{row['plain_range']}", flush=True)
    del batch, hs, hd, csr, model
    torch.cuda.empty_cache()

    # A step through the kernels against the plain version at the other cells.
    mb_batch, report["minibatch_lg_graph"] = load_pna_graph(graphs, "minibatch_lg")
    report["route"] = {}
    for cell in PNA_ROUTE_CELLS:
        report["route"][cell] = pna_route_check(
            torch, dev, cell, mb_batch if cell == "minibatch_lg" else None)
        torch.cuda.empty_cache()
    return report, launches, lay["rows"]


PHASE_S = {}  # each phase's wall time, also written to the run's JSON report


def phase_line(name: str, seconds: float, tail: str = "") -> None:
    """Print a phase's wall time on a line of its own and record it."""
    PHASE_S[name] = seconds
    print(f"phase {name}: {seconds:.1f}s{tail}", flush=True)


def phase_done(name: str, t0: float) -> float:
    """``phase_line`` of the phase that began at ``t0``; the time now."""
    now = time.perf_counter()
    phase_line(name, now - t0)
    return now


def kernel_entry(name, launches, rows, variant):
    source, replaces = SOURCES[name]
    main = rows[0]
    return {
        "name": name, "route": "cuda", "variant": variant, "source": source,
        "replaces": replaces, "launches": int(launches[name]),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main.get("bound_by", "bytes"), "library_ms": main.get("library_ms"),
        "shapes": rows,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))  # _torch_parity: the flash kernel's cases
    from repro_torch.kernels import build as B
    from repro_torch.launch import search

    t_start = time.perf_counter()
    print(card_line(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    paths = B.build_libraries()
    print(f"built {sorted(p.name for p in paths.values())} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for stem, lines in B.PTXAS.items():
        print(f"ptxas {stem}.cu: " + " | ".join(lines), flush=True)

    t0 = phase_done("build", t0)
    check_intersect_cases(torch, dev)
    check_fold_cases(torch, dev)
    score_case_err = check_cluster_score_cases(torch, dev)
    t0 = phase_done("search kernel cases", t0)

    # The LM serving path, first while the card holds nothing else (the MoE
    # phases' weights take 52-57 GiB): each phase reads only the attention
    # kernel's counters, summed over the phases.
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions run in full fp32
    torch.backends.cudnn.allow_tf32 = False
    flash_errs = check_flash_cases(torch, dev)
    t0 = phase_done("attention cases", t0)
    lm = {}
    launches = {}
    for phase in LM_PHASES:
        lm[phase.name], phase_launches = lm_phase(torch, dev, phase)
        for name, n in phase_launches.items():
            launches[name] = launches.get(name, 0) + n
        torch.cuda.empty_cache()
        t0 = phase_done(f"LM {phase.name}", t0)
    mesh_lm = {}
    for phase in MESH_PHASES:
        mesh_lm[phase.name], phase_launches = mesh_phase(torch, dev, phase)
        for name, n in phase_launches.items():
            launches[name] = launches.get(name, 0) + n
        torch.cuda.empty_cache()
        t0 = phase_done(f"mesh {phase.name}", t0)
    print(f"attention launches over the LM phases: {launches}", flush=True)
    # PNA's host graphs (~80 s of numpy in a process of its own) are built
    # beside the train phases, after the host-bound decode phases.
    pna_graphs = start_pna_graphs()

    # Training: the backward kernels' checks, then each train phase on an
    # empty card (gemma3-4b's state takes 62 GB), then the checkpoint
    # restart; each phase reads the counters around its own steps.
    bwd_errs = check_flash_bwd_cases(torch, dev)
    train = {}
    for phase in TRAIN_PHASES:
        t0 = time.perf_counter()
        train[phase.arch], phase_launches = train_phase(torch, dev, phase)
        train[phase.arch]["wall_s"] = time.perf_counter() - t0
        phase_line(f"train {phase.arch}", train[phase.arch]["wall_s"])
        for n, c in phase_launches.items():
            launches[n] = launches.get(n, 0) + c
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train["checkpoint"] = checkpoint_phase(torch, dev)
    phase_line("checkpoint", time.perf_counter() - t0)
    torch.cuda.empty_cache()
    print(f"backward launches over the train phases: "
          f"{ {n: launches[n] for n in BWD_KERNELS} }", flush=True)

    # PNA on the emptied card: ogb_products at its full graph, then layer 1's
    # aggregation kernel against plain and the other cells' steps.
    t0 = time.perf_counter()
    pna_report, pna_launches, pna_rows = pna_phase(torch, dev, pna_graphs)
    pna_report["wall_s"] = time.perf_counter() - t0
    launches.update(pna_launches)
    phase_line("pna", pna_report["wall_s"])
    torch.cuda.empty_cache()

    # The recsys serving path: the filtered retrieval's host fit, then each
    # arch's phase (which reads only the attention counters and scores the
    # filters' survivors).
    t0 = time.perf_counter()
    filt = filtered_retrieval_setup(torch)
    recsys, bert4rec_rows = {}, None
    for name in RECSYS_ARCHS:
        recsys[name], phase_launches, rows = recsys_phase(torch, dev, name, filt)
        for n, c in phase_launches.items():
            launches[n] = launches.get(n, 0) + c
        bert4rec_rows = rows or bert4rec_rows
        torch.cuda.empty_cache()
    for row in filt["filters"]:
        print(f"filter {row['label']} {tuple(row['attrs'])}: scoring the {row['n_filtered']} "
              f"survivors (ms) " + ", ".join(f"{k} {v:.3f}" for k, v in row["score_ms"].items())
              + "; each top 10 the unfiltered top 10 on the exact set", flush=True)
    recsys["filtered_retrieval"] = {k: v for k, v in filt.items() if k != "retriever"}
    recsys["filtered_retrieval"]["filters"] = [
        {k: v for k, v in r.items() if k not in ("ids", "brute")} for r in filt["filters"]]
    recsys["wall_s"] = time.perf_counter() - t0
    del filt
    phase_line("recsys", recsys["wall_s"], f"; attention launches now {launches}")

    # The search path: only the search kernels' counters are read.
    args = search.build_parser().parse_args([
        "--corpus", "wiki", "--docs", str(N_DOCS), "--k", str(K_CLUSTERS), "--tc", "3000",
        "--queries", str(N_QUERIES), "--device", "cuda",
    ])
    from repro_torch.kernels.intersect import kernel as search_kernels

    t0 = time.perf_counter()
    B.reset_launch_counts()
    svc, logs, report, corpus = search.setup(args)
    recorder = Spans(torch)  # the fold's arguments per batch, for its timing below
    fold_batches = recorder.record_calls(search_kernels, "segment_fold_cuda",
                                         lambda *fold_args, **_: fold_args)
    try:
        search.serve(svc, logs, report)
        torch.cuda.synchronize()
    finally:
        recorder.restore()
    launches.update({name: B.LAUNCHES[name] for name in SEARCH_KERNELS})
    print(f"launches on the search path: { {n: launches[n] for n in SEARCH_KERNELS} }",
          flush=True)
    missing = [name for name in SEARCH_KERNELS if launches[name] <= 0]
    if missing:
        raise AssertionError(f"kernels the search path never launched: {missing}")
    n_batches = sum(report[f"engine_{name}"]["n_batches"] for name in logs)
    if not launches["segment_fold"] == len(fold_batches) == n_batches:
        raise AssertionError(f"{launches['segment_fold']} fold launches for {n_batches} batches")
    print("search path: n_docs={n_docs} n_postings={n_postings} index_nbytes={index_nbytes} "
          "fit_s={fit_s:.1f}".format(**report))
    phase_done("search path", t0)
    for name in logs:
        e = report[f"engine_{name}"]
        print(f"  {name}: median t_plan_s={e['t_plan_s_median']:.6f} "
              f"t_lower_s={e['t_lower_s_median']:.6f} t_fold_s={e['t_fold_s_median']:.6f}")

    # The sanitizer on the warm fold, before the tier shards the service.
    t0 = time.perf_counter()
    sanitize = sanitizer_phase(torch, svc, next(iter(logs.values())).queries[:256])
    sanitize["wall_s"] = time.perf_counter() - t0
    phase_line("sanitizer", sanitize["wall_s"])

    # The serving tier over the same fit: sharded engine, replays, chaos.
    t0 = time.perf_counter()
    tier = serving_tier(torch, svc, logs, corpus, N_QUERIES)
    tier["wall_s"] = time.perf_counter() - t0
    phase_line("serving tier", tier["wall_s"])

    # The clustering path: only the cluster_scores counter is read.
    t0 = time.perf_counter()
    kmeans, kmeans_launches = device_kmeans(torch, dev, svc.res)
    for name in ("cluster_scores_kernel", "cluster_scores_staged"):
        launches[name] = kmeans_launches[name]
    print("clustering path: device TopDown k_actual={k_actual} (host fit {host_k}) in "
          "{wall_s:.1f}s vs host fit {host_fit_cluster_time_s:.1f}s (ratio "
          "{wall_ratio_to_host:.3f}); psi {psi:.6g} / host {psi_host_fit:.6g} = "
          "{psi_ratio_to_host:.4f}, random {psi_random:.6g}; {device_calls} device K-means "
          "calls, {device_rounds} device rounds ({accepted_rounds} accepted), "
          "cluster_scores_kernel launches {cluster_scores_launches}".format(
              host_k=svc.res.k, **kmeans), flush=True)
    print("  host-clock spans (s): " + " ".join(
        f"{name}={sec:.3f}" for name, sec in sorted(kmeans["spans_s"].items())), flush=True)

    t0 = phase_done("clustering", t0)
    ell, p, tables8, kmeans["round_check"] = round_check(torch, dev, svc.res.view)

    fold = fold_rows(torch, svc, logs, launches, fold_batches)
    del fold_batches
    scores = cluster_scores_rows(torch, svc.res.view, ell, p, tables8, launches,
                                 max(score_case_err, kmeans["round_check"]["max_abs_err"]))
    del ell, p, tables8
    buckets, score_excess = topdown_score_buckets(torch, dev, kmeans["score_shapes"], launches)
    staged = kernel_entry("cluster_scores_staged", launches, scores["shapes"][:1], variant="staged")
    staged["device_ms"], staged["old_ms"] = scores["device_ms"], scores["old_ms"]
    kernels = [fold, *intersect_rows(torch, svc, logs, launches), scores, staged,
               *flash_rows(torch, dev, launches, flash_errs)]
    t0 = phase_done("search and attention kernel rows", t0)
    kernels += flash_bwd_rows(torch, dev, launches, bwd_errs)
    phase_done("backward kernel rows", t0)
    for row in bert4rec_rows:  # the resident variant, then the general kernel
        entry = kernel_entry(f"flash_attention_{row['variant']}", launches, [row],
                             variant=row["variant"])
        entry["device_ms"] = row["device_ms"]
        kernels.append(entry)
    for name, row in pna_rows.items():  # PNA's aggregation, split by edges
        entry = kernel_entry(name, launches, [row], variant="edge runs")
        entry["device_ms"] = row["device_ms"]
        kernels.append(entry)
    by_name = {k["name"]: k for k in kernels}
    checked = recsys["bert4rec"]["attention"]  # every call of the phase's checks
    resident = by_name["flash_attention_resident"]
    resident["max_abs_err"] = max(resident["max_abs_err"], checked["p99_max_abs_err"],
                                  checked["bulk_slice_max_abs_err"])
    for k in kernels:  # the search kernels' launches on the sharded path too
        if k["name"] in tier["sharded_launches"]:
            k["sharded_launches"] = tier["sharded_launches"][k["name"]]
    for k in kernels:
        print(f"{k['name']} [{k['variant']}]: launches={k['launches']} ms={k['ms']:.4f} "
              f"plain_ms={k['plain_ms']:.4f} bound_ms={k['bound_ms']:.5f} ({k['bound_by']})"
              + (f" library_ms={k['library_ms']:.4f}" if k["library_ms"] is not None else "")
              + (f" device_ms={k['device_ms']:.4f}" if "device_ms" in k else "")
              + (f" old_ms={k['old_ms']:.4f}" if "old_ms" in k else ""), flush=True)
    for row in fold["shapes"]:
        print(f"segment_fold {row['shape']}: upload_ms={row['upload_ms']:.4f} "
              f"kernel_ms={row['ms']:.4f} device_ms={row['device_ms']:.4f} "
              f"copyback_ms={row['copyback_ms']:.4f} bytes={row['bytes']} "
              f"bound_ms={row['bound_ms']:.5f}", flush=True)
    print(f"segment_fold over the search run's {len(fold['batches'])} batches: "
          f"sum of launches x (device ms - bound ms) = {fold['excess_ms']:.4f} ms "
          f"(device ms per batch {[round(b['device_ms'], 4) for b in fold['batches']]})",
          flush=True)
    for row in buckets:
        print(f"cluster_scores TopDown bucket N<={row['bucket'][0]} L<={row['bucket'][1]} "
              f"K={row['bucket'][2]}: {row['launches']} launches, at {tuple(row['shape'])} "
              f"(valid share {row['valid_share']:.3f}) staged {row['staged_ms']:.4f} ms "
              f"(device {row['staged_device_ms']:.4f}), general {row['general_ms']:.4f} ms "
              f"(device {row['general_device_ms']:.4f}), bound {row['bound_ms']:.5f} ms",
              flush=True)
    print("cluster_scores over the device TopDown: sum of launches x (ms - bound ms) = "
          f"{score_excess['staged']:.3f} ms staged, device {score_excess['staged_device']:.3f} "
          f"ms (general, the first design: {score_excess['general']:.3f} ms, device "
          f"{score_excess['general_device']:.3f} ms)", flush=True)
    kmeans["score_buckets"], kmeans["score_excess_ms"] = buckets, score_excess
    for row in by_name["flash_attention_kernel"]["shapes"]:
        print(f"flash_attention_kernel {row['shape']} [{row['variant']}]: ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
              f"({row['library_call']}) library_mask_ms={row['library_mask_ms']:.4f} "
              f"device_ms (CUDA graph: kernel, library, mask) " + "/".join(
                  f"{row['device_ms'][key]:.4f}" for key in ("ms", "library_ms", "library_mask_ms"))
              + " "
              f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}) "
              f"visible_pairs={row['visible_pairs']} max_abs_err={row['max_abs_err']:.3g} "
              f"({row['share_of_limit']:.3g} of the limit)",
              flush=True)
    for row in bert4rec_rows:
        print(f"flash_attention_{row['variant']} {row['shape']}: launches={row['launches']} "
              f"ms={row['ms']:.4f} (turns {'/'.join(f'{t:.4f}' for t in row['ms_turns'])}) "
              f"device_ms={row['device_ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} (device {row['library_device_ms']:.4f}; "
              f"{row['library_call']}) bound_ms={row['bound_ms']:.5f} ({row['bound_by']}; "
              f"bytes {row['bytes_bound_ms']:.5f}, operations {row['ops_bound_ms']:.5f}) "
              f"max_abs_err={row['max_abs_err']:.3g} ({row['share_of_limit']:.3g} of the limit)",
              flush=True)
    for entry in (by_name["flash_attention_decode"], by_name["flash_attention_combine"]):
        for row in entry["shapes"]:
            print(f"{entry['name']} {row['shape']}: ms={row['ms']:.4f} "
                  f"device_ms={row['device_ms']:.4f} "
                  f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.5f} "
                  f"({row['bound_by']}) bytes={row['bytes']} max_abs_err={row['max_abs_err']:.3g}",
                  flush=True)
    for row in scores["shapes"]:
        print(f"cluster_scores_kernel {row['shape']} [{row['variant']}]: ms={row['ms']:.4f} "
              f"device_ms={row['device_ms']:.4f} old_ms (general)={row['old_ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
              f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}) bytes={row['bytes']} "
              f"valid_slots={row['valid_slots']}", flush=True)

    out = ROOT / "chiprun_out" / "chip_smoke.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "card": card_line(), "report": report, "tier": tier, "kmeans": kmeans, "lm": lm,
        "mesh_lm": mesh_lm, "recsys": recsys, "train": train, "pna": pna_report,
        "sanitize": sanitize,
        "flash_cases": flash_errs, "flash_bwd_cases": bwd_errs, "ptxas": B.PTXAS, "kernels": kernels,
        "phase_s": PHASE_S, "wall_s": time.perf_counter() - t_start,
    }, indent=1, default=float))
    print(json.dumps({"kernels": [
        {k: v for k, v in entry.items() if k != "shapes"} for entry in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
