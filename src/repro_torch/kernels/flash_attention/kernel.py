"""Launcher of the attention kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_sm90.cu``) and of the backward's
(``csrc/flash_attention_bwd.cu``, ``csrc/flash_attention_bwd_sm90.cu``,
``csrc/flash_attention_bwd_resident.cu``, :func:`flash_attention_bwd_cuda`).

The libraries are built, loaded and counted by
:mod:`repro_torch.kernels.build`.  :func:`flash_attention_cuda` checks
device, dtype, shapes and strides, allocates the output with
``torch.empty_like(q)`` (so it keeps q's layout: a (B, H, L, D) view of a
(B, L, H, D) buffer gets a (B, L, H, D) buffer back) and picks one variant
by dtype and shape (:func:`flash_route`), with no fallback:

- ``"decode"``: Lq·(H/Hkv) <= :data:`DECODE_MAX_ROWS` and D·itemsize a
  multiple of 16 bytes, fp32 or bf16.  One launch of the split-K kernel
  (one block per batch, KV head and key split, fp32 arithmetic) in its
  fused mode: the last block of each (batch, KV head) to finish merges
  the splits into the output, as the combine kernel does
  (:func:`combine_cuda`, which the mesh decode still launches after
  :func:`decode_partials_cuda`), bit for bit.  It counts arrivals on the
  device's counter buffer (:func:`decode_counters`).
- ``"sm90"``: bf16 with D in :data:`SM90_HEAD_DIMS` otherwise.  The
  tensor-core prefill kernel (wgmma, TMA); P is rounded to bf16 for P·V.
- ``"resident"``: fp32, not causal, no window, D a multiple of 4 up to
  :data:`RESIDENT_MAX_HEAD_DIM`, and K and V of one (batch, KV head) within
  :data:`RESIDENT_SMEM_BYTES` of shared memory (:func:`resident_smem_bytes`;
  BERT4Rec's encoder call).  One block per (batch, KV head, query chunk)
  holds K and V whole (:func:`resident_q_chunk` sizes the chunk).
- ``"general"``: everything else (fp32 at longer Lq, other head dims):
  the fp32-arithmetic kernel of the first port.

The decode, sm90 and resident variants read with 16-byte loads, cp.async
or TMA, so they raise ``ValueError`` when a base pointer or a stride (of a
dimension longer than 1) is not a multiple of 16 bytes.  Every launch runs on
``torch.cuda.current_stream()`` and raises when it reports a CUDA error.
Each call adds one to ``LAUNCHES["flash_attention_kernel"]`` and one to
the counter of each kernel it launched.  Any B·H goes: the kernels take
(batch, head) pairs on ``gridDim.y``, whose limit is 65,535, so their C
launchers cut B·H (B·Hkv for decode) into launches of at most that many
pairs on the same stream, with no host sync; a call still counts once.

The backward (:func:`flash_attention_bwd_cuda`) takes the kernels
:func:`bwd_route` names, in the order :func:`bwd_launches` lists.
``"resident"`` (fp32, not causal, no window, D a multiple of 4 up to
:data:`RESIDENT_MAX_HEAD_DIM`, K, V, Q and dO of one (batch, KV head)
within :data:`RESIDENT_SMEM_BYTES`: :func:`resident_bwd_smem_bytes`;
BERT4Rec's encoder call): one kernel, :func:`bwd_resident_cuda`, which
computes delta itself and reads the forward's log-sum-exp
(:func:`flash_attention_lse_cuda` returns it on the resident and sm90
routes; without it, prep's recompute first).  ``"sm90"`` for bf16 with D
in :data:`SM90_HEAD_DIMS` (wgmma and TMA; P and dS rounded to bf16 for
their products): given the forward's log-sum-exp, dQ computing delta =
rowsum(dO ∘ O) itself (:func:`bwd_dq_delta_sm90_cuda`), then dK/dV
reading it (:func:`bwd_dkdv_sm90_cuda`); without it, prep (each row's
log-sum-exp and delta), dK/dV, then dQ reading delta
(:func:`bwd_dq_sm90_cuda`).  ``"general"`` otherwise: prep (delta alone
given the forward's log-sum-exp), then the fp32-arithmetic
:func:`bwd_dkdv_cuda` and :func:`bwd_dq_cuda`.  The sm90 and resident
kernels need 16-byte aligned bases and strides, or raise ``ValueError``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.build import LAUNCHES, check, lib, stream_of

__all__ = ["DECODE_MAX_ROWS", "MAX_HEAD_DIM", "RESIDENT_MAX_HEAD_DIM", "RESIDENT_SMEM_BYTES",
           "SM90_HEAD_DIMS", "combine_cuda", "decode_counter_numel", "decode_counters",
           "decode_partials_cuda", "decode_plan", "bwd_dkdv_cuda", "bwd_dkdv_sm90_cuda",
           "bwd_dq_cuda", "bwd_dq_delta_sm90_cuda", "bwd_dq_sm90_cuda", "bwd_launches",
           "bwd_prep_cuda", "bwd_resident_cuda", "bwd_route", "flash_attention_bwd_cuda",
           "flash_attention_cuda", "flash_attention_lse_cuda", "flash_route", "resident_q_chunk",
           "resident_bwd_smem_bytes", "resident_smem_bytes", "sm_count"]

MAX_HEAD_DIM = 256
# Query rows (Lq·(H/Hkv)) of one (batch, KV head) that the decode variant
# holds in one block.
DECODE_MAX_ROWS = 8
SM90_HEAD_DIMS = (64, 128, 256)
# Blocks the decode variant aims at per SM; keys per split are a multiple
# of DECODE_CHUNK_STEP and at least that.
DECODE_BLOCKS_PER_SM = 4
DECODE_CHUNK_STEP = 32
# The resident variant (csrc/flash_attention.cu, ``FR_*``): query rows a
# warp's tile, the widest D (a warp keeps its Q tile in registers), and an
# H100 block's opt-in shared memory (227 KB).
RESIDENT_TILE_ROWS = 16
RESIDENT_MAX_HEAD_DIM = 64
RESIDENT_SMEM_BYTES = 232448
# The resident variant cuts Lq into chunks only where B·Hkv blocks would
# not give RESIDENT_BLOCKS_PER_SM blocks an SM, and never below
# RESIDENT_MIN_CHUNK query positions a block.
RESIDENT_BLOCKS_PER_SM = 2
RESIDENT_MIN_CHUNK = 64
# flash_decode_launch's modes: the partials alone (the mesh decode), or
# merged into the output by each (batch, KV head)'s last block.
_PARTIALS_ONLY, _FUSED = 0, 1
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
_INT32_MAX = 2**31 - 1


def resident_smem_bytes(lk: int, d: int) -> int:
    """Shared memory of one block of the resident variant: K and V of the
    head as fp32 rows of D rounded up to 32, Lk rounded up to 8 rows."""
    return 4 * 2 * (-(-lk // 8) * 8) * (-(-d // 32) * 32)


def resident_bwd_smem_bytes(lq: int, lk: int, d: int, groups: int) -> int:
    """Shared memory of one block of the resident backward
    (``csrc/flash_attention_bwd_resident.cu``): K and V of the head (Lk
    rounded up to 16 rows), Q and dO of each of the group's ``groups`` query
    heads (Lq rounded up to 16), as fp32 rows of D rounded up to 32, and
    each query row's lse and delta."""
    dp = -(-d // 32) * 32
    lk16, lq16 = -(-lk // 16) * 16, -(-lq // 16) * 16
    return 4 * (2 * lk16 * dp + 2 * groups * lq16 * dp + 2 * groups * lq16)


def flash_route(dtype: torch.dtype, h: int, hkv: int, lq: int, lk: int, d: int, causal: bool,
                window: Optional[int]) -> str:
    """The variant that :func:`flash_attention_cuda` launches for these
    inputs: ``"decode"``, ``"sm90"``, ``"resident"`` or ``"general"``."""
    if lq * (h // hkv) <= DECODE_MAX_ROWS and (d * _ITEMSIZE[dtype]) % 16 == 0:
        return "decode"
    if dtype == torch.bfloat16 and d in SM90_HEAD_DIMS:
        return "sm90"
    if (dtype == torch.float32 and not causal and window is None and d % 4 == 0
            and d <= RESIDENT_MAX_HEAD_DIM and resident_smem_bytes(lk, d) <= RESIDENT_SMEM_BYTES):
        return "resident"
    return "general"


def bwd_route(dtype: torch.dtype, h: int, hkv: int, lq: int, lk: int, d: int, causal: bool,
              window: Optional[int]) -> str:
    """The kernels that :func:`flash_attention_bwd_cuda` launches for the
    forward's inputs: ``"sm90"`` (prep, then the bf16 tensor-core dK/dV and
    dQ) for bf16 with D in :data:`SM90_HEAD_DIMS`; ``"resident"`` (one
    kernel) for fp32, not causal, no window, D a multiple of 4 up to
    :data:`RESIDENT_MAX_HEAD_DIM` and :func:`resident_bwd_smem_bytes` within
    :data:`RESIDENT_SMEM_BYTES`; else ``"general"`` (prep, dK/dV, dQ)."""
    if dtype == torch.bfloat16 and d in SM90_HEAD_DIMS:
        return "sm90"
    if (dtype == torch.float32 and not causal and window is None and d % 4 == 0
            and d <= RESIDENT_MAX_HEAD_DIM
            and resident_bwd_smem_bytes(lq, lk, d, h // hkv) <= RESIDENT_SMEM_BYTES):
        return "resident"
    return "general"


def bwd_launches(route: str, lse_given: bool) -> Tuple[str, ...]:
    """The kernels, in launch order, that :func:`flash_attention_bwd_cuda`
    launches once each on ``route`` (:func:`bwd_route`), given the
    forward's log-sum-exp or not: without it ``flash_bwd_prep`` recomputes
    it first (and writes delta beside it on the sm90 and general routes);
    with it the sm90 route's dQ computes delta for dK/dV, the resident
    kernel computes its own and the general route's prep computes delta
    alone."""
    if route == "resident":
        return ("flash_bwd_resident",) if lse_given else ("flash_bwd_prep", "flash_bwd_resident")
    if route == "sm90":
        return (("flash_bwd_dq_sm90", "flash_bwd_dkdv_sm90") if lse_given
                else ("flash_bwd_prep", "flash_bwd_dkdv_sm90", "flash_bwd_dq_sm90"))
    return ("flash_bwd_prep", "flash_bwd_dkdv", "flash_bwd_dq")


def _bwd_route_of(q, k, causal, window) -> str:
    """:func:`bwd_route` of these inputs; ``"general"`` (whose checks then
    raise) where they are not (B, H, L, D) with Hkv dividing H."""
    if q.dim() != 4 or k.dim() != 4 or k.shape[1] < 1 or q.shape[1] % k.shape[1]:
        return "general"
    b, h, lq, d = q.shape
    return bwd_route(q.dtype, h, k.shape[1], lq, k.shape[2], d, causal, window)


def resident_q_chunk(lq: int, bhkv: int, sms: int) -> int:
    """Query positions one block of the resident variant takes: all of Lq
    when the ``bhkv`` (batch, KV head) blocks give
    ``RESIDENT_BLOCKS_PER_SM`` blocks on each of ``sms`` SMs, else Lq cut
    into as many chunks as that needs, each a whole number of warp tiles
    and at least ``RESIDENT_MIN_CHUNK`` positions."""
    want = max(1, -(-RESIDENT_BLOCKS_PER_SM * sms // max(bhkv, 1)))
    rows = max(RESIDENT_MIN_CHUNK, -(-lq // want))
    return -(-rows // RESIDENT_TILE_ROWS) * RESIDENT_TILE_ROWS


def decode_plan(lq: int, lk: int, window: Optional[int], bhkv: int,
                sms: int) -> Tuple[int, int, int, int]:
    """(j_begin, j_end, chunk, n_splits) of the decode variant: the keys
    [j_begin, j_end) that some query row sees (the rows sit at positions
    Lk - Lq .. Lk - 1, so causality keeps every key before Lk), cut into
    ``n_splits`` splits of ``chunk`` keys, enough for
    ``DECODE_BLOCKS_PER_SM`` blocks on each of ``sms`` SMs over the
    ``bhkv`` (batch, KV head) pairs.  No split lies outside the window."""
    j_begin = max(0, lk - lq - window + 1) if window is not None else 0
    span = lk - j_begin
    want = max(1, -(-DECODE_BLOCKS_PER_SM * sms // max(bhkv, 1)))
    chunk = max(DECODE_CHUNK_STEP, -(-span // want))
    chunk = -(-chunk // DECODE_CHUNK_STEP) * DECODE_CHUNK_STEP
    return j_begin, lk, chunk, -(-span // chunk)


def decode_counter_numel(need: int, have: int) -> int:
    """Counters the decode buffer holds after a geometry of ``need``
    (batch, KV head) pairs when it held ``have``: ``have`` while that
    suffices, else the larger of ``need`` and twice ``have`` (a run of
    growing geometries reallocates it a few times, not at each)."""
    return have if need <= have else max(need, 2 * have)


# The fused decode's arrival counters: one int32 buffer a device, all 0
# between launches (each (batch, KV head)'s last block sets its counter
# back to 0), indexed by the (batch, KV head).  One stream at a time uses
# it, as the port runs: two decode launches in flight at once on two
# streams would share counters.  A geometry's first call (``_Launch``)
# grows it, before any capture of that call into a CUDA graph.
_DECODE_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def decode_counters(device: torch.device) -> Optional[torch.Tensor]:
    """The fused decode's counter buffer on ``device`` (None before its
    first decode call); all zeros whenever no decode launch is in flight."""
    return _DECODE_COUNTERS.get(torch.device(device))


def _grow_decode_counters(device: torch.device, need: int) -> None:
    have = _DECODE_COUNTERS.get(device)
    numel = decode_counter_numel(need, 0 if have is None else have.numel())
    if have is None or numel != have.numel():
        _DECODE_COUNTERS[device] = torch.zeros(numel, dtype=torch.int32, device=device)


def _check_inputs(q, k, v, causal, window, name) -> None:
    device = q.device
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: expected float32 or bfloat16, got {q.dtype}")
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name}: every input must be on one CUDA device")
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: q, k and v must share one dtype")
        if t.dim() != 4:
            raise ValueError(f"{name}: q (B, H, Lq, D) and k, v (B, Hkv, Lk, D) expected")
        if t.stride(3) != 1 and t.shape[3] > 1:
            raise ValueError(f"{name}: the last dimension must be dense (stride 1)")
    b, h, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: k and v must be (B, Hkv, Lk, D) with q's B and D")
    if hkv < 1 or h % hkv:
        raise ValueError(f"{name}: Hkv={hkv} must divide H={h}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if max(lq, lk) > _INT32_MAX:
        raise ValueError(f"{name}: lengths below 2**31 required")
    if window is not None and not 1 <= window <= _INT32_MAX:
        raise ValueError(f"{name}: window {window} outside [1, 2**31)")
    if lk < 1 or (causal and lk < lq):
        raise ValueError(f"{name}: every query row must see a key (Lk={lk}, Lq={lq})")


def _misaligned(route: str, shape, stride, itemsize: int, ptr: int) -> Optional[str]:
    """16-byte loads and TMA need every base and every stride of a
    dimension longer than 1 to be a multiple of 16 bytes."""
    if ptr % 16 or any(stride[i] * itemsize % 16 for i in range(3) if shape[i] > 1):
        return (f"the {route} variant needs 16-byte aligned bases and strides; got base "
                f"{ptr % 16} bytes past 16 and strides {tuple(stride)} of {itemsize}-byte "
                f"elements")
    return None


def _int64s(values) -> ctypes.Array:
    values = list(values)
    return (ctypes.c_int64 * len(values))(*values)


class _Launch:
    """What one input geometry (shapes, strides, dtype, device, masks)
    needs at every call, checked and computed once: the variant, the
    strides handed to the kernels (q, k, v and the output), the mask
    arguments, the decode plan and room on the decode counter buffer."""

    def __init__(self, q, k, v, causal, window, name):
        _check_inputs(q, k, v, causal, window, name)
        b, h, lq, d = q.shape
        hkv, lk = k.shape[1], k.shape[2]
        self.dims = (b, h, hkv, lq, lk, d)
        self.empty = lq == 0 or b * h == 0
        self.route = flash_route(q.dtype, h, hkv, lq, lk, d, causal, window)
        out_stride = torch.empty_like(q, device="meta").stride()
        self.mask = (int(causal), int(window is not None), int(window or 0))
        self.scale = 1.0 / d**0.5
        self.dtype_code = _DTYPE_CODES[q.dtype]
        self.itemsize = _ITEMSIZE[q.dtype]
        self.strides = _int64s(st[i] for st in (q.stride(), k.stride(), v.stride(), out_stride)
                               for i in range(3))
        if self.route == "decode":
            self.plan = decode_plan(lq, lk, window, b * hkv,
                                    sm_count(q.device.index) if not self.empty else 1)
            rows = lq * (h // hkv)
            # (max, sum) pairs, padded so that acc after them is 16-byte
            # aligned (the fused merge reads it with 16-byte loads).
            self.ml_numel = -(-b * hkv * self.plan[3] * rows * 2 // 4) * 4
            self.scratch_numel = self.ml_numel + b * hkv * self.plan[3] * rows * d
            self.decode_args = _decode_args(self.dims, self.strides, self.mask, self.plan,
                                            self.dtype_code)
            self.combine_args = _int64s((b, h, hkv, lq, d, self.plan[3], *out_stride[:3],
                                         self.dtype_code))
            if not self.empty:
                _grow_decode_counters(q.device, b * hkv)
        if self.route == "resident":
            self.q_chunk = resident_q_chunk(lq, b * hkv,
                                            sm_count(q.device.index) if not self.empty else 1)
            self.resident_args = _int64s((b, h, hkv, lq, lk, d, self.q_chunk, *self.strides))
        if self.route != "general":
            for shape, stride in ((q.shape, q.stride()), (k.shape, k.stride()),
                                  (v.shape, v.stride()), (q.shape, out_stride)):
                why = _misaligned(self.route, shape, stride, self.itemsize, 0)
                if why:
                    raise ValueError(f"{name}: {why}")

    def check_bases(self, name, *tensors) -> None:
        for t in tensors:
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: " + _misaligned(self.route, t.shape, t.stride(),
                                                           self.itemsize, t.data_ptr()))


_LAUNCHES_BY_GEOMETRY: Dict[tuple, _Launch] = {}
_MAX_GEOMETRIES = 4096


def _launch_of(q, k, v, causal, window, name) -> _Launch:
    key = (q.shape, q.stride(), k.shape, k.stride(), v.shape, v.stride(), q.dtype, k.dtype,
           v.dtype, q.device, k.device, v.device, bool(causal), window)
    found = _LAUNCHES_BY_GEOMETRY.get(key)
    if found is None:
        if len(_LAUNCHES_BY_GEOMETRY) >= _MAX_GEOMETRIES:  # a growing cache makes new ones
            _LAUNCHES_BY_GEOMETRY.clear()
        found = _LAUNCHES_BY_GEOMETRY[key] = _Launch(q, k, v, causal, window, name)
    return found


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_partials_cuda(q, k, v, causal: bool, window: Optional[int],
                         plan: Tuple[int, int, int, int]):
    """The decode variant's first kernel: for each (batch, KV head,
    split) the fp32 (max, sum) ``ml`` (B·Hkv, n_splits, rows, 2) and
    unnormalised accumulator ``acc`` (B·Hkv, n_splits, rows, D) of the
    rows r = g·Lq + i over the split's keys of ``plan``
    (:func:`decode_plan`)."""
    name = "flash_attention_decode"
    launch = _launch_of(q, k, v, causal, window, name)
    if launch.route != "decode":
        raise ValueError(f"{name}: these inputs take the {launch.route} variant")
    launch.check_bases(name, q, k, v)
    b, h, hkv, lq, lk, d = launch.dims
    rows = lq * (h // hkv)
    ml = torch.empty((b * hkv, plan[3], rows, 2), dtype=torch.float32, device=q.device)
    acc = torch.empty((b * hkv, plan[3], rows, d), dtype=torch.float32, device=q.device)
    _decode(ml.data_ptr(), acc.data_ptr(), None, None, q, k, v,
            _decode_args(launch.dims, launch.strides, launch.mask, plan, launch.dtype_code),
            launch.scale, _PARTIALS_ONLY, stream_of(q.device))
    return ml, acc


def combine_cuda(ml: torch.Tensor, acc: torch.Tensor, out: torch.Tensor, hkv: int) -> None:
    """The decode variant's second kernel: merges the splits of
    :func:`decode_partials_cuda` in split order into ``out`` (B, H, Lq, D)
    in place."""
    b, h, lq, d = out.shape
    _combine(ml.data_ptr(), acc.data_ptr(), out,
             _int64s((b, h, hkv, lq, d, ml.shape[1], *out.stride()[:3], _DTYPE_CODES[out.dtype])),
             stream_of(out.device))


def _decode_args(dims, strides, mask, plan, dtype_code) -> ctypes.Array:
    """The decode launcher's scalar arguments, packed (see
    ``flash_decode_launch``): dims, the 12 strides of q, k, v and the
    output, mask, plan and dtype; a call then converts 11 arguments, not
    36."""
    return _int64s((*dims, *strides, *mask, *plan, dtype_code))


def _decode(ml_ptr: int, acc_ptr: int, out_ptr: Optional[int], count_ptr: Optional[int], q, k,
            v, args, scale: float, mode: int, stream: int) -> None:
    name = "flash_attention_decode"
    status = lib("flash_attention").flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ml_ptr, acc_ptr, out_ptr, count_ptr, args,
        scale, mode, stream)
    check(status, name)
    LAUNCHES[name] += 1


def _combine(ml_ptr: int, acc_ptr: int, out, args, stream: int) -> None:
    name = "flash_attention_combine"
    status = lib("flash_attention").flash_combine_launch(ml_ptr, acc_ptr, out.data_ptr(), args,
                                                         stream)
    check(status, name)
    LAUNCHES[name] += 1


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """(B, H, Lq, D) attention in q's dtype; the contract of
    :func:`repro_torch.kernels.flash_attention.ref.attention_ref` for
    inputs in which every query row sees at least one key (Lk >= Lq when
    causal, window >= 1), through the variant :func:`flash_route` names.
    What depends only on the inputs' geometry is checked and computed at
    its first call and kept (``_Launch``)."""
    return _flash(q, k, v, causal, window, False)[0]


def flash_attention_lse_cuda(q, k, v, causal: bool = True, window: Optional[int] = None):
    """(out, lse): :func:`flash_attention_cuda`'s output and, where the
    route is ``"sm90"`` or ``"resident"``, each row's log-sum-exp of its
    visible scaled scores, float32 (B·H, Lq) contiguous, which those
    forwards write at their end for the backward (else ``None``: prep
    recomputes it)."""
    return _flash(q, k, v, causal, window, True)


def _flash(q, k, v, causal, window, want_lse):
    name = "flash_attention_kernel"
    launch = _launch_of(q, k, v, causal, window, name)
    out = torch.empty_like(q)
    lse = None
    if want_lse and launch.route in ("sm90", "resident"):
        lse = torch.empty((q.shape[0] * q.shape[1], q.shape[2]), dtype=torch.float32,
                          device=q.device)
    if launch.empty:
        return out, lse
    b, h, hkv, lq, lk, d = launch.dims
    stream = stream_of(q.device)
    route = launch.route
    if route == "decode":
        launch.check_bases("flash_attention_decode", q, k, v)
        ml_ptr, acc_ptr, scratch = _decode_scratch(launch, q.device)  # alive past the launch
        _decode(ml_ptr, acc_ptr, out.data_ptr(), _DECODE_COUNTERS[q.device].data_ptr(), q, k, v,
                launch.decode_args, launch.scale, _FUSED, stream)
    elif route == "sm90":
        launch.check_bases("flash_attention_sm90", q, k, v, out)
        status = lib("flash_attention_sm90").flash_attention_sm90_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv, lq, lk, d,
            launch.strides, *launch.mask, launch.scale, None if lse is None else lse.data_ptr(),
            stream)
        check(status, "flash_attention_sm90")
        LAUNCHES["flash_attention_sm90"] += 1
    elif route == "resident":
        launch.check_bases("flash_attention_resident", q, k, v, out)
        status = lib("flash_attention").flash_resident_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), launch.resident_args,
            launch.scale, None if lse is None else lse.data_ptr(), stream)
        check(status, "flash_attention_resident")
        LAUNCHES["flash_attention_resident"] += 1
    else:
        _general(q, k, v, out, launch, stream)
    LAUNCHES[name] += 1
    return out, lse


def _decode_scratch(launch: _Launch, device):
    """One fp32 scratch for the decode's partials, (max, sum) first, then
    acc: their two pointers and the tensor."""
    scratch = torch.empty(launch.scratch_numel, dtype=torch.float32, device=device)
    ml_ptr = scratch.data_ptr()
    return ml_ptr, ml_ptr + 4 * launch.ml_numel, scratch


def _decode_two_kernels_forced(q, k, v, causal: bool = True,
                               window: Optional[int] = None) -> torch.Tensor:
    """:func:`flash_attention_cuda` on the decode route through the split
    kernel's partials then the combine kernel, two launches (the design
    before the fused merge), to check and time it beside the one-launch
    call on the same inputs."""
    name = "flash_attention_decode"
    launch = _launch_of(q, k, v, causal, window, name)
    if launch.route != "decode":
        raise ValueError(f"{name}: these inputs take the {launch.route} variant")
    out = torch.empty_like(q)
    if not launch.empty:
        launch.check_bases(name, q, k, v)
        stream = stream_of(q.device)
        ml_ptr, acc_ptr, scratch = _decode_scratch(launch, q.device)
        _decode(ml_ptr, acc_ptr, None, None, q, k, v, launch.decode_args, launch.scale,
                _PARTIALS_ONLY, stream)
        _combine(ml_ptr, acc_ptr, out, launch.combine_args, stream)
    return out


def _general(q, k, v, out, launch: _Launch, stream: int) -> None:
    """The general kernel, which takes every input: the route of every
    call no other variant takes."""
    b, h, hkv, lq, lk, d = launch.dims
    status = lib("flash_attention").flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv, lq, lk, d,
        launch.strides, *launch.mask, launch.scale, launch.dtype_code, stream)
    check(status, "flash_attention_general")
    LAUNCHES["flash_attention_general"] += 1


def _general_forced(q, k, v, causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """:func:`flash_attention_cuda` through the general kernel whatever the
    route, to time and check it beside the variant the route names."""
    launch = _launch_of(q, k, v, causal, window, "flash_attention_general")
    out = torch.empty_like(q)
    if not launch.empty:
        _general(q, k, v, out, launch, stream_of(q.device))
    return out



class _BwdLaunch:
    """The backward's scalar arguments for one call: shapes, masks, dtype
    and the strides of q, k, v, out, dout and the three gradients."""

    def __init__(self, q, k, v, out, dout, dq, dk, dv, causal, window):
        b, h, lq, d = q.shape
        hkv, lk = k.shape[1], k.shape[2]
        self.empty = lq == 0 or b * h == 0
        self.args = _int64s((b, h, hkv, lq, lk, d, int(causal), int(window is not None),
                             int(window or 0), _DTYPE_CODES[q.dtype],
                             *(t.stride(i) for t in (q, k, v, out, dout, dq, dk, dv)
                               for i in range(3))))
        self.scale = 1.0 / d**0.5
        self.stream = stream_of(q.device)


def _bwd_checked(q, k, v, out, dout, causal, window, name):
    _check_inputs(q, k, v, causal, window, name)
    for t in (out, dout):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: out and dout must be like q {tuple(q.shape)}")
        if t.stride(3) != 1 and t.shape[3] > 1:
            raise ValueError(f"{name}: the last dimension must be dense (stride 1)")


def _stats_checked(q, stats, name) -> None:
    """lse and delta: float32 (B·H, Lq), contiguous, on q's device (the
    sm90 kernels index them so)."""
    want = (q.shape[0] * q.shape[1], q.shape[2])
    for t in stats:
        if (t.dtype != torch.float32 or tuple(t.shape) != want or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"{name}: lse and delta must be float32 {want}, contiguous, on "
                             f"q's device")


def _sm90_bwd_checked(q, k, v, dout, causal, window, name, out=None) -> None:
    """What the sm90 backward takes beyond the general one: bf16, D in
    :data:`SM90_HEAD_DIMS`, 16-byte aligned bases and strides (TMA, and
    the 16-byte loads of O and dO where dQ computes delta: ``out`` given),
    and lengths within its 32-bit indices and grid rows.  The shape checks
    come before the device's, so they hold on any machine.  (The
    gradients, ``torch.empty_like`` of aligned inputs with D·2 a multiple
    of 16 bytes, are aligned too.)"""
    if _bwd_route_of(q, k, causal, window) != "sm90":
        raise ValueError(f"{name}: bf16 with head dim in {SM90_HEAD_DIMS} required, got "
                         f"{q.dtype} and head dim {q.shape[-1]}")
    tensors = (q, k, v, dout) if out is None else (q, k, v, dout, out)
    for t in tensors:
        why = _misaligned("sm90 backward", t.shape, t.stride(), 2, 0)
        if why:
            raise ValueError(f"{name}: {why}")
    b, h, lq, _ = q.shape
    if b * h * lq >= 2**31 or -(-max(lq, k.shape[2]) // 64) > 65535:
        raise ValueError(f"{name}: B·H·Lq below 2**31 and lengths up to 64·65,535 required")
    _bwd_checked(q, k, v, dout if out is None else out, dout, causal, window, name)
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: " + _misaligned("sm90 backward", t.shape, t.stride(), 2,
                                                       t.data_ptr()))


def bwd_prep_cuda(q, k, out, dout, causal: bool = True, window: Optional[int] = None, v=None,
                  lse=None):
    """``flash_bwd_prep``: (lse, delta), float32 (B·H, Lq): each row's
    log-sum-exp over its visible scaled scores and rowsum(dO ∘ O).  Given
    the forward's ``lse`` (:func:`flash_attention_lse_cuda`), it computes
    delta alone and returns that ``lse``."""
    v = k if v is None else v
    _bwd_checked(q, k, v, out, dout, causal, window, "flash_bwd_prep")
    b, h, lq, _ = q.shape
    if lse is None:
        lse_out = torch.empty((b * h, lq), dtype=torch.float32, device=q.device)
    else:
        _stats_checked(q, (lse,), "flash_bwd_prep")
        lse_out = lse
    delta = torch.empty((b * h, lq), dtype=torch.float32, device=q.device)
    launch = _BwdLaunch(q, k, v, out, dout, q, k, v, causal, window)
    if not launch.empty:
        check(lib("flash_attention_bwd").flash_bwd_prep_launch(
            q.data_ptr(), k.data_ptr(), out.data_ptr(), dout.data_ptr(), lse_out.data_ptr(),
            delta.data_ptr(), launch.args, launch.scale, int(lse is None), launch.stream),
            "flash_bwd_prep")
        LAUNCHES["flash_bwd_prep"] += 1
    return lse_out, delta


def bwd_dkdv_cuda(q, k, v, dout, lse, delta, causal: bool = True, window: Optional[int] = None):
    """``flash_bwd_dkdv``: (dk, dv) like k and v, the group's query heads
    summed, from :func:`bwd_prep_cuda`'s lse and delta."""
    _bwd_checked(q, k, v, dout, dout, causal, window, "flash_bwd_dkdv")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    launch = _BwdLaunch(q, k, v, dout, dout, q, dk, dv, causal, window)
    if launch.empty:
        return dk.zero_(), dv.zero_()
    check(lib("flash_attention_bwd").flash_bwd_dkdv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), launch.args, launch.scale,
        launch.stream), "flash_bwd_dkdv")
    LAUNCHES["flash_bwd_dkdv"] += 1
    return dk, dv


def bwd_dq_cuda(q, k, v, dout, lse, delta, causal: bool = True, window: Optional[int] = None):
    """``flash_bwd_dq``: dq like q, from :func:`bwd_prep_cuda`'s lse and
    delta."""
    _bwd_checked(q, k, v, dout, dout, causal, window, "flash_bwd_dq")
    dq = torch.empty_like(q)
    launch = _BwdLaunch(q, k, v, dout, dout, dq, k, v, causal, window)
    if not launch.empty:
        check(lib("flash_attention_bwd").flash_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), launch.args, launch.scale, launch.stream),
            "flash_bwd_dq")
        LAUNCHES["flash_bwd_dq"] += 1
    return dq


def bwd_dkdv_sm90_cuda(q, k, v, dout, lse, delta, causal: bool = True,
                       window: Optional[int] = None):
    """``flash_bwd_dkdv_sm90``: :func:`bwd_dkdv_cuda` on the bf16 tensor
    cores (``csrc/flash_attention_bwd_sm90.cu``), for the inputs
    :func:`bwd_route` sends there; raises ``ValueError`` for any other."""
    name = "flash_bwd_dkdv_sm90"
    _sm90_bwd_checked(q, k, v, dout, causal, window, name)
    _stats_checked(q, (lse, delta), name)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    launch = _BwdLaunch(q, k, v, dout, dout, q, dk, dv, causal, window)
    if launch.empty:
        return dk.zero_(), dv.zero_()
    check(lib("flash_attention_bwd_sm90").flash_bwd_dkdv_sm90_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), launch.args, launch.scale,
        launch.stream), name)
    LAUNCHES[name] += 1
    return dk, dv


def bwd_dq_sm90_cuda(q, k, v, dout, lse, delta, causal: bool = True,
                     window: Optional[int] = None):
    """``flash_bwd_dq_sm90``: :func:`bwd_dq_cuda` on the bf16 tensor cores
    (``csrc/flash_attention_bwd_sm90.cu``), reading prep's delta, for the
    inputs :func:`bwd_route` sends there; raises ``ValueError`` for any
    other."""
    name = "flash_bwd_dq_sm90"
    _sm90_bwd_checked(q, k, v, dout, causal, window, name)
    _stats_checked(q, (lse, delta), name)
    return _dq_sm90(q, k, v, None, dout, lse, delta, causal, window)


def bwd_dq_delta_sm90_cuda(q, k, v, out, dout, lse, causal: bool = True,
                           window: Optional[int] = None):
    """``flash_bwd_dq_sm90`` computing delta itself: (dq, delta), dq like q
    and delta = rowsum(dO ∘ O) float32 (B·H, Lq), which the kernel's
    consumers sum from O and dO before their main loop and write for
    :func:`bwd_dkdv_sm90_cuda`, given the forward's log-sum-exp ``lse``.
    O needs the 16-byte aligned base and strides of q; raises
    ``ValueError`` for any input the sm90 backward does not take."""
    name = "flash_bwd_dq_sm90"
    _sm90_bwd_checked(q, k, v, dout, causal, window, name, out=out)
    _stats_checked(q, (lse,), name)
    delta = torch.empty((q.shape[0] * q.shape[1], q.shape[2]), dtype=torch.float32,
                        device=q.device)
    return _dq_sm90(q, k, v, out, dout, lse, delta, causal, window), delta


def _dq_sm90(q, k, v, out, dout, lse, delta, causal, window):
    """The dQ kernel's launch: reading ``delta``, or (``out`` given)
    writing it."""
    name = "flash_bwd_dq_sm90"
    dq = torch.empty_like(q)
    launch = _BwdLaunch(q, k, v, dout if out is None else out, dout, dq, k, v, causal, window)
    if launch.empty:
        return dq
    check(lib("flash_attention_bwd_sm90").flash_bwd_dq_sm90_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if out is None else out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), launch.args,
        launch.scale, launch.stream), name)
    LAUNCHES[name] += 1
    return dq


def _resident_bwd_checked(q, k, v, out, dout, causal, window, name, lse=None) -> None:
    """What the resident backward takes: the inputs :func:`bwd_route` sends
    there, 16-byte aligned bases and strides (cp.async and float4 loads)
    and, where given, lse float32 (B·H, Lq) contiguous; then the general
    checks (device, shapes).  The route, alignment and lse checks come before the
    device's, so they hold on any machine.  (The gradients,
    ``torch.empty_like`` of aligned inputs with D a multiple of 4, are
    aligned too.)"""
    if _bwd_route_of(q, k, causal, window) != "resident":
        raise ValueError(f"{name}: float32, not causal, no window, head dim a multiple of 4 up "
                         f"to {RESIDENT_MAX_HEAD_DIM} and K, V, Q and dO of a (batch, KV head) "
                         f"within {RESIDENT_SMEM_BYTES} bytes of shared memory required")
    for t in (q, k, v, out, dout):
        why = _misaligned("resident backward", t.shape, t.stride(), 4, t.data_ptr())
        if why:
            raise ValueError(f"{name}: {why}")
    if lse is not None:
        _stats_checked(q, (lse,), name)
    _bwd_checked(q, k, v, out, dout, causal, window, name)


def bwd_resident_cuda(q, k, v, out, dout, lse, causal: bool = False,
                      window: Optional[int] = None):
    """``flash_bwd_resident``: (dq, dk, dv) like q, k and v, the whole
    backward in one kernel (``csrc/flash_attention_bwd_resident.cu``: delta
    = rowsum(dO ∘ O), dK and dV with the group's heads summed, dQ), given
    the forward's log-sum-exp ``lse`` (float32 (B·H, Lq) contiguous), for
    the inputs :func:`bwd_route` sends there; raises ``ValueError`` for any
    other before launching."""
    name = "flash_bwd_resident"
    if lse is None:
        raise ValueError(f"{name}: the forward's log-sum-exp is required")
    _resident_bwd_checked(q, k, v, out, dout, causal, window, name, lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    b, h, lq, _ = q.shape
    if lq == 0 or b * h == 0:
        return dq, dk.zero_(), dv.zero_()
    check(lib("flash_attention_bwd_resident").flash_bwd_resident_launch(
        *_resident_bwd_args(q, k, v, out, dout, lse, dq, dk, dv)), name)
    LAUNCHES[name] += 1
    return dq, dk, dv


def _resident_bwd_args(q, k, v, out, dout, lse, dq, dk, dv) -> tuple:
    """``flash_bwd_resident_launch``'s arguments: the ten tensors' pointers,
    the packed shapes and strides, the scale and the stream."""
    b, h, lq, d = q.shape
    args = _int64s((b, h, k.shape[1], lq, k.shape[2], d,
                    *(t.stride(i) for t in (q, k, v, out, dout, dq, dk, dv) for i in range(3))))
    return (*(t.data_ptr() for t in (q, k, v, out, dout, lse, dq, dk, dv)), args, 1.0 / d**0.5,
            stream_of(q.device))


def flash_attention_bwd_cuda(q, k, v, out, dout, causal: bool = True,
                             window: Optional[int] = None, lse=None):
    """(dq, dk, dv), the gradient of :func:`flash_attention_cuda` (any
    variant: they compute one function) at output ``out`` for the output
    gradient ``dout``, through the kernels :func:`bwd_route` names, one
    launch each in the order :func:`bwd_launches` lists: on the resident
    route :func:`bwd_resident_cuda` alone, given the forward's ``lse``
    (without it, ``flash_bwd_prep`` first recomputes it); on the sm90 route,
    given the sm90 forward's ``lse``, dQ computing delta = rowsum(dO ∘ O)
    into float32 scratch (B·H, Lq) (:func:`bwd_dq_delta_sm90_cuda`), then
    dK/dV (the group's heads summed) reading it; else ``flash_bwd_prep``
    (delta, and each row's log-sum-exp unless the forward's ``lse`` is
    given: the resident forward's where the resident backward does not
    fit), then dK/dV and dQ.  The same inputs as the forward (every row must see a key);
    ``out`` and ``dout`` (B, H, Lq, D) in q's dtype on q's device, last
    dimension dense (on the sm90 route with ``lse``, ``out`` 16-byte
    aligned too).  Gradients come in ``torch.empty_like`` of q, k and v
    (their layouts)."""
    route = _bwd_route_of(q, k, causal, window)
    if route == "sm90":
        if lse is None:
            return _sm90_bwd_prep_forced(q, k, v, out, dout, causal, window)
        dq, delta = bwd_dq_delta_sm90_cuda(q, k, v, out, dout, lse, causal, window)
        return (dq, *bwd_dkdv_sm90_cuda(q, k, v, dout, lse, delta, causal, window))
    if route == "resident":
        if lse is None:
            _resident_bwd_checked(q, k, v, out, dout, causal, window, "flash_bwd_resident")
            lse, _ = bwd_prep_cuda(q, k, out, dout, causal, window, v=v)
        return bwd_resident_cuda(q, k, v, out, dout, lse, causal, window)
    return _general_bwd_forced(q, k, v, out, dout, causal, window, lse)


def _sm90_bwd_prep_forced(q, k, v, out, dout, causal: bool = True,
                          window: Optional[int] = None, lse=None):
    """The sm90 backward through prep (delta, and the log-sum-exp unless
    ``lse`` is given), dK/dV, then dQ reading prep's delta: the route
    without the forward's log-sum-exp, and with it the three-launch design
    before dQ computed delta, to check and time it beside the route's."""
    _sm90_bwd_checked(q, k, v, dout, causal, window, "flash_attention_bwd_sm90")
    lse, delta = bwd_prep_cuda(q, k, out, dout, causal, window, v=v, lse=lse)
    dk, dv = bwd_dkdv_sm90_cuda(q, k, v, dout, lse, delta, causal, window)
    return bwd_dq_sm90_cuda(q, k, v, dout, lse, delta, causal, window), dk, dv


def _general_bwd_forced(q, k, v, out, dout, causal: bool = True, window: Optional[int] = None,
                        lse=None):
    """:func:`flash_attention_bwd_cuda` through the general backward's three
    kernels whatever the route (prep recomputes the log-sum-exp unless
    ``lse`` is given), to time and check it beside the route's."""
    lse, delta = bwd_prep_cuda(q, k, out, dout, causal, window, v=v, lse=lse)
    dk, dv = bwd_dkdv_cuda(q, k, v, dout, lse, delta, causal, window)
    return bwd_dq_cuda(q, k, v, dout, lse, delta, causal, window), dk, dv
