"""Serving launcher on one device.  LM archs: a batch of prompts through
prefill and a greedy decode loop; recsys archs (dien, mind, dcn-v2,
bert4rec): batched scoring and candidate retrieval.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b --config full \\
        --prompt-len 2048
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \\
        --cell decode_32k --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-32b \\
        --cell decode_32k --mesh 1x4 --device cpu

The port of the LM branch of ``repro.launch.serve``: random weights from
a seeded generator (``init``), ``--requests`` prompts of ``--prompt-len``
tokens from ``numpy.random.default_rng(0)``, a KV cache of prompt +
``--decode-steps`` positions, prefill, then ``--decode-steps`` greedy
steps.  ``--config smoke`` (the default, as the JAX launcher runs) takes
the arch's small config, ``full`` its published widths.  ``--cell NAME``
applies the overrides of the arch's serving cell ``NAME`` to the config
(as ``repro.launch.steps`` does: ``decode_32k`` and ``prefill_32k`` set
the int8 KV cache, ``kv_quant``); the cell's batch and lengths stay
``--requests`` and ``--prompt-len``.  ``--layers`` cuts the depth (a
model too large for one card at full depth).  ``--mesh DATAxMODEL`` (e.g.
``1x4``) serves the LM under a ``(data, model)`` slot mesh of DATA·MODEL
slots of the serving device (``ElasticMesh(model_parallel=MODEL)``, the
port's counterpart of the mesh the JAX ``build_cell`` takes): each decode
step splits the cache's sequence over the model slots (one split-K launch
a shard with visible keys, one combine a layer), MoE runs expert-parallel
over them.  On ``cuda`` every attention runs
the CUDA kernel of ``repro_torch.kernels.flash_attention``; ``--device
cpu`` runs its plain PyTorch version.  With MoE the launcher also
reports the slots the dispatch dropped over capacity in each model call.

The recsys branch (the port of the JAX launcher's, and of the serve and
retrieval cells of ``repro.launch.steps``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch dien --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch bert4rec --config full \
        --cell serve_bulk

Without ``--cell`` it runs the JAX launcher's work: ``max(--requests, 4)``
rows with full histories (mask all ones), ``forward``, then
``score_candidates`` against 1,000 random candidates.  ``--cell
serve_p99`` or ``serve_bulk`` runs ``forward`` on the cell's batch (512
or 262,144 rows), ``retrieval_cand`` runs ``score_candidates`` for the
cell's one query against its ``n_candidates`` (10⁶): the catalogue's
first items, ``candidate_ids``.  A cell's histories have lengths drawn
uniformly from [1, T], left-padded with id 0 and mask 0
(``recsys_batch``).  Rows are independent, so a batch is served in slices
of at most ``SERVE_SLICE_ROWS`` rows and the scores concatenated
(``forward_sliced``): at 32,768 rows bert4rec's MLP activations take
6.7 GB, the whole bulk batch's would take 53.7 GB.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T

WEIGHT_SEED = 0
PROMPT_SEED = 0
BATCH_SEED = 0
# Rows of one recsys model call; a larger batch is served in such slices.
SERVE_SLICE_ROWS = 32_768
# The JAX launcher's candidates per request without a cell.
SMOKE_CANDIDATES = 1000


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--config", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--cell", default=None,
                    help="the arch's serving cell: LM prefill or decode (its overrides), "
                         "recsys serve or retrieval (its batch)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (default: the config's)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="serve the LM under a (data, model) mesh of slots of the device, "
                         "e.g. 1x4 (default: no mesh)")
    ap.add_argument("--device", default="cuda")
    return ap


def build_mesh(spec: str, device):
    """The ``(data, model)`` slot mesh ``spec`` ("DATAxMODEL") over
    DATA·MODEL slots of ``device``."""
    from repro_torch.dist.fault_tolerance import ElasticMesh

    try:
        data, model = (int(n) for n in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes DATAxMODEL, e.g. 1x4; got {spec!r}") from None
    if data < 1 or model < 1:
        raise ValueError(f"--mesh {spec}: both axes need at least one slot")
    return ElasticMesh(model_parallel=model).remesh([device] * (data * model))


# The cell kinds the launcher serves, per family.
SERVING_KINDS = {"lm": ("prefill", "decode"), "recsys": ("serve", "retrieval")}


def cell_config(spec, cfg, cell_name: Optional[str]):
    """``cfg`` with the overrides of the serving cell ``cell_name`` (None:
    ``cfg`` itself).  Raises for an unknown cell, a skipped one, or one
    the launcher does not serve: an LM serves prefill and decode cells, a
    recsys arch serve and retrieval cells."""
    if cell_name is None:
        return cfg
    if cell_name not in spec.cells:
        raise KeyError(f"{spec.name} has no cell {cell_name!r}; choose from {sorted(spec.cells)}")
    cell = spec.cells[cell_name]
    if cell.skip:
        raise ValueError(f"{spec.name} skips cell {cell_name!r}: {cell.skip}")
    kinds = SERVING_KINDS.get(spec.family, ())
    if cell.kind not in kinds:
        raise ValueError(f"cell {cell_name!r} is a {cell.kind} cell; the launcher serves "
                         f"{' and '.join(kinds)} cells of a {spec.family} arch")
    return dataclasses.replace(cfg, **cell.overrides)


def setup(args: argparse.Namespace, log_fn=print):
    """The model with seeded random weights on ``args.device`` and the
    prompts (requests, prompt_len) int32 as numpy.  Raises for an arch
    that is not ported, a cell it cannot serve and, on ``cuda``, without a
    GPU."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.device_engine import resolve_device

    spec = get_arch(args.arch)
    cfg = cell_config(spec, spec.smoke_cfg if args.config == "smoke" else spec.cfg, args.cell)
    if args.layers is not None:
        if not 1 <= args.layers <= cfg.n_layers:
            raise ValueError(f"--layers {args.layers} outside [1, {cfg.n_layers}]")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    model = T.init(cfg, torch.Generator(device=dev).manual_seed(WEIGHT_SEED), dev)
    _sync(dev)
    log_fn(f"{cfg.name} [{args.config}{', ' + args.cell if args.cell else ''}, "
           f"{cfg.n_layers} layers]: "
           f"{cfg.n_params() / 1e9:.3f} B parameters on {dev} in {time.perf_counter() - t0:.1f}s"
           f"{' (int8 KV cache)' if cfg.kv_quant else ''}")
    rng = np.random.default_rng(PROMPT_SEED)
    prompts = rng.integers(0, cfg.vocab, (args.requests, args.prompt_len)).astype(np.int32)
    return model, prompts


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _dropped(model: T.LM) -> Optional[torch.Tensor]:
    """The slots the MoE dispatch dropped in the last model call, summed
    over the layers (a device tensor), or None without MoE."""
    counts = [(~blk.moe.routing.keep).sum() for blk in model.blocks if blk.moe is not None]
    return torch.stack(counts).sum() if counts else None


def serve(model: T.LM, prompts: np.ndarray, decode_steps: int, log_fn=print,
          mesh=None) -> Dict[str, object]:
    """Prefill ``prompts`` and decode ``decode_steps`` greedy tokens per
    request, as the JAX launcher does, under ``mesh`` (a ``SlotMesh``,
    the ambient mesh for the run) where given.  Returns the tokens
    (requests, decode_steps) as numpy, the host-clock times, each ending
    in a device sync, and with MoE the dropped slots of each model call
    (prefill first)."""
    from repro_torch.dist import sharding as sh

    previous = sh.get_active_mesh()
    sh.set_mesh(mesh)
    try:
        return _serve(model, prompts, decode_steps, log_fn, mesh)
    finally:
        sh.set_mesh(previous)


def _serve(model: T.LM, prompts: np.ndarray, decode_steps: int, log_fn, mesh):
    dev = model.embed.device
    b, plen = prompts.shape
    cache = T.init_cache(model.cfg, b, plen + decode_steps, dev)
    shards = None
    if mesh is not None and L._flash_decode_applicable(L.KVCache(cache.k[0], cache.v[0]), b):
        shards = [(s.slot.id, (s.row0, s.row1), (s.pos0, s.pos1))
                  for s in L.decode_shards(mesh, b, cache.k.shape[2])]
    if mesh is not None:
        log_fn(f"mesh {mesh!r}: the mesh decode's shards of the KV cache (slot, rows, "
               f"positions) {shards if shards else 'none: every step decodes on one device'}")
    tokens = torch.from_numpy(prompts).to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = T.prefill(model, tokens, cache)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    dropped = [_dropped(model)]
    toks, step_s = [], []
    for _ in range(decode_steps):
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        toks.append(nxt[:, 0])
        ts = time.perf_counter()
        logits, cache = T.decode_step(model, nxt, cache)
        _sync(dev)
        step_s.append(time.perf_counter() - ts)
        dropped.append(_dropped(model))
    wall_s = time.perf_counter() - t0
    out = torch.stack(toks, 1).cpu().numpy() if toks else np.zeros((b, 0), np.int32)
    report = {
        "device": str(dev), "requests": b, "prompt_len": plen, "decode_steps": decode_steps,
        "cache_len": cache.length, "tokens": out, "prefill_s": prefill_s,
        "decode_step_s": step_s,
        "decode_step_s_median": statistics.median(step_s) if step_s else 0.0,
        "wall_s": wall_s, "tokens_per_s": b * decode_steps / wall_s,
        "kv_quant": model.cfg.kv_quant,
        "mesh": None if mesh is None else mesh.shape, "decode_shards": shards,
        "dropped_slots": (None if dropped[0] is None
                          else [int(n) for n in torch.stack(dropped).tolist()]),
    }
    log_fn(f"{b} requests x {decode_steps} tokens in {wall_s:.2f}s "
           f"({report['tokens_per_s']:.0f} tok/s); prefill of {b} x {plen} in {prefill_s:.3f}s, "
           f"median decode step {report['decode_step_s_median'] * 1e3:.2f} ms")
    if report["dropped_slots"] is not None:
        moe = model.cfg.moe
        log_fn(f"MoE dispatch: dropped slots per model call (of tokens x {moe.top_k} per "
               f"layer, {model.cfg.n_layers} layers; prefill first): {report['dropped_slots']}")
    if b:
        log_fn(f"first request: {out[0].tolist()}")
    return report


# ----------------------------------------------------------------------
# The recsys branch
# ----------------------------------------------------------------------


def item_vocab(cfg) -> int:
    """Items of the arch's catalogue: its item table's rows (DCN-v2's
    field tables have ``vocab_per_field``)."""
    return getattr(cfg, "vocab", None) or cfg.vocab_per_field


def history_len(cfg) -> int:
    return getattr(cfg, "seq_len", None) or cfg.hist_len


def recsys_batch(name: str, cfg, rows: int, rng: np.random.Generator,
                 full_histories: bool = False) -> Dict[str, np.ndarray]:
    """A serving batch of ``rows`` as numpy (the JAX ``_recsys_batch_struct``
    less its label).  DCN-v2: 13 standard-normal dense features, sparse
    ids uniform over each field's table, a target id.  The sequence
    models: item ids uniform over the catalogue; history lengths drawn
    uniformly from [1, T] and left-padded (id 0, mask 0: the model reads
    the last position), or with ``full_histories`` all T positions valid
    (the JAX launcher's batch); a target id."""
    if name == "dcn-v2":
        return {
            "dense": rng.standard_normal((rows, cfg.n_dense)).astype(np.float32),
            "sparse_ids": rng.integers(0, cfg.vocab_per_field,
                                       (rows, cfg.n_sparse)).astype(np.int32),
            "target_id": rng.integers(0, cfg.vocab_per_field, rows).astype(np.int32),
        }
    t = history_len(cfg)
    ids = rng.integers(0, cfg.vocab, (rows, t)).astype(np.int32)
    if full_histories:
        mask = np.ones((rows, t), np.float32)
    else:
        lengths = rng.integers(1, t + 1, rows)
        valid = np.arange(t)[None, :] >= t - lengths[:, None]
        ids = np.where(valid, ids, 0).astype(np.int32)
        mask = valid.astype(np.float32)
    return {"hist_ids": ids, "hist_mask": mask,
            "target_id": rng.integers(0, cfg.vocab, rows).astype(np.int32)}


def candidate_ids(cfg, n: int) -> np.ndarray:
    """The ``retrieval_cand`` cell's candidates: the catalogue's first n
    items (ids taken modulo its size where n exceeds it), int32."""
    return (np.arange(n) % item_vocab(cfg)).astype(np.int32)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def forward_sliced(model, batch: Dict[str, torch.Tensor],
                   slice_rows: int = SERVE_SLICE_ROWS) -> torch.Tensor:
    """``model(batch)`` (B,) computed over slices of at most
    ``slice_rows`` rows (rows are independent), concatenated."""
    n = next(iter(batch.values())).shape[0]
    if n <= slice_rows:
        return model(batch)
    return torch.cat([model({k: v[i:i + slice_rows] for k, v in batch.items()})
                      for i in range(0, n, slice_rows)])


def setup_recsys(args: argparse.Namespace, log_fn=print):
    """The recsys model with seeded random weights on ``args.device`` and
    its cell (None without ``--cell``).  Raises for a cell it cannot
    serve and, on ``cuda``, without a GPU."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.device_engine import resolve_device
    from repro_torch.models.recsys import recsys_module

    spec = get_arch(args.arch)
    cfg = cell_config(spec, spec.smoke_cfg if args.config == "smoke" else spec.cfg, args.cell)
    if args.layers is not None:
        raise ValueError("--layers cuts an LM's depth; a recsys arch has no such cut")
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    model = recsys_module(spec.name).init(
        cfg, torch.Generator(device=dev).manual_seed(WEIGHT_SEED), dev)
    _sync(dev)
    log_fn(f"{cfg.name} [{args.config}{', ' + args.cell if args.cell else ''}]: "
           f"{cfg.n_params() / 1e6:.3f} M parameters on {dev} in "
           f"{time.perf_counter() - t0:.1f}s")
    return model, (spec.cells[args.cell] if args.cell else None)


def serve_recsys(model, cell, requests: int = 8, log_fn=print) -> Dict[str, object]:
    """The recsys serving work of ``cell`` (None: the JAX launcher's),
    timed on the host clock with a device sync at the end.  Returns the
    scores as numpy ((rows,) from ``forward``, (1, N) from
    ``score_candidates``) and the times."""
    cfg = model.cfg
    dev = next(model.parameters()).device
    rng = np.random.default_rng(BATCH_SEED)
    name = cfg.name
    report: Dict[str, object] = {"device": str(dev), "arch": name,
                                 "cell": None if cell is None else cell.kind}
    if cell is None or cell.kind == "serve":
        rows = max(requests, 4) if cell is None else cell.batch
        batch = to_device(recsys_batch(name, cfg, rows, rng, full_histories=cell is None), dev)
        _sync(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            scores = forward_sliced(model, batch)
        _sync(dev)
        wall_s = time.perf_counter() - t0
        report.update(rows=rows, scores=scores.cpu().numpy(), wall_s=wall_s,
                      rows_per_s=rows / wall_s, slices=-(-rows // SERVE_SLICE_ROWS))
        log_fn(f"scored {rows} requests in {report['slices']} slice(s) in {wall_s:.3f}s "
               f"({report['rows_per_s']:.0f} rows/s): {report['scores'][:4].round(3)}...")
        if cell is not None:
            return report
        cands = rng.integers(0, item_vocab(cfg), SMOKE_CANDIDATES).astype(np.int32)
    else:
        batch = to_device(recsys_batch(name, cfg, cell.batch, rng), dev)
        cands = candidate_ids(cfg, cell.extra["n_candidates"])
    cand = torch.from_numpy(cands).to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        top = model.score_candidates(batch, cand)
    _sync(dev)
    score_s = time.perf_counter() - t0
    report.update(candidates=top.shape[1], candidate_scores=top.cpu().numpy(),
                  score_s=score_s)
    best = torch.topk(top[0], min(10, top.shape[1])).indices.cpu().numpy()
    log_fn(f"scored {top.shape[0]} x {top.shape[1]} candidates in {score_s:.3f}s; "
           f"top candidates of the first request: {cands[best].tolist()}")
    return report


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = build_parser().parse_args(argv)
    from repro_torch.configs.registry import get_arch

    if get_arch(args.arch).family == "recsys":
        if args.mesh is not None:
            raise ValueError("--mesh serves an LM arch under a slot mesh; a recsys arch has none")
        model, cell = setup_recsys(args)
        return serve_recsys(model, cell, args.requests)
    model, prompts = setup(args)
    mesh = None if args.mesh is None else build_mesh(args.mesh, model.embed.device)
    return serve(model, prompts, args.decode_steps, mesh=mesh)


if __name__ == "__main__":
    main()
