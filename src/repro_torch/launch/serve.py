"""LM serving launcher on one device: a batch of prompts through prefill
and a greedy decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b --config full \\
        --prompt-len 2048
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \\
        --cell decode_32k --device cpu

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
model too large for one card at full depth).  On ``cuda`` every attention runs
the CUDA kernel of ``repro_torch.kernels.flash_attention``; ``--device
cpu`` runs its plain PyTorch version.  With MoE the launcher also
reports the slots the dispatch dropped over capacity in each model call.
Only the LM archs are ported (``configs.registry``).
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.models import transformer as T

WEIGHT_SEED = 0
PROMPT_SEED = 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--decode-steps", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--config", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--cell", default=None,
                    help="a prefill or decode cell of the arch whose overrides to apply")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (default: the config's)")
    ap.add_argument("--device", default="cuda")
    return ap


def cell_config(spec, cfg, cell_name: Optional[str]):
    """``cfg`` with the overrides of the serving cell ``cell_name`` (None:
    ``cfg`` itself).  Raises for an unknown cell, a skipped one, or one
    that is not a prefill or decode cell."""
    if cell_name is None:
        return cfg
    if cell_name not in spec.cells:
        raise KeyError(f"{spec.name} has no cell {cell_name!r}; choose from {sorted(spec.cells)}")
    cell = spec.cells[cell_name]
    if cell.skip:
        raise ValueError(f"{spec.name} skips cell {cell_name!r}: {cell.skip}")
    if cell.kind not in ("prefill", "decode"):
        raise ValueError(f"cell {cell_name!r} is a {cell.kind} cell; the launcher serves "
                         f"prefill and decode cells")
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


def serve(model: T.LM, prompts: np.ndarray, decode_steps: int, log_fn=print) -> Dict[str, object]:
    """Prefill ``prompts`` and decode ``decode_steps`` greedy tokens per
    request, as the JAX launcher does.  Returns the tokens (requests,
    decode_steps) as numpy, the host-clock times, each ending in a device
    sync, and with MoE the dropped slots of each model call (prefill
    first)."""
    dev = model.embed.device
    b, plen = prompts.shape
    cache = T.init_cache(model.cfg, b, plen + decode_steps, dev)
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


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = build_parser().parse_args(argv)
    model, prompts = setup(args)
    return serve(model, prompts, args.decode_steps)


if __name__ == "__main__":
    main()
