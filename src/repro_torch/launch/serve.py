"""LM serving launcher on one device: a batch of prompts through prefill
and a greedy decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b --config full \\
        --prompt-len 2048

The port of the LM branch of ``repro.launch.serve``: random weights from
a seeded generator (``init``), ``--requests`` prompts of ``--prompt-len``
tokens from ``numpy.random.default_rng(0)``, a KV cache of prompt +
``--decode-steps`` positions, prefill, then ``--decode-steps`` greedy
steps.  ``--config smoke`` (the default, as the JAX launcher runs) takes
the arch's small config, ``full`` its published widths.  On ``cuda``
every attention runs the CUDA kernel of
``repro_torch.kernels.flash_attention``; ``--device cpu`` runs its plain
PyTorch version.  Only the LM archs are ported (``configs.registry``).
"""

from __future__ import annotations

import argparse
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
    ap.add_argument("--device", default="cuda")
    return ap


def setup(args: argparse.Namespace, log_fn=print):
    """The model with seeded random weights on ``args.device`` and the
    prompts (requests, prompt_len) int32 as numpy.  Raises for an arch
    that is not ported and, on ``cuda``, without a GPU."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.device_engine import resolve_device

    spec = get_arch(args.arch)
    cfg = spec.smoke_cfg if args.config == "smoke" else spec.cfg
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    model = T.init(cfg, torch.Generator(device=dev).manual_seed(WEIGHT_SEED), dev)
    _sync(dev)
    log_fn(f"{cfg.name} [{args.config}]: {cfg.n_params() / 1e9:.3f} B parameters on {dev} "
           f"in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(PROMPT_SEED)
    prompts = rng.integers(0, cfg.vocab, (args.requests, args.prompt_len)).astype(np.int32)
    return model, prompts


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(model: T.LM, prompts: np.ndarray, decode_steps: int, log_fn=print) -> Dict[str, object]:
    """Prefill ``prompts`` and decode ``decode_steps`` greedy tokens per
    request, as the JAX launcher does.  Returns the tokens (requests,
    decode_steps) as numpy and the host-clock times, each ending in a
    device sync."""
    dev = model.embed.device
    b, plen = prompts.shape
    cache = T.init_cache(model.cfg, b, plen + decode_steps, dev)
    tokens = torch.from_numpy(prompts).to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = T.prefill(model, tokens, cache)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    toks, step_s = [], []
    for _ in range(decode_steps):
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        toks.append(nxt[:, 0])
        ts = time.perf_counter()
        logits, cache = T.decode_step(model, nxt, cache)
        _sync(dev)
        step_s.append(time.perf_counter() - ts)
    wall_s = time.perf_counter() - t0
    out = torch.stack(toks, 1).cpu().numpy() if toks else np.zeros((b, 0), np.int32)
    report = {
        "device": str(dev), "requests": b, "prompt_len": plen, "decode_steps": decode_steps,
        "cache_len": cache.length, "tokens": out, "prefill_s": prefill_s,
        "decode_step_s": step_s,
        "decode_step_s_median": statistics.median(step_s) if step_s else 0.0,
        "wall_s": wall_s, "tokens_per_s": b * decode_steps / wall_s,
    }
    log_fn(f"{b} requests x {decode_steps} tokens in {wall_s:.2f}s "
           f"({report['tokens_per_s']:.0f} tok/s); prefill of {b} x {plen} in {prefill_s:.3f}s, "
           f"median decode step {report['decode_step_s_median'] * 1e3:.2f} ms")
    if b:
        log_fn(f"first request: {out[0].tolist()}")
    return report


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = build_parser().parse_args(argv)
    model, prompts = setup(args)
    return serve(model, prompts, args.decode_steps)


if __name__ == "__main__":
    main()
