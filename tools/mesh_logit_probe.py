"""How far qwen1.5-32b's logits move between routes that differ only in
rounding, by depth, on one GPU.

    python3 tools/mesh_logit_probe.py [--depths 16 32 48 64] [--steps 16]

qwen1.5-32b at full width (``decode_32k``: the int8 KV cache) with its
depth cut to each of ``--depths``, seeded random weights, 4 requests of
2,048 prompt tokens + ``--steps`` greedy steps, served once under a 1 x 4
slot mesh of the card through ``launch/serve.py``; then every route below
is fed that run's tokens and its logits (the prefill's, then each step's)
are compared per call as ``chip_smoke.py`` compares them, max |a - b| /
max |b|:

* ``mesh``: the kernels under the 1 x 4 mesh (the split-K mesh decode);
* ``single``: the kernels on one device (no mesh);
* ``single_splits_a`` / ``single_splits_b``: the same with the decode
  variant planned for half / twice the card's SM count, so its keys fall
  into other splits: the single-device route with another float32 sum
  order and nothing else changed;
* ``single_one_ulp``: the single-device route with one element of the
  first decode call's attention output (layer 0, the first step) moved
  by one bf16 unit in the last place (``chip_smoke.OneUlpAttention``);
* ``plain``: the plain route under the mesh (attention in float32 from
  the same bf16 inputs: ``chip_smoke.plain_attention`` and the decode
  kernels' plain versions);
* ``plain_bf16``: as ``plain``, but the prefill's attention is the plain
  version run in bf16 as the reference's ``attention_ref`` runs it
  (scores in bf16, P rounded to bf16 before P·V);
* ``shard_dropped``: ``chip_smoke``'s control, one shard's partials left
  out of the merge.

The mesh route also compares, at every decode call, its attention output
with the single-device kernel's on the same inputs (``layers.attention``
over the dequantized visible prefix): the elements that differ and by how
many bf16 units.  Writes ``chiprun_out/mesh_logit_probe.json`` and prints
one line a depth.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# The pairs read at each depth: (label, route a, route b).
PAIRS = (
    ("mesh vs single", "mesh", "single"),
    ("single_splits_a vs single", "single_splits_a", "single"),
    ("single_splits_b vs single", "single_splits_b", "single"),
    ("single_one_ulp vs single", "single_one_ulp", "single"),
    ("single vs plain", "single", "plain"),
    ("mesh vs plain", "mesh", "plain"),
    ("single vs plain_bf16", "single", "plain_bf16"),
    ("plain vs plain_bf16", "plain", "plain_bf16"),
    ("shard_dropped vs single", "shard_dropped", "single"),
)


def plain_attention_bf16(q, k, v, causal=True, window=None):
    """The plain version in the inputs' own dtype (the reference's
    ``attention_ref`` semantics at bf16), over chunks of query rows."""
    from _torch_parity import attention_ref_chunked

    return attention_ref_chunked(q, k, v, causal, window)


def sm_count_scaled(real, scale):
    """``real`` (``kernel.sm_count``) times ``scale``, at least 1: the
    decode variant's plan for another card, hence other splits."""
    def scaled(index):
        return max(1, int(real(index) * scale))
    return scaled


class DecodeDiff:
    """``layers._flash_decode`` as it is, comparing each call's output with
    the single-device kernel's on the same inputs."""

    def __init__(self, real):
        self.real, self.calls, self.elements, self.differ, self.max_ulps = real, 0, 0, 0, 0

    def __call__(self, q, k_new, v_new, cache, window):
        import torch

        from repro_torch.models import layers as L

        out = self.real(q, k_new, v_new, cache, window)
        start = 0 if window is None else max(0, cache.length - window)
        k, v = L.cache_read(cache, q.dtype, start)
        single = L.attention(q, k, v, causal=True, window=window)
        ulps = (out.view(torch.int16).int() - single.view(torch.int16).int()).abs()
        self.calls += 1
        self.elements += out.numel()
        self.differ += int((ulps > 0).sum())
        self.max_ulps = max(self.max_ulps, int(ulps.max()))
        return out


def probe_depth(torch, dev, depth: int, steps: int) -> dict:
    import chip_smoke as S
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.launch import serve
    from repro_torch.models import layers as L

    args = serve.build_parser().parse_args([
        "--arch", "qwen1.5-32b", "--config", "full", "--requests", "4", "--prompt-len", "2048",
        "--decode-steps", str(steps), "--device", "cuda", "--cell", "decode_32k",
        "--mesh", "1x4", "--layers", str(depth)])
    model, prompts = serve.setup(args, log_fn=lambda *_: None)
    mesh = serve.build_mesh(args.mesh, dev)
    report = serve.serve(model, prompts, steps, log_fn=lambda *_: None, mesh=mesh)
    fed = torch.from_numpy(report["tokens"]).to(dev)
    S.MESH_REAL.update({name: getattr(L, name) for name in ("_merge_partials", "_sum_slots")})
    plain = {"flash_attention": S.plain_attention,
             "flash_decode_partials": S.plain_decode_partials,
             "flash_decode_combine": S.plain_decode_combine}
    logits, seconds = {}, {}

    def run(name, mesh_, patches=None):
        t0 = time.perf_counter()
        logits[name] = S.mesh_replay(torch, model, prompts, fed, mesh_, patches)[0]
        seconds[name] = time.perf_counter() - t0

    diff = DecodeDiff(L._flash_decode)
    run("mesh", mesh, {"_flash_decode": diff})
    run("single", None)
    one = S.OneUlpAttention(L.attention)
    run("single_one_ulp", None, {"attention": one})
    real = K.sm_count
    try:
        for name, scale in (("single_splits_a", 0.5), ("single_splits_b", 2.0)):
            K.sm_count = sm_count_scaled(real, scale)
            K._LAUNCHES_BY_GEOMETRY.clear()  # each geometry keeps its plan
            run(name, None)
    finally:
        K.sm_count = real
        K._LAUNCHES_BY_GEOMETRY.clear()
    run("plain", mesh, plain)
    run("plain_bf16", mesh, {**plain, "flash_attention": plain_attention_bf16})
    run("shard_dropped", mesh, S.MESH_CONTROLS["shard"][1])
    bhkv = 4 * model.cfg.n_kv_heads
    sms = real(dev.index)
    plans = {name: K.decode_plan(1, 2048 + steps, None, bhkv, max(1, int(sms * scale)))
             for name, scale in (("single", 1.0), ("single_splits_a", 0.5),
                                 ("single_splits_b", 2.0))}
    out = {"depth": depth, "route_s": seconds, "decode_plans_last_step": plans,
           "one_ulp_applied": one.done,
           "mesh_vs_single_kernel": {"calls": diff.calls, "elements": diff.elements,
                                     "differ": diff.differ, "max_ulps": diff.max_ulps},
           "pairs": {label: S.logit_rel_errs(logits[a], logits[b]) for label, a, b in PAIRS}}
    del logits, model
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--depths", type=int, nargs="+", default=[16, 32, 48, 64])
    parser.add_argument("--steps", type=int, default=16)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("mesh_logit_probe: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests"), str(ROOT)]
    import chip_smoke as S
    from repro_torch.kernels import build as B

    print(S.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    B.build_libraries()
    rows = []
    for depth in args.depths:
        row = probe_depth(torch, dev, depth, args.steps)
        rows.append(row)
        print(f"depth {depth}: " + "; ".join(
            f"{label} prefill {errs[0]:.4g} decode max {max(errs[1:]):.4g}"
            for label, errs in row["pairs"].items())
            + f"; mesh decode vs the single-device kernel on the same inputs "
            f"{row['mesh_vs_single_kernel']}; plans {row['decode_plans_last_step']}", flush=True)
    out = ROOT / "chiprun_out" / "mesh_logit_probe.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": S.card_line(), "depths": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
