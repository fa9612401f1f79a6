"""Time the count kernel's two forms on one GPU, at the non-clustered
baseline's bins and at the block path's shapes, to set the cuts of
``kernel.count_route``: each shape's row form and split form, forced, as
device time from CUDA-graph replays in turns (row, split, split, row).

    python3 tools/count_ab.py            # on the GPU, ~4 min

The data are ``chip_smoke.py``'s: the ``wiki`` corpus at ``N_DOCS``
documents fitted as its search phase fits it, the arity-2 log and the
arity 1-5 log of ``N_QUERIES`` queries.  The baseline's bins come from
``index.batched.batch_queries`` over the fit's randomized-id
``base_index``.  The block path's shapes are the packs
(``SearchService.pack``) of the first 1, 2, ..., ``BLOCK_QUERIES`` queries
of each log, and the first rows of the ``BLOCK_QUERIES`` pack, from half a
row per streaming multiprocessor to the whole pack: the pairs count
(rank 0 against rank 1) and the members count (the mixed log's rank 0
against its last rank).  Between the two, random rows made on the card
(strictly increasing, short and long spanning the same range) at the
widths of ``WIDTHS`` and ``SYNTH_ROWS_PER_SM`` rows an SM.  Every form's
counts must equal the plain version's at every shape.  Results go to ``chiprun_out/count_ab.json``
with the card's name and power limit.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# First rows of a block-path pack, in rows per streaming multiprocessor.
ROWS_PER_SM = (0.5, 1, 2, 4, 6, 8, 10, 12, 14, 16, 20, 24, 32, 48, 64, 96)
# (Ls, Ll) of the random rows, and their rows per streaming multiprocessor.
WIDTHS = ((512, 8192), (1024, 8192), (4096, 65536), (16384, 262144), (32768, 262144),
          (65536, 262144), (131072, 262144))
SYNTH_ROWS_PER_SM = (0.25, 0.5, 1, 2, 3, 4, 6, 8, 16, 32)


def synth_rows(torch, dev, rows: int, ls: int, ll: int, gen):
    """(rows, ls) and (rows, ll) strictly increasing int32 rows over the
    same range (gaps of mean 4 in the long rows)."""
    gap = 4 * ll // ls
    def rising(width, top):
        steps = torch.randint(1, top, (rows, width), generator=gen, device=dev,
                              dtype=torch.int32)
        return steps.cumsum(1, dtype=torch.int32)

    return rising(ls, 2 * gap), rising(ll, 8)


def time_forms(S, K, R, torch, s, l, members: bool) -> dict:
    """Both forms at (s, l), checked against the plain version: device ms
    of each, the mean of two turns."""
    if members:
        want = R.intersect_members_ref(s, l).sum(dim=1).to(torch.int32)
    else:
        want = R.intersect_count_ref(s, l)
    fns = {"row": K._row_form_forced, "split": K._split_form_forced}
    times = {form: [] for form in fns}
    for form, fn in fns.items():
        S.assert_equal(f"{form} at {tuple(s.shape)} x {tuple(l.shape)}",
                       fn(s, l, members=members), want)
    for form in ("row", "split", "split", "row"):
        times[form].append(S.graph_ms(lambda fn=fns[form]: fn(s, l, members=members), reps=10))
    return {form: sum(t) / len(t) for form, t in times.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("count_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as S
    from repro_torch.kernels import build as B
    from repro_torch.kernels.intersect import kernel as K
    from repro_torch.kernels.intersect import ref as R
    from repro_torch.launch import search

    card = S.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sms = K.device_sms(dev)
    t0 = time.perf_counter()
    B.build_libraries()
    print(f"built in {time.perf_counter() - t0:.1f}s; {sms} SMs; ptxas intersect.cu: "
          + " | ".join(B.PTXAS.get("intersect", [])), flush=True)
    t0 = time.perf_counter()
    args = search.build_parser().parse_args([
        "--corpus", "wiki", "--docs", str(S.N_DOCS), "--k", str(S.K_CLUSTERS), "--tc", "3000",
        "--queries", str(S.N_QUERIES), "--device", "cuda"])
    svc, logs, _, _ = search.setup(args, log_fn=lambda *_: None)
    print(f"fit in {time.perf_counter() - t0:.1f}s", flush=True)

    def shape_of(s, l):
        return [s.shape[0], s.shape[1], l.shape[1]]

    def record(kind, s, l, members, **extra):
        ms = time_forms(S, K, R, torch, s, l, members)
        return {"kind": kind, "shape": shape_of(s, l), "members": members,
                "route": K.count_route(*s.shape, l.shape[1], sms), "device_ms": ms, **extra}

    inputs = S.baseline_bins(torch, dev, svc.res.base_index, logs["arity2"].queries)
    bins = [record("baseline", s, l, False) for s, l in inputs["tensors"]]
    sums = {form: sum(b["device_ms"][form] for b in bins) for form in ("row", "split")}
    routed = sum(b["device_ms"][b["route"]] for b in bins)
    best = sum(min(b["device_ms"].values()) for b in bins)
    print(f"baseline, {len(bins)} bins (device ms): row form {sums['row']:.4f}, split form "
          f"{sums['split']:.4f}, the route {routed:.4f}, the faster form per bin {best:.4f}",
          flush=True)

    def put(a):
        return torch.from_numpy(a.astype("int32", copy=False)).to(dev).contiguous()

    block = []
    for name, members in (("arity2", False), ("arity1to5", True)):
        queries = logs[name].queries
        n = 1
        while n <= search.BLOCK_QUERIES:
            segs = [put(b) for b in svc.pack(queries[:n]).segments]
            block.append(record("pack", segs[0], segs[-1], members, log=name, n_queries=n))
            n *= 2
        full = segs
        for k in ROWS_PER_SM:
            m = min(int(k * sms), full[0].shape[0])
            s, l = full[0][:m].contiguous(), full[-1][:m].contiguous()
            block.append(record("rows", s, l, members, log=name, rows_per_sm=m / sms))
            if m == full[0].shape[0]:
                break
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for ls, ll in WIDTHS:
        for k in SYNTH_ROWS_PER_SM:
            s, l = synth_rows(torch, dev, max(1, int(k * sms)), ls, ll, gen)
            block.append(record("random", s, l, False, rows_per_sm=k))
            del s, l
        torch.cuda.empty_cache()
    for b in block:
        ms = b["device_ms"]
        print(f"  {b['kind']} {b.get('log')} {tuple(b['shape'])} ({b['shape'][0] / sms:.1f} rows "
              f"an SM) [{b['route']}]: row {ms['row']:.4f}, split {ms['split']:.4f}", flush=True)
    # The cut at each width: the fewest rows an SM from which on the row
    # form is never slower (Ls > ROW_FORM_LS; the shapes grouped by width).
    cut = {}
    for b in block:
        if b["shape"][1] > K.ROW_FORM_LS:
            cut.setdefault(f"{b['kind']} {b['shape'][1]} x {b['shape'][2]}", []).append(b)
    for name, group in cut.items():
        group.sort(key=lambda b: b["shape"][0])
        cut[name] = next((b["shape"][0] / sms for i, b in enumerate(group)
                          if all(c["device_ms"]["row"] <= c["device_ms"]["split"]
                                 for c in group[i:])), None)
        print(f"{name}: the row form never slower from {cut[name]} rows an SM on", flush=True)
    print(f"the route's cut: {K.ROW_FORM_ROWS_PER_SM} rows an SM, every row count past "
          f"{K.WIDE_LS} short elements", flush=True)
    sums_by_kind = {}
    for b in bins + block:
        ms = b["device_ms"]
        part = sums_by_kind.setdefault(b["kind"], {"row": 0.0, "split": 0.0, "route": 0.0,
                                                   "best": 0.0})
        for key, value in (("row", ms["row"]), ("split", ms["split"]),
                           ("route", ms[b["route"]]), ("best", min(ms.values()))):
            part[key] += value
    for kind, part in sums_by_kind.items():
        print(f"{kind} (device ms, sums): " + ", ".join(f"{k} {v:.4f}" for k, v in part.items()),
              flush=True)
    out = ROOT / "chiprun_out" / "count_ab.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "sms": sms, "baseline_sums_ms": sums,
                               "baseline_route_ms": routed, "baseline_best_ms": best,
                               "row_form_from_rows_per_sm": cut, "sums_by_kind": sums_by_kind, "bins": bins, "block": block},
                              indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
