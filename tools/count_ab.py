"""Time the count kernels on one GPU: the count of every bin of the
non-clustered baseline in one launch (``index.batched.count_queries``) at
each of its designs, to set its defaults (``kernel.MERGE_TILE``,
``SEARCH_CHUNK``, ``RATIO_CUT``); and the per-bin count's two forms at the
baseline's bins and at the block path's shapes, to set the cuts of
``kernel.count_route``: each shape's row form and split form, forced, as
device time from CUDA-graph replays in turns (row, split, split, row).

    python3 tools/count_ab.py            # on the GPU, ~5 min
    python3 tools/count_ab.py --bins     # the one-launch count only, ~3 min

The one-launch count's designs: every compiled merge tile and search
chunk at each ratio cut of ``RATIO_CUTS``, each equal to the plain
version, timed as graph-replay device ms in two passes (the second in the
reverse order); the fastest and the defaults are then timed in turns
(fastest, defaults, defaults, fastest), eager and as graph replays,
beside the per-bin route of ``kernel.count_route`` (103 launches).

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
# Ratio cuts (Ll / Ls past which a row takes search items) of the
# one-launch count's designs.
RATIO_CUTS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, float("inf"))


def time_bins_designs(S, K, dbins, want, routed) -> dict:
    """The one-launch count at each design against the plain version's
    ``want``, timed (graph-replay device ms, two passes); the fastest and
    the defaults in turns beside ``routed``, the per-bin route."""
    from repro_torch.index.batched import count_queries

    designs = [(t, c, r) for t in K.MERGE_TILES for c in K.SEARCH_CHUNKS for r in RATIO_CUTS]
    tables = {}
    for design in designs:
        d = dbins.with_design(*design)
        S.assert_equal(f"count_queries at {design}", count_queries(d), want)
        tables[design] = d
    ms = {design: [] for design in designs}
    for order in (designs, designs[::-1]):
        for design in order:
            ms[design].append(S.graph_ms(lambda d=tables[design]: count_queries(d), reps=10))
    rows = [{"merge_tile": t, "search_chunk": c, "ratio_cut": r, "items": len(tables[(t, c, r)].items),
             "search_items": int((tables[(t, c, r)].items[:, 7] == K.SEARCH).sum()),
             "device_ms": sum(ms[(t, c, r)]) / 2, "passes": ms[(t, c, r)]}
            for t, c, r in designs]
    rows.sort(key=lambda r: r["device_ms"])
    best = rows[0]
    fastest = tables[(best["merge_tile"], best["search_chunk"], best["ratio_cut"])]
    default = dbins.with_design(K.MERGE_TILE, K.SEARCH_CHUNK, K.RATIO_CUT)
    turns = {}
    for name, timer in (("eager", S.time_ms), ("graph", S.graph_ms)):
        t = [timer(lambda d=d: count_queries(d), reps=10)
             for d in (fastest, default, default, fastest)]
        turns[name] = {"fastest": (t[0] + t[3]) / 2, "default": (t[1] + t[2]) / 2, "turns": t}
    turns["route_graph"] = S.graph_ms(routed, reps=10)
    turns["route_eager"] = S.time_ms(routed, reps=10)
    return {"designs": rows, "fastest": best, "in_turns": turns}


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

    bins_only = "--bins" in sys.argv[1:]

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
    dbins = inputs["dbins"]
    tensors = dbins.bin_rows()
    want = R.intersect_count_bins_ref(dbins.short, dbins.long, dbins.bins, dbins.query_ids,
                                      dbins.n_queries)
    from repro_torch.index.batched import count_intersections

    def routed():
        for s, l in tensors:
            count_intersections(s, l)

    one_launch = time_bins_designs(S, K, dbins, want, routed)
    for row in one_launch["designs"][:12]:
        print(f"count_queries tile {row['merge_tile']} chunk {row['search_chunk']} ratio cut "
              f"{row['ratio_cut']}: {row['items']} items ({row['search_items']} search), device "
              f"{row['device_ms']:.4f} ms (passes {row['passes'][0]:.4f}, {row['passes'][1]:.4f})",
              flush=True)
    default = next(r for r in one_launch["designs"] if (r["merge_tile"], r["search_chunk"],
                   r["ratio_cut"]) == (K.MERGE_TILE, K.SEARCH_CHUNK, K.RATIO_CUT))
    t = one_launch["in_turns"]
    print(f"count_queries: the fastest design {one_launch['fastest']['merge_tile']}/"
          f"{one_launch['fastest']['search_chunk']}/{one_launch['fastest']['ratio_cut']}, the "
          f"defaults {K.MERGE_TILE}/{K.SEARCH_CHUNK}/{K.RATIO_CUT} ({default['device_ms']:.4f} "
          f"ms in the sweep); in turns, eager {t['eager']['fastest']:.4f} / "
          f"{t['eager']['default']:.4f}, device {t['graph']['fastest']:.4f} / "
          f"{t['graph']['default']:.4f}; the per-bin route eager {t['route_eager']:.4f}, device "
          f"{t['route_graph']:.4f}", flush=True)
    out = ROOT / "chiprun_out" / "count_ab.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    report = {"card": card, "sms": sms, "count_queries": one_launch}
    if bins_only:
        out.write_text(json.dumps(report, indent=1))
        return 0
    bins = [record("baseline", s, l, False) for s, l in tensors]
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
    out.write_text(json.dumps({**report, "baseline_sums_ms": sums,
                               "baseline_route_ms": routed, "baseline_best_ms": best,
                               "row_form_from_rows_per_sm": cut, "sums_by_kind": sums_by_kind, "bins": bins, "block": block},
                              indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
