"""Where a decode step's time goes, and what the split-K degree buys.

    python -m k8s_device_plugin_tpu_torch.decode_profile [--steps 20]

Runs on the card only.  Two measurements at the serving slice's full width
(vocab 32000, hidden 1024, 8 layers, 16 heads / 4 kv heads, page 16, 512
pages, 32 pages per sequence, 8 slots, bf16):

1. ``decode``: 8 requests (prompt 128) are admitted and prefilled, then
   ``--steps`` decode steps run under ``torch.profiler``.  Reported: the
   step's host wall time, the device time summed over its kernels, the
   device's busy share (the union of kernel intervals over the span of the
   trace), and the kernels that take the most device time.
2. ``splits``: the paged-attention kernel alone at the decode shape (lens
   129..241), for split counts 1..16: CUDA-event time per call over a loop
   of launches (host launch cost included) and the profiler's device time
   of the kernel and its combine (host excluded).

Prints one JSON line with both.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .models import engine as engine_mod
from .ops import paged_attention as pa

WIDTH_ARGS = [
    "--hidden=1024", "--layers=8", "--heads=16", "--kv-heads=4", "--vocab=32000",
    "--page-size=16", "--num-pages=512", "--max-pages-per-seq=32", "--slots=8",
]


def _is_device(evt) -> bool:
    return getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA


def trace_stats(prof, top: int = 12) -> dict:
    """Device time, busy share and top kernels of one profiled window."""
    events = list(prof.events())
    # Device events other than kernels: user annotations (e.g. the
    # optimizer's step range) also land on the device timeline.
    kernels = [
        e for e in events
        if _is_device(e) and not getattr(e, "is_user_annotation", False)
        and e.time_range.end > e.time_range.start
    ]
    if not kernels:
        return {"device_us": None, "busy_share": None, "top": [], "note": "no device events traced"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    lo = min(e.time_range.start for e in events)
    hi = max(e.time_range.end for e in events)
    by_name: dict[str, list] = {}
    for e in kernels:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.end - e.time_range.start
        acc[1] += 1
    total = sum(v[0] for v in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "device_us": total,
        "busy_share": busy / (hi - lo) if hi > lo else None,
        "trace_span_us": hi - lo,
        "top": [
            {"kernel": name[:90], "us": us, "calls": n, "share": us / total}
            for name, (us, n) in ranked
        ],
    }


def profile_decode(steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    args = engine_mod.parse_args(WIDTH_ARGS + ["--device=cuda"])
    eng = engine_mod.build_engine(args)
    jobs = engine_mod.synthetic_jobs(args.slots, 128, 16 + steps + 8, args.vocab)
    eng.run([(p, 2) for p, _ in jobs[:2]])  # warm every path once
    reqs = [eng.submit(p, n) for p, n in jobs]
    while not all(eng._slot_ready[s] for s in range(eng.max_slots)):
        eng.step()
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    pa.paged_attention.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = pa.paged_attention.launches
    while not all(r.done for r in reqs):
        eng.step()
    stats = trace_stats(prof)
    stats.update(
        steps=steps,
        step_ms=wall / steps * 1e3,
        paged_launches=launches,
        device_ms_per_step=None if stats["device_us"] is None else stats["device_us"] / steps / 1e3,
    )
    return stats


def sweep_splits(max_splits: int = 16, iters: int = 200) -> list[dict]:
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    B, H, HK, D, PS, MPP, P = 8, 16, 4, 64, 16, 32, 512
    gen = torch.Generator(device=dev).manual_seed(0)
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: B * MPP] + 1)
    table = table.reshape(B, MPP).to(torch.int32)
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    pk = torch.randn((P, PS, HK, D), generator=gen, device=dev).to(torch.bfloat16)
    pv = torch.randn((P, PS, HK, D), generator=gen, device=dev).to(torch.bfloat16)
    lens = torch.tensor([129 + 16 * i for i in range(B)], dtype=torch.int32, device=dev)
    rows = []
    splits = 1
    while splits <= max_splits:
        call = lambda s=splits: pa.paged_attention(q, pk, pv, table, lens, num_splits=s)  # noqa: E731
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        end.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        stats = trace_stats(prof)
        rows.append({
            "splits": splits,
            "event_ms_per_call": start.elapsed_time(end) / iters,
            "device_us_per_call": None if stats["device_us"] is None else stats["device_us"] / 20,
        })
        splits *= 2
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="decode-profile")
    p.add_argument("--steps", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_profile measures the card: no CUDA device")
    result = {
        "card": torch.cuda.get_device_name(0),
        "decode": profile_decode(args.steps),
        "splits": sweep_splits(),
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
