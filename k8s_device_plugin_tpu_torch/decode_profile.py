"""Where a decode step's time goes, and what the split-K degree buys.

    python -m k8s_device_plugin_tpu_torch.decode_profile [--steps 20] \
        [--quant {w8,w8a8}] [--quant-kv] [--decode-block 16] \
        [--overlap-steps {0,1}] [--cuda-graphs {0,1}]

Runs on the card only.  Three measurements at the serving slice's full
width (vocab 32000, hidden 1024, 8 layers, 16 heads / 4 kv heads, page 16,
512 pages, 32 pages per sequence, 8 slots, bf16):

1. ``decode``: 8 requests (prompt 128) are admitted and prefilled, then
   ``--steps`` engine steps run under ``torch.profiler``, with the engine's
   weights and KV pools in the format ``--quant``/``--quant-kv`` ask for
   and its decode loop as ``--decode-block``, ``--overlap-steps`` and
   ``--cuda-graphs`` set it (a step is a block of up to that many tokens).
   Reported: the step's host wall time, and per token emitted, the wall
   and the device time summed over the kernels, the device's busy share
   (the union of kernel intervals over the span of the trace), and the
   kernels that take the most device time; then the wall of as many steps
   again with the profiler off (its tracing slows the host).
2. ``splits``: the paged-attention kernel alone at the decode shape (lens
   129..241, bf16 pools), for split counts 1..8 (the cluster's limit):
   CUDA-event time per call over a loop of launches (host launch cost
   included) and the profiler's device time of the kernel (host excluded).
3. ``formats``: the same two times at the tuned split count for each pool
   format (bf16, int8, int4), with the kernel's launches by format.

Prints one JSON line with all three.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from .models import engine as engine_mod
from .ops import paged_attention as pa
from .ops import tuning
from .ops.quant import quantize_kv, quantize_kv4

WIDTH_ARGS = [
    "--hidden=1024", "--layers=8", "--heads=16", "--kv-heads=4", "--vocab=32000",
    "--page-size=16", "--num-pages=512", "--max-pages-per-seq=32", "--slots=8",
]


def _is_device(evt) -> bool:
    return getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA


def trace_stats(prof, top: Optional[int] = 12, name_chars: int = 90) -> dict:
    """Device time, busy share and the ``top`` kernels (None: every one;
    names cut to ``name_chars``) of one profiled window."""
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
            {"kernel": name[:name_chars], "us": us, "calls": n, "share": us / total}
            for name, (us, n) in ranked
        ],
    }


def profile_decode(steps: int, engine_args: tuple = ()) -> dict:
    """One profiled window of ``steps`` engine steps in pure decode (the
    ``decode`` measurement of the module note), the engine built from
    WIDTH_ARGS plus ``engine_args``.  The window follows one untraced
    warm-up step (``profiled_call``'s reason)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    args = engine_mod.parse_args(WIDTH_ARGS + ["--device=cuda", *engine_args])
    eng = engine_mod.build_engine(args)
    block = args.decode_block
    jobs = engine_mod.synthetic_jobs(args.slots, 128, block * (2 * steps + 4) + 16, args.vocab)
    eng.run([(p, 2 * block) for p, _ in jobs[:2]])  # warm every path (and block size) once
    reqs = [eng.submit(p, n) for p, n in jobs]
    while not all(eng._slot_ready[s] for s in range(eng.max_slots)):
        eng.step()
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(trace_stats(p))) as prof:
        eng.step()
        torch.cuda.synchronize()
        prof.step()
        pa.reset_launches()
        emitted = sum(len(r.tokens) for r in reqs)
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    tokens = sum(len(r.tokens) for r in reqs) - emitted
    launches = dict(pa.paged_attention.launches_by_format)
    emitted = sum(len(r.tokens) for r in reqs)
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    plain_tokens = sum(len(r.tokens) for r in reqs) - emitted
    while not all(r.done for r in reqs):
        eng.step()
    stats = traced[0] if traced else {"device_us": None, "busy_share": None, "top": [],
                                      "note": "no window traced"}
    device_ms = None if stats["device_us"] is None else stats["device_us"] / 1e3
    stats.update(
        flags=list(engine_args),
        steps=steps,
        tokens=tokens,
        step_ms=wall / steps * 1e3,
        wall_ms_per_token=wall / tokens * 1e3,
        paged_launches=launches,
        device_ms_per_step=None if device_ms is None else device_ms / steps,
        device_ms_per_token=None if device_ms is None else device_ms / tokens,
        unprofiled_step_ms=plain_wall / steps * 1e3,
        unprofiled_wall_ms_per_token=plain_wall / plain_tokens * 1e3,
    )
    return stats


# The paged kernel's decode shape: 8 rows x 16 heads / 4 kv heads x 64,
# page 16, 32 pages per row of a 512-page pool, lens 129..241 (prompt 128
# plus the decode phase).
DECODE_SHAPE = dict(batch=8, heads=16, kv_heads=4, head_dim=64, page_size=16, mpp=32, pages=512)


def decode_inputs(kv_format: str = "f", dtype=torch.bfloat16, seed: int = 0, device="cuda",
                  head_dim=None) -> dict:
    """The paged kernel's keyword inputs at :data:`DECODE_SHAPE` (its
    head_dim replaced by ``head_dim`` when given): q in ``dtype``, a random
    page table over pages 1.., and pools made from the same seeded float
    values in ``kv_format`` (``dtype`` pools, or int8/int4 codes with
    float32 scale pools through ops/quant.py)."""
    b, h, hk, d = (DECODE_SHAPE[k] for k in ("batch", "heads", "kv_heads", "head_dim"))
    d = d if head_dim is None else head_dim
    ps, mpp, n_pool = DECODE_SHAPE["page_size"], DECODE_SHAPE["mpp"], DECODE_SHAPE["pages"]
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randperm(n_pool - 1, generator=gen, device=dev)[: b * mpp] + 1
    q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((n_pool, ps, hk, d), generator=gen, device=dev) for _ in range(2))
    inputs = dict(
        q=q, page_table=table.reshape(b, mpp).to(torch.int32),
        lens=torch.tensor([129 + 16 * i for i in range(b)], dtype=torch.int32, device=dev),
    )
    if kv_format == "f":
        return dict(inputs, pool_k=k.to(dtype), pool_v=v.to(dtype))
    quantize = {"int8": quantize_kv, "int4": quantize_kv4}[kv_format]
    (pk, sk), (pv, sv) = quantize(k), quantize(v)
    return dict(inputs, pool_k=pk, pool_v=pv, scale_k=sk, scale_v=sv)


# Profiler windows tried before profiled_call gives up on a call.
PROFILE_WINDOWS = 5


def profiled_call(call, iters: int, whole: bool = True, name_chars: int = 90,
                  cpu: bool = False) -> dict:
    """``trace_stats`` (every kernel listed) of ``iters`` calls of ``call``
    (already warm) under torch.profiler (tracing the host too if ``cpu``).  Each window first runs the calls
    once untraced by the profiler's own warm-up step: a window traced from
    its first call may miss the launches of its first calls.  A window
    that traced no device event, or (``whole``: ``call`` launches the same
    kernels each time) one in which a kernel's count is not a multiple of
    ``iters``, is profiled again, up to :data:`PROFILE_WINDOWS` times; then
    it raises RuntimeError."""
    from torch.profiler import ProfilerActivity, profile, schedule

    counts = None
    for _ in range(PROFILE_WINDOWS):
        traced = []
        activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: traced.append(
                         trace_stats(p, top=None, name_chars=name_chars))) as prof:
            for _ in range(2):
                for _ in range(iters):
                    call()
                torch.cuda.synchronize()
                prof.step()
        if not traced or traced[0]["device_us"] is None:
            continue
        stats = traced[0]
        counts = [t["calls"] for t in stats["top"]]
        if not whole or all(n % iters == 0 for n in counts):
            return stats
    raise RuntimeError(f"the profiler traced no whole window of {iters} calls in "
                       f"{PROFILE_WINDOWS} tries (last kernel counts {counts})")


def profiled_device_us(call, iters: int, whole: bool = True) -> float:
    """Device time per call of ``call``: its kernels' time summed over a
    ``profiled_call`` window, over ``iters``."""
    return profiled_call(call, iters, whole)["device_us"] / iters


def _time_call(call, iters: int) -> dict:
    """CUDA-event time per call over a loop of ``iters`` launches (host
    launch cost included) and the profiler's device time per call."""
    for _ in range(10):
        call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    end.synchronize()
    return {
        "event_ms_per_call": start.elapsed_time(end) / iters,
        "device_us_per_call": profiled_device_us(call, 20),
    }


def sweep_splits(max_splits: int = tuning.MAX_SPLITS, iters: int = 200) -> list[dict]:
    inputs = decode_inputs("f")
    rows = []
    splits = 1
    while splits <= max_splits:
        call = lambda s=splits: pa.paged_attention(**inputs, num_splits=s)  # noqa: E731
        rows.append({"splits": splits, **_time_call(call, iters)})
        splits *= 2
    return rows


def sweep_formats(iters: int = 200) -> dict:
    """The kernel at the decode shape and the tuned split count in each
    pool format; ``launches`` counts the kernel's launches by format over
    the sweep."""
    splits = tuning.pick_num_splits(DECODE_SHAPE["mpp"], tuning.device_generation("cuda"))
    rows = []
    pa.reset_launches()
    for kv_format in pa.FORMATS:
        inputs = decode_inputs(kv_format)
        call = lambda: pa.paged_attention(**inputs, num_splits=splits)  # noqa: E731
        rows.append({"format": kv_format, "splits": splits, **_time_call(call, iters)})
    return {"rows": rows, "launches": dict(pa.paged_attention.launches_by_format)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="decode-profile")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--quant", choices=["w8", "w8a8"], default=None,
                   help="profile the engine with int8 weights in this mode")
    p.add_argument("--quant-kv", action="store_true", help="profile the engine with int8 KV pools")
    p.add_argument("--decode-block", type=int, default=1,
                   help="the engine's decode block (each request decodes 2 x steps blocks: "
                   "with 16, pass --steps 8 or fewer)")
    p.add_argument("--overlap-steps", type=int, choices=[0, 1], default=0,
                   help="the engine's overlap round (default 0: the synchronous loop)")
    p.add_argument("--cuda-graphs", type=int, choices=[0, 1], default=0,
                   help="replay the engine's dispatches as CUDA graphs (default 0: eager)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_profile measures the card: no CUDA device")
    engine_args = ([f"--quant={args.quant}"] if args.quant else []) + (
        ["--quant-kv"] if args.quant_kv else []
    ) + [f"--decode-block={args.decode_block}", f"--overlap-steps={args.overlap_steps}",
         f"--cuda-graphs={args.cuda_graphs}"]
    result = {
        "card": torch.cuda.get_device_name(0),
        "decode": profile_decode(args.steps, engine_args),
        "splits": sweep_splits(),
        "formats": sweep_formats(),
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
