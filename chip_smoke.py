#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero):

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the port from csrc/ (one nvcc each, in
   parallel), and read each flash kernel's registers and spills (ptxas)
   and HGMMA count (cuobjdump) at every head_dim it is built for: the
   tensor-core (wgmma) variants (forward, dQ, dK/dV; built 64 and 128
   wide, and padded at each for the head_dims between) must show HGMMA and
   no spill, the FMA variants (built the same way) no HGMMA; and kernel 1's
   registers and spills in each of its twelve builds (float32 and bf16
   queries, three pool formats, 64 and 128 wide), none of which may spill;
3. hold each kernel against its plain PyTorch version on the card at the
   serving slice's shapes (the paged kernel in each pool format: bf16/f32,
   int8 and int4 codes with float32 scale pools, and the int4 unpack on
   every byte value; under the profiler, one call of the paged kernel must
   be one device kernel, its splits merged inside the launch, in every
   format at 1 and 8 splits, and an empty kernel of the same launch shape
   is timed as its latency floor; the flash forward in both variants, bf16 on the
   tensor cores and float32 on the FMA kernel, over s 128, 200 (ragged),
   512 and 1024, window none and 100, causal and non-causal, kv group 4
   and 1, each case checking which variant launched), and time the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call (the forward at s 128, greedy_generate's prefill,
   and s 1024, the training shape);
3b. hold the flash-backward kernels (dQ and dK/dV, each in both
   variants) against the plain backward over the same matrix at batch 2,
   each case checking which variants launched; at the training shape (b8
   h16 hk4 s1024 d64, causal; bf16 and float32) hold them once more, then
   time them, the plain backward, and SDPA's backward (by profiler device
   time, with the kernels timed the same way beside it);
3c. kernel 1 at head_dim 16, 32, 64, 80, 96 and 128 and every page size
   (1 to 128) in every pool format, and kernels 2-4 at head_dim 16, 32, 80,
   96 and 128 in both variants, against their plain versions; then kernels
   1-4 timed at head_dim 80, 96 and 128 in bf16 (the kernel line's
   ``head_dim_80``, ``head_dim_96`` and ``head_dim_128``);
4. run the batch serving engine at the deployed model's full width (vocab
   32000, hidden 1024, 8 layers, 16 heads / 4 kv heads, page 16, 512 pages,
   32 pages per sequence, 8 slots; 32 requests, prompt 128, 128 new
   tokens, greedy), decode block 1, synchronous and eager (``--overlap-steps
   0 --cuda-graphs 0``), with the launch counters set to 0 just before and
   read just after: the paged-decode kernel must have launched (float
   pools) once per layer on every dispatched step;
4b. the same engine run with the deployed pod's ``--quant=w8``, then with
   ``--quant=w8 --quant-kv``, then with ``--quant=w8a8 --quant-kv``: each
   must return 32 x 128 in-vocab tokens, and the ``--quant-kv`` runs must
   have launched the paged kernel's int8 branch on every decode step;
4d. the same engine at ``--decode-block 16 --overlap-steps 1`` with its
   dispatches replayed as CUDA graphs: the greedy tokens must equal phase
   4's exactly, the paged kernel counted once per layer on every
   dispatched step (a replay counts what its capture launched), with
   overlapped rounds discarded at the finishes and graphs replayed; sampled
   (temperature 0.8, top-k 50) the run must repeat itself under one rng
   with graphs on and off; then ``decode_profile.profile_decode``'s step
   wall against device time per token at block 1 (synchronous and eager,
   and overlapped with graphs) and at block 16;
4e. the port's HTTP server (``models/http_server.py``) as a subprocess at
   the deployment's flags minus the KV-tier ones (hidden 1024, 8 layers,
   16/4 heads, page 16, 512 pages, 8 slots, block 16, optimistic
   admission, prefill chunk 256, overload, SLO, watchdog), an ephemeral
   port and vocab 32000: after a warm-up, phase 4d's traffic from 32
   client threads (24 unary, 8 SSE); the greedy tokens must equal an
   in-process engine built from the same flags; 8 sampled requests (0.8,
   top-k 50, n=2, logprobs) must return finite logprobs <= 0; the debug
   routes are read, ``/metrics`` must pass ``tools/metrics_lint.py``, the
   paged launches must equal layers x dispatched steps by the server's
   own counters, and SIGTERM must drain it to exit 0.  Then again at 96
   pages, where optimistic admission must preempt (the first 8 requests,
   admitted at the full limit, need at least 100 of its 95 allocatable
   pages by their last token): every request ends
   with 128 tokens, equal to the 512-page run's where never preempted and
   up to the first preemption where preempted (the first difference after
   it is reported); and GPTConfig.tiny() in float32 in process, where
   preempted streams must be identical in full;
4c. ``decode_profile.sweep_formats``, the kernel benchmark (the reference
   reaches int4 pools only from its kernel benchmark): each pool format
   at the decode shape, launches counted by format;
5. run greedy_generate at full width (batch 8, prompt 128, 32 new tokens)
   the same way: the flash-forward kernel must have launched, as its
   tensor-core variant only;
6. at 2 layers in float32, the engine's greedy tokens on the kernel path
   must equal those on the gathered-page path wherever the reference's
   top-2 logit margin clears the tolerance, at full width and page 16 and
   at GPTConfig.tiny() (head_dim 16) and page 4;
6b. the same with ``quant="w8"`` and ``quant_kv`` (int8 pools: the kernel
   scales scores and probabilities, the gather path dequantizes first);
7. train the decoder LM through ``models/benchmark.py`` at the reference's
   single-chip configuration (vocab 32000, hidden 1024, 8 layers, 16 heads
   / 4 kv heads, intermediate 2816, bf16 compute, float32 parameters,
   batch 8, seq 1024; 2 warmup and 5 timed steps on one synthetic batch),
   with the launch counters set to 0 just before and read just after: the
   forward, dQ and dK/dV kernels must each have launched 8 layers x the
   steps run, all three as their tensor-core variants only, and every
   step's loss must be finite; then profile one more step under
   ``torch.profiler``;
8. at 2 layers in float32 (full width, batch 2, seq 256, TF32 off), one
   train step on the card (the kernels, the forward, dQ and dK/dV as their
   FMA variants only) and the same step on the CPU (the plain versions) from
   the same weights: losses within 1e-5 relative and every updated
   parameter within 1e-5.

Then it prints one ``kernels`` JSON line (a row per kernel variant, each
with its design, HGMMA count, registers and spill bytes; every number in
it measured in this run, the bounds computed from its inputs), one
``slice`` JSON line, one ``blocks`` JSON line (phase 4d, 3c's worst
errors and the tiny phase 6), one
``quant`` JSON line, one ``train`` JSON line, one ``serve`` JSON line
(phase 4e), and last the line
``{"ok": true, "device": {...}}``.
Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
import time

TOL_BF16 = 2e-2  # bf16 output rounding (one ulp at |x| < 2 is 7.8e-3) plus f32 sum order
TOL_F32 = 2e-5  # f32 sum order over a few hundred terms
TOL_LSE = 1e-3  # f32 log-sum-exp, sum order in 16- vs 128-column online updates
TOL_MARGIN = 1e-3  # fp32 logits: kernel vs gather paths differ by sum order only
# Flash backward, max |kernel - plain| / max |plain| per gradient: bf16
# rounds dS, P and the gradients (one ulp is 2**-8 relative); f32 differs by
# sum order over up to 1024 terms.
TOL_BWD_BF16 = 2e-2
TOL_BWD_F32 = 1e-4
TOL_TRAIN = 1e-5  # fp32 train step, card vs CPU: loss (relative) and params (absolute)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12  # H100 SXM float32 peak outside the tensor cores (the FMA kernels' type)
DEVICE = "cuda"


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> tuple[float, float]:
    """Mean time per call of ``fn`` by CUDA events, two ways: replaying a
    CUDA graph of ``iters`` calls (device time; the host's launch cost is
    gone) and over a loop of ``iters`` eager calls (what a caller that
    launches from Python pays, host launch cost included)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    eager = start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, eager


def bound(bytes_moved: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def quantized_pools(quant, kv_format, k, v, dtype) -> dict:
    """Pool keyword arguments for the paged kernel in ``kv_format`` from
    float pools ``k``/``v``: ``dtype`` pools, or int8/int4 codes with
    float32 scale pools."""
    if kv_format == "f":
        return {"pool_k": k.to(dtype), "pool_v": v.to(dtype)}
    quantize = quant.quantize_kv if kv_format == "int8" else quant.quantize_kv4
    (pk, sk), (pv, sv) = quantize(k), quantize(v)
    return {"pool_k": pk, "pool_v": pv, "scale_k": sk, "scale_v": sv}


def hold_paged(torch, pa, q, pools, table, lens, *, window, splits, kv_format) -> float:
    """max |kernel - plain| of one paged call."""
    batch, heads, head_dim = q.shape
    kv_heads = pools["pool_k"].shape[2]
    out = pa.paged_attention(q, page_table=table, lens=lens, window=window, num_splits=splits,
                             **pools)
    ref = pa.paged_attention_reference(
        q.reshape(batch, kv_heads, heads // kv_heads, head_dim), pools["pool_k"],
        pools["pool_v"], table, lens, sm_scale=head_dim ** -0.5, window=window,
        num_splits=splits, scale_k=pools.get("scale_k"), scale_v=pools.get("scale_v"),
        kv_format=kv_format,
    ).reshape(out.shape)
    torch.cuda.synchronize()
    return (out.float() - ref.float()).abs().max().item()


def check_int4_bytes(torch, pa, quant) -> None:
    """The kernel's nibble unpack on all 256 byte values: with one live
    token, unit scales and float32 the output is V's row unpacked, exactly;
    with every byte value in K and V over the decode shape's pool the
    kernel agrees with the plain version."""
    dev = torch.device(DEVICE)
    every = (torch.arange(256, device=dev) - 128).to(torch.int8)
    pv = torch.zeros((5, 16, 2, 32), dtype=torch.int8, device=dev)
    pv[1:5, 0] = every.reshape(4, 2, 32)  # position 0 of pages 1..4
    ones = torch.ones((5, 16, 2), device=dev)
    out = pa.paged_attention(
        torch.zeros((4, 8, 64), device=dev), torch.zeros_like(pv), pv,
        torch.arange(1, 5, dtype=torch.int32, device=dev)[:, None],
        torch.ones(4, dtype=torch.int32, device=dev), scale_k=ones, scale_v=ones, num_splits=1,
    )
    want = quant.unpack_int4(pv[1:5, 0], torch.float32)[:, :, None].expand(4, 2, 4, 64)
    if not torch.equal(out.reshape(4, 2, 4, 64), want):
        fail("the int4 unpack on the card differs from unpack_int4 on some byte value")
    gen = torch.Generator(device=dev).manual_seed(7)
    B, H, HK, D, PS, MPP, P = 8, 16, 4, 64, 16, 32, 512
    codes = every[torch.randint(0, 256, (2, P, PS, HK, D // 2), generator=gen, device=dev)]
    scales = torch.rand((2, P, PS, HK), generator=gen, device=dev) * 0.2 + 0.01
    pools = {"pool_k": codes[0], "pool_v": codes[1], "scale_k": scales[0], "scale_v": scales[1]}
    q = torch.randn((B, H, D), generator=gen, device=dev)
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: B * MPP] + 1)
    lens = torch.tensor([1, 17, 100, 255, 256, 333, 480, 512], dtype=torch.int32, device=dev)
    err = hold_paged(torch, pa, q, pools, table.reshape(B, MPP).to(torch.int32), lens,
                     window=None, splits=8, kv_format="int4")
    log(f"int4 unpack: exact on all 256 bytes; every-byte pools f32 max_abs_err {err:.3e}")
    if not err <= TOL_F32:
        fail(f"paged_attention int4 over every byte value: {err} > {TOL_F32}")


def kernels_per_call(torch, dp, call, what: str) -> list[tuple[str, int]]:
    """(name, launches) of each device kernel that one ``call`` (already
    warm) runs, under torch.profiler; a window that traced nothing is
    profiled again, up to ``decode_profile.PROFILE_WINDOWS`` times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(dp.PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        top = dp.trace_stats(prof)["top"]
        if top:
            return [(row["kernel"], row["calls"]) for row in top]
    fail(f"{what}: the profiler traced no device kernel in {dp.PROFILE_WINDOWS} windows")


def check_paged(torch, pa, quant, tuning, dp):
    """Kernel 1 against its plain version in each pool format, and one
    device kernel per call; returns its kernel-line entries (float, int8,
    int4)."""
    dev = torch.device(DEVICE)
    B, H, HK, D, PS, MPP, P = 8, 16, 4, 64, 16, 32, 512
    gen = torch.Generator(device=dev).manual_seed(0)
    tuned = tuning.pick_num_splits(MPP, tuning.device_generation(dev))
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: B * MPP] + 1)
    table = table.reshape(B, MPP).to(torch.int32)
    ragged = torch.tensor([1, 17, 100, 255, 256, 333, 480, 512], dtype=torch.int32, device=dev)
    worst = dict.fromkeys(pa.FORMATS, 0.0)
    for kv_format in pa.FORMATS:
        for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
            q = torch.randn((B, H, D), generator=gen, device=dev).to(dtype)
            k, v = (torch.randn((P, PS, HK, D), generator=gen, device=dev) for _ in range(2))
            pools = quantized_pools(quant, kv_format, k, v, dtype)
            for splits in sorted({1, tuned}):
                for window in (None, 100):
                    err = hold_paged(torch, pa, q, pools, table, ragged, window=window,
                                     splits=splits, kv_format=kv_format)
                    log(f"paged {kv_format} {dtype} splits={splits} window={window}: "
                        f"max_abs_err {err:.3e} (tol {tol})")
                    if not err <= tol:
                        fail(f"paged_attention {kv_format} {dtype} splits={splits} "
                             f"window={window}: {err} > {tol}")
                    if dtype == torch.bfloat16:
                        worst[kv_format] = max(worst[kv_format], err)
            # One call is one kernel: the splits merge inside the launch.
            for splits in (1, tuning.MAX_SPLITS):
                ran = kernels_per_call(
                    torch, dp, lambda: pa.paged_attention(q, page_table=table, lens=ragged,
                                                          num_splits=splits, **pools),
                    f"paged {kv_format} {dtype} splits={splits}")
                log(f"paged {kv_format} {dtype} splits={splits}: one call ran {ran}")
                if len(ran) != 1 or ran[0][1] != 1 or "paged_decode_kernel" not in ran[0][0]:
                    fail(f"one paged_attention call ({kv_format}, {dtype}, {splits} splits) "
                         f"ran {ran}, not one paged_decode_kernel")
    check_int4_bytes(torch, pa, quant)
    # Timing at the main path's shapes: bf16 queries, pools as the engine
    # sizes them in each format, the tuned split count, lens spread over
    # the decode phase (prompt 128 plus up to 128 new tokens).  L2 is warm
    # between launches.  The latency floor: an empty kernel launched with
    # the same grid, block and cluster shape, timed the same way.
    floor_ms, _ = time_ms(lambda: pa.launch_empty(B, H, HK, tuned, dev))
    rows = []
    for kv_format in pa.FORMATS:
        inputs = dp.decode_inputs(kv_format)
        q, table_t, lens = inputs["q"], inputs["page_table"], inputs["lens"]
        ms, eager_ms = time_ms(lambda: pa.paged_attention(**inputs, num_splits=tuned))
        plain_ms, _ = time_ms(
            lambda: pa.paged_attention_reference(
                q.reshape(B, HK, H // HK, D), inputs["pool_k"], inputs["pool_v"], table_t, lens,
                sm_scale=D ** -0.5, window=None, num_splits=tuned,
                scale_k=inputs.get("scale_k"), scale_v=inputs.get("scale_v"),
                kv_format=kv_format,
            ),
            iters=20,
        )
        live = lens.long().tolist()
        pages_read = sum(-(-n // PS) for n in live)
        code_bytes = {"f": 2, "int8": 1, "int4": 0.5}[kv_format]  # per K or V element
        scale_bytes = 0 if kv_format == "f" else 4  # per (position, kv head) and pool
        nbytes = (
            2 * B * H * D * 2  # q in, out
            + sum(live) * HK * 2 * (D * code_bytes + scale_bytes)  # live K and V rows
            + pages_read * 4 + B * 4  # table entries and lens
        )
        flops = sum(4 * H * n * D for n in live)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        log(f"paged {kv_format} at the decode shape: {ms * 1e3:.3f} us (bound "
            f"{b_ms * 1e3:.3f} us by {b_by}, empty-launch floor {floor_ms * 1e3:.3f} us, "
            f"plain {plain_ms * 1e3:.1f} us)")
        rows.append({
            "name": "paged_attention" if kv_format == "f" else f"paged_attention_{kv_format}",
            "route": "cuda",
            "source": "k8s_device_plugin_tpu_torch/csrc/paged_attention.cu",
            "replaces": "k8s_device_plugin_tpu/ops/paged_attention.py:197",
            "kv_format": kv_format,
            "launches": None,
            "max_abs_err": worst[kv_format],
            "tolerance": TOL_BF16,
            "ms": ms,
            "eager_ms": eager_ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "bytes": nbytes,
            "floor_ms": floor_ms,
            "floor_note": "an empty kernel with the same grid, block and cluster shape, "
                          "timed by the same graph replay",
            "library_ms": None,
            "shape": f"B{B} H{H} Hk{HK} D{D} page{PS} mpp{MPP} splits{tuned} "
                     f"lens{live[0]}..{live[-1]} bf16 q, {kv_format} pools",
        })
    return rows


def sass_hgmma(lib) -> dict[str, int]:
    """HGMMA (wgmma) instructions per kernel in a built library's SASS."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            kernel = line.split("Function : ", 1)[1].strip()
            counts[kernel] = 0
        elif kernel is not None and "HGMMA" in line:
            counts[kernel] += 1
    return counts


# The flash kernels' rows in the kernel line, by (kernel, input type): (row
# name, the kernel's name as it appears in its mangled symbol).  Which
# source and design each runs is ops/flash_attention.py's VARIANTS.
FLASH_ROWS = {
    ("forward", "bfloat16"): ("flash_attention", "flash_fwd_wgmma_kernel"),
    ("forward", "float32"): ("flash_attention_fma", "flash_fwd_kernel"),
    ("dq", "bfloat16"): ("flash_attention_bwd_dq", "flash_bwd_dq_wgmma_kernel"),
    ("dq", "float32"): ("flash_attention_bwd_dq_fma", "flash_bwd_dq_kernel"),
    ("dkv", "bfloat16"): ("flash_attention_bwd_dkv", "flash_bwd_dkv_wgmma_kernel"),
    ("dkv", "float32"): ("flash_attention_bwd_dkv_fma", "flash_bwd_dkv_kernel"),
}


def build_facts(torch, fa, _build) -> dict:
    """Per flash kernel row, keyed as FLASH_ROWS: its name, source, design,
    and per build (``widths``: 64 and 128 wide, and padded at each,
    "pad64" and "pad128", for the head_dims between) its registers, spill
    bytes (ptxas) and HGMMA count (cuobjdump); the row's own registers,
    spills and HGMMA are the head_dim 64 build's, the main paths'.  Fails if
    a wgmma build spills or has no HGMMA, or an FMA build has any."""
    facts = {}
    for (kernel, dtype), (name, function) in FLASH_ROWS.items():
        var = fa.variant(kernel, getattr(torch, dtype))
        hgmma = sass_hgmma(_build.library_path(var.source))
        widths = {}
        for sym, regs in _build.ptxas_report(var.source).items():
            # <function><D, PAD> in the mangled name.
            m = re.search(function + r"ILi(\d+)ELb([01])E", sym)
            if m:
                widths[("pad" if m.group(2) == "1" else "") + m.group(1)] = {
                    "registers": regs["registers"],
                    "spill_bytes": regs["spill_stores"] + regs["spill_loads"],
                    "hgmma": hgmma.get(sym, 0),
                }
        built = {"64", "128", "pad64", "pad128"}
        if set(widths) != built:
            fail(f"csrc/{var.source}.cu builds {function} at head_dim {sorted(widths)}, "
                 f"not {sorted(built)}")
        fact = facts[(kernel, dtype)] = {
            "name": name,
            "route": "cuda",
            "source": f"k8s_device_plugin_tpu_torch/csrc/{var.source}.cu",
            "design": var.design,
            **widths["64"],
            "widths": widths,
        }
        log(f"{var.source} {function}: {fact}")
        for width, w in widths.items():
            if var.design == "wgmma" and (w["hgmma"] == 0 or w["spill_bytes"]):
                fail(f"{function} at head_dim {width}: {w['hgmma']} HGMMA, "
                     f"{w['spill_bytes']} spill bytes")
            if var.design == "fma" and w["hgmma"]:
                fail(f"{function} at head_dim {width} is the FMA variant but has "
                     f"{w['hgmma']} HGMMA")
    return facts


PAGED_FORMATS = {"0": "f", "1": "int8", "2": "int4"}


def paged_build_facts(_build) -> dict:
    """Kernel 1's registers and spill bytes (ptxas) per build, keyed by pool
    format, then "<query type>_<width>" (float32 or bf16 queries, 64 and 128
    wide: twelve builds).  Fails if one is missing or spills."""
    facts = {fmt: {} for fmt in PAGED_FORMATS.values()}
    for sym, regs in _build.ptxas_report("paged_attention").items():
        # paged_decode_kernel<T, FMT, D> in the mangled name.
        m = re.search(r"paged_decode_kernelI(f|13__nv_bfloat16)Li(\d)ELi(\d+)E", sym)
        if m:
            dtype = "float32" if m.group(1) == "f" else "bfloat16"
            facts[PAGED_FORMATS[m.group(2)]][f"{dtype}_{m.group(3)}"] = {
                "registers": regs["registers"],
                "spill_bytes": regs["spill_stores"] + regs["spill_loads"],
            }
    want = {f"{t}_{w}" for t in ("float32", "bfloat16") for w in (64, 128)}
    log(f"paged_attention paged_decode_kernel builds: {facts}")
    for fmt, builds in facts.items():
        if set(builds) != want:
            fail(f"csrc/paged_attention.cu builds the {fmt} kernel as {sorted(builds)}, "
                 f"not {sorted(want)}")
        for name, b in builds.items():
            if b["spill_bytes"]:
                fail(f"paged_decode_kernel {fmt} {name}: {b['spill_bytes']} spill bytes "
                     f"at {b['registers']} registers")
    return facts


def expect_designs(counts: dict, design: str, n: int, what: str) -> None:
    """Fail unless ``counts`` (launches by design) ran ``design`` n times
    and no other."""
    want = {d: (n if d == design else 0) for d in counts}
    if counts != want:
        fail(f"{what} launched {counts}, not {want}")


def check_flash(torch, fa, facts):
    """Kernel 2 against its plain version, both variants (bf16 wgmma, f32
    FMA); returns their kernel-line entries."""
    dev = torch.device(DEVICE)
    B, H, D = 8, 16, 64
    gen = torch.Generator(device=dev).manual_seed(1)
    types = (("bfloat16", TOL_BF16, BF16_FLOPS), ("float32", TOL_F32, FP32_FLOPS))
    worst = {"bfloat16": 0.0, "float32": 0.0}
    for dtype_name, tol, _ in types:
        dtype, design = getattr(torch, dtype_name), facts[("forward", dtype_name)]["design"]
        for s in (128, 200, 512, 1024):  # 200: ragged last q and kv tiles; 1024: training
            for group in (4, 1):
                hk = H // group
                q = torch.randn((B, H, s, D), generator=gen, device=dev).to(dtype)
                k = torch.randn((B, hk, s, D), generator=gen, device=dev).to(dtype)
                v = torch.randn((B, hk, s, D), generator=gen, device=dev).to(dtype)
                for causal, window in ((True, None), (True, 100), (False, None)):
                    fa.reset_launches()
                    out, lse = fa.flash_forward(q, k, v, causal=causal, window=window)
                    expect_designs(fa.flash_attention.launches_by_design, design, 1,
                                   f"flash_forward {dtype}")
                    ref, ref_lse = fa.flash_attention_reference(
                        q, k, v, causal=causal, sm_scale=D ** -0.5, window=window, block_kv=128
                    )
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    lerr = (lse - ref_lse).abs().max().item()
                    label = f"{dtype} s={s} group={group} causal={causal} window={window}"
                    log(f"flash {design} {label}: max_abs_err {err:.3e} (tol {tol}), "
                        f"lse {lerr:.3e}")
                    if not (err <= tol and lerr <= TOL_LSE):
                        fail(f"flash_attention {label}: out {err}, lse {lerr}")
                    worst[dtype_name] = max(worst[dtype_name], err)
    rows = []
    for dtype_name, tol, peak in types:
        dtype = getattr(torch, dtype_name)
        row = {
            **facts[("forward", dtype_name)],
            "replaces": "k8s_device_plugin_tpu/ops/flash_attention.py:218",
            "launches": None,
            "max_abs_err": worst[dtype_name],
            "tolerance": tol,
        }
        # Timing at the main path's shapes: greedy_generate's bulk prefill
        # (s 128, the row's own keys) and the training step (s 1024).
        for s in (128, 1024):
            q = torch.randn((B, H, s, D), generator=gen, device=dev).to(dtype)
            k = torch.randn((B, 4, s, D), generator=gen, device=dev).to(dtype)
            v = torch.randn((B, 4, s, D), generator=gen, device=dev).to(dtype)
            ms, eager_ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                                   iters=50 if s == 128 else 20)
            plain_ms, _ = time_ms(
                lambda: fa.flash_attention_reference(
                    q, k, v, causal=True, sm_scale=D ** -0.5, window=None, block_kv=128
                ),
                iters=20 if s == 128 else 5, warmup=2,
            )
            library_ms, _ = time_ms(sdpa_forward(torch, q, k, v), iters=20)
            pairs = B * H * s * (s + 1) // 2  # causal (row, col) pairs
            size = q.element_size()
            nbytes = (B * H * s * D * size) * 2 + (B * 4 * s * D * size) * 2 + B * H * s * 4
            b_ms, b_by = bound(nbytes, 4 * D * pairs, peak)
            timed = {"ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms}
            shape = f"b{B} h{H} hk4 s{s} d{D} causal {dtype_name}"
            if s == 128:
                row.update(timed, shape=shape)
            else:
                row.update({f"train_{key}": val for key, val in timed.items()}, train_shape=shape)
            log(f"flash {row['design']} at {shape}: {ms:.4f} ms (bound {b_ms:.4f}, "
                f"SDPA {library_ms:.4f}, plain {plain_ms:.4f})")
        rows.append(row)
    return rows


# Phase 3c's head_dims: the builds' own widths and a padded width of each
# (80: Phi-2's head_dim; 96: Phi-3-mini's).
PAGED_WIDTHS = (16, 32, 64, 80, 96, 128)
FLASH_WIDTHS = (16, 32, 80, 96, 128)


def check_widths(torch, pa, fa, quant, tuning) -> dict:
    """Phase 3c: kernel 1 at PAGED_WIDTHS and every page size it takes
    (1 to 128), in every pool format (bf16 queries), and kernels 2-4 at
    FLASH_WIDTHS in both variants, against their plain versions, each call
    checking the launch it counted.  Returns the worst errors by kernel."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(9)
    B, H, HK, SPAN = 8, 16, 4, 256  # SPAN: the positions a row's table covers
    lens = torch.tensor([1, 17, 100, 129, 200, 241, 255, 256], dtype=torch.int32, device=dev)
    worst = {}
    for d in PAGED_WIDTHS:
        for ps in pa.PAGE_SIZES:
            mpp, n_pool = SPAN // ps, B * SPAN // ps + 1
            table = torch.randperm(n_pool - 1, generator=gen, device=dev)[: B * mpp] + 1
            table = table.reshape(B, mpp).to(torch.int32)
            q = torch.randn((B, H, d), generator=gen, device=dev).to(torch.bfloat16)
            k, v = (torch.randn((n_pool, ps, HK, d), generator=gen, device=dev) for _ in range(2))
            tuned = tuning.pick_num_splits(mpp, tuning.device_generation(dev))
            for kv_format in pa.FORMATS:
                pools = quantized_pools(quant, kv_format, k, v, torch.bfloat16)
                for splits in sorted({1, tuned}):
                    for window in (None, 100):
                        pa.reset_launches()
                        err = hold_paged(torch, pa, q, pools, table, lens, window=window,
                                         splits=splits, kv_format=kv_format)
                        label = f"paged {kv_format} d={d} page={ps} splits={splits} window={window}"
                        if pa.paged_attention.launches_by_format[kv_format] != 1:
                            fail(f"{label}: launched {pa.paged_attention.launches_by_format}")
                        if not err <= TOL_BF16:
                            fail(f"{label}: max_abs_err {err} > {TOL_BF16}")
                        key = f"paged_{kv_format}"
                        worst[key] = max(worst.get(key, 0.0), err)
    log(f"paged kernel at head_dim {PAGED_WIDTHS} x page {pa.PAGE_SIZES} x {pa.FORMATS}: "
        f"worst {worst}")
    B = 2
    for d in FLASH_WIDTHS:
        for dtype_name, tol, tol_bwd in (("bfloat16", TOL_BF16, TOL_BWD_BF16),
                                         ("float32", TOL_F32, TOL_BWD_F32)):
            dtype = getattr(torch, dtype_name)
            design = fa.variant("forward", dtype).design
            for s in (128, 200):
                q, dout = (torch.randn((B, H, s, d), generator=gen, device=dev).to(dtype)
                           for _ in range(2))
                k, v = (torch.randn((B, HK, s, d), generator=gen, device=dev).to(dtype)
                        for _ in range(2))
                for causal, window in ((True, None), (True, 100), (False, None)):
                    label = f"flash {dtype_name} d={d} s={s} causal={causal} window={window}"
                    fa.reset_launches()
                    out, lse = fa.flash_forward(q, k, v, causal=causal, window=window)
                    got = fa.flash_backward(q, k, v, out, lse, dout, causal=causal, window=window)
                    expect_designs(fa.flash_attention.launches_by_design, design, 1, label)
                    expect_designs(fa.flash_backward.dq_launches_by_design, design, 1, label)
                    expect_designs(fa.flash_backward.dkv_launches_by_design, design, 1, label)
                    opts = dict(causal=causal, sm_scale=d ** -0.5, window=window, block_kv=128)
                    ref, ref_lse = fa.flash_attention_reference(q, k, v, **opts)
                    want = fa.flash_attention_backward_reference(q, k, v, out, lse, dout, **opts)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    lerr = (lse - ref_lse).abs().max().item()
                    rels = [rel_err(g, w) for g, w in zip(got, want)]
                    if not (err <= tol and lerr <= TOL_LSE and max(rels) <= tol_bwd):
                        fail(f"{label}: out {err}, lse {lerr}, dq/dk/dv rel {rels}")
                    for key, e in ((f"forward_{dtype_name}", err),
                                   (f"backward_rel_{dtype_name}", max(rels))):
                        worst[key] = max(worst.get(key, 0.0), e)
    log(f"kernels 1-4 at every head_dim: worst {worst}")
    return worst


def time_head_dim(torch, pa, fa, dp, tuning, D: int) -> dict:
    """Kernels 1-4 at head_dim D in bf16, timed as the head_dim 64 rows
    are (kernel 1 at the decode shape, kernels 2-4 at b8 h16 hk4 s1024
    causal), beside their bounds, plain versions and library calls; keyed
    by kernel row name."""
    B, H, HK = 8, 16, 4
    out = {}
    inputs = dp.decode_inputs("f", head_dim=D)
    tuned = tuning.pick_num_splits(inputs["page_table"].shape[1], tuning.device_generation(DEVICE))
    q, table, lens = inputs["q"], inputs["page_table"], inputs["lens"]
    ms, _ = time_ms(lambda: pa.paged_attention(**inputs, num_splits=tuned))
    plain_ms, _ = time_ms(lambda: pa.paged_attention_reference(
        q.reshape(B, HK, H // HK, D), inputs["pool_k"], inputs["pool_v"], table, lens,
        sm_scale=D ** -0.5, window=None, num_splits=tuned), iters=20)
    live = lens.long().tolist()
    ps = inputs["pool_k"].shape[1]
    nbytes = 2 * B * H * D * 2 + sum(live) * HK * 2 * D * 2 + sum(-(-n // ps) for n in live) * 4
    b_ms, b_by = bound(nbytes, sum(4 * H * n * D for n in live), BF16_FLOPS)
    out["paged_attention"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                              "library_ms": None,
                              "shape": f"B{B} H{H} Hk{HK} D{D} page{ps} splits{tuned} "
                                       f"lens{live[0]}..{live[-1]} bf16"}
    S = 1024
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    q, dout = (torch.randn((B, H, S, D), generator=gen, device=DEVICE).to(torch.bfloat16)
               for _ in range(2))
    k, v = (torch.randn((B, HK, S, D), generator=gen, device=DEVICE).to(torch.bfloat16)
            for _ in range(2))
    opts = dict(causal=True, sm_scale=D ** -0.5, window=None)
    o, lse = fa.flash_forward(q, k, v, causal=True)
    _, delta = fa.launch_dq(q, k, v, o, lse, dout, **opts)
    pairs = B * H * S * (S + 1) // 2
    row_q, row_kv, vec = B * H * S * D * 2, B * HK * S * D * 2, B * H * S * 4
    plain_bwd, _ = time_ms(lambda: fa.flash_attention_backward_reference(
        q, k, v, o, lse, dout, block_kv=128, **opts), iters=3, warmup=1)
    sdpa_bwd = profiled_ms(torch, sdpa_backward(torch, q, k, v, dout), f"SDPA's backward (d{D})")
    shape = f"b{B} h{H} hk{HK} s{S} d{D} causal bfloat16"
    cases = {
        "flash_attention": (lambda: fa.flash_forward(q, k, v, causal=True),
                            2 * row_q + 2 * row_kv + vec, 4 * D * pairs),
        "flash_attention_bwd_dq": (lambda: fa.launch_dq(q, k, v, o, lse, dout, **opts),
                                   4 * row_q + 2 * vec + 2 * row_kv, 6 * D * pairs),
        "flash_attention_bwd_dkv": (lambda: fa.launch_dkv(q, k, v, lse, delta, dout, **opts),
                                    2 * row_q + 2 * vec + 4 * row_kv, 8 * D * pairs),
    }
    for name, (call, nbytes, flops) in cases.items():
        ms, _ = time_ms(call, iters=20)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        if name == "flash_attention":
            plain_ms, _ = time_ms(lambda: fa.flash_attention_reference(
                q, k, v, block_kv=128, **opts), iters=3, warmup=1)
            library_ms, _ = time_ms(sdpa_forward(torch, q, k, v), iters=20)
        else:
            plain_ms, library_ms = plain_bwd, sdpa_bwd
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library_ms, "shape": shape}
    log(f"kernels 1-4 at head_dim {D}: {out}")
    return out


def run_engine(torch, engine, pa, fa, flags=()):
    """Phases 4 and 4b: the batch engine at full width with the extra
    ``flags``; returns (summary, paged launches by pool format)."""
    args = engine.parse_args([
        "--hidden=1024", "--layers=8", "--heads=16", "--kv-heads=4", "--vocab=32000",
        "--page-size=16", "--num-pages=512", "--max-pages-per-seq=32", "--slots=8",
        "--requests=32", "--prompt-len=128", "--max-new=128", f"--device={DEVICE}", *flags,
    ])
    pa.reset_launches()
    fa.reset_launches()
    summary, done = engine.benchmark(args)
    torch.cuda.synchronize()
    launches = dict(pa.paged_attention.launches_by_format)
    log(f"engine {list(flags)}: {summary}; paged launches {launches}, "
        f"flash launches {fa.flash_attention.launches}")
    want, other = ("int8", "f") if "--quant-kv" in flags else ("f", "int8")
    if launches[want] <= 0 or launches[other] or launches["int4"]:
        fail(f"the engine's decode {list(flags)} launched the paged kernel as {launches}, "
             f"not in its {want} branch alone")
    # Once per layer on every single-token step dispatched, eager or
    # replayed in a graph (a replay counts what its capture launched).
    if launches[want] != args.layers * summary["device_steps"]:
        fail(f"the engine {list(flags)} counted {launches[want]} paged launches over "
             f"{summary['device_steps']} dispatched steps of {args.layers} layers")
    if len(done) != 32 or any(len(r.tokens) != 128 for r in done):
        fail("the engine did not return 32 requests of 128 tokens")
    if any(not 0 <= t < 32000 for r in done for t in r.tokens):
        fail("the engine emitted a token id outside the vocabulary")
    # The summary's quantiles interpolate histogram buckets; these are exact
    # over the timed requests' own stamps (ITL as each request's mean gap).
    ttft = [r.first_token_at - r.submitted_at for r in done]
    itl = [(r.finished_at - r.first_token_at) / (len(r.tokens) - 1) for r in done]
    summary["ttft_exact_ms"] = {"p50": quantile(ttft, 0.5) * 1e3, "p99": quantile(ttft, 0.99) * 1e3}
    summary["itl_request_mean_ms"] = {"p50": quantile(itl, 0.5) * 1e3, "p99": quantile(itl, 0.99) * 1e3}
    summary["flags"] = list(flags)
    return summary, launches, [r.tokens for r in done]


SYNC_EAGER = ("--decode-block=1", "--overlap-steps=0", "--cuda-graphs=0")
BLOCKS = ("--decode-block=16", "--overlap-steps=1")  # CUDA graphs: the card's default
SAMPLED = ("--temperature=0.8", "--top-k=50")


def first_difference(a, b) -> str:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            j = next(j for j, (u, w) in enumerate(zip(x, y)) if u != w)
            return f"request {i} token {j}: {x[j]} vs {y[j]}"
    return "the request counts differ"


# ------------------------------------------------------------- phase 4e

# The deployment's serving flags (deploy/k8s-deploy-serve-http.yaml) minus
# the KV-tier ones the port refuses (--kv-retain, --kv-host-cache-mb,
# --snapshot-*); vocab is the CLI's default 32000.
SERVE_FLAGS = (
    "--hidden=1024", "--layers=8", "--heads=16", "--kv-heads=4", "--page-size=16",
    "--num-pages=512", "--max-pages-per-seq=32", "--slots=8", "--decode-block=16",
    "--admission=optimistic", "--prefill-chunk=256", "--overload=1",
    "--overload-target-wait=0.5", "--overload-max-queue=512", "--slo=1",
    "--watchdog=1", "--watchdog-min-deadline=5", "--watchdog-grace=120",
    "--dump-budget-mb=256",
)
# What phase 4e adds to them: an ephemeral port, and a flight ring big
# enough that no preemption event of the run is dropped.
SERVE_EXTRA = ("--http-port=0", "--flight-ring=65536")
SERVE_STREAMED = 8  # of the 32 requests; the other 24 are unary


def http_call(port: int, path: str, payload=None, timeout: float = 300.0):
    """(status, parsed JSON or raw bytes) of one request to the server."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"},
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body, status, ctype = resp.read(), resp.status, resp.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        body, status, ctype = e.read(), e.code, e.headers.get("Content-Type", "")
    return status, json.loads(body) if "json" in ctype else body


def start_server(flags, log_path, env) -> tuple:
    """Start the port's HTTP server as a subprocess; returns (process,
    port) once /healthz answers 200.  Fails (killing it) if it exits or
    does not come up in 600 s."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_device_plugin_tpu_torch.models.http_server", *flags,
         *SERVE_EXTRA],
        stdout=subprocess.DEVNULL, stderr=open(log_path, "w"), env=env,
    )
    deadline, port = time.monotonic() + 600, None
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            fail(f"the HTTP server exited with {proc.returncode}: "
                 f"{open(log_path).read()[-3000:]}")
        if port is None:
            m = re.search(r"serving on :(\d+)", open(log_path).read())
            port = int(m.group(1)) if m else None
        if port is not None:
            try:
                if http_call(port, "/healthz", timeout=5)[0] == 200:
                    return proc, port
            except OSError:
                pass
        time.sleep(0.2)
    proc.kill()
    fail(f"the HTTP server did not come up: {open(log_path).read()[-3000:]}")


def stop_server(proc, log_path) -> float:
    """SIGTERM: the server must drain and exit 0; returns the seconds it
    took."""
    import signal

    t0 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail("the HTTP server did not exit within 120 s of SIGTERM")
    if rc != 0:
        fail(f"the HTTP server exited {rc} after SIGTERM: {open(log_path).read()[-3000:]}")
    if "draining" not in open(log_path).read():
        fail("the HTTP server did not drain on SIGTERM")
    return time.perf_counter() - t0


def http_traffic(port: int, jobs, payload_kw=None) -> tuple:
    """Send ``jobs`` from one client thread each, at once: the first
    SERVE_STREAMED streamed (SSE), the rest unary.  Returns (results in
    job order, wall seconds); a result holds the status, tokens, rid and
    its client-side stamps (send, first token and each token for a
    stream, the answer for a unary request)."""
    import threading
    import urllib.request

    results = [None] * len(jobs)

    def one(i, prompt, n):
        body = {"prompt": prompt, "max_new_tokens": n, **(payload_kw or {})}
        t0 = time.perf_counter()
        if i >= SERVE_STREAMED:
            status, out = http_call(port, "/generate", body)
            ok = status == 200
            results[i] = {"status": status, "t_send": t0, "t_done": time.perf_counter(),
                          "tokens": out.get("tokens") if ok else None,
                          "rid": out.get("rid") if ok else None, "body": out}
            return
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate", data=json.dumps({**body, "stream": True}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        stamps, final = [], None
        with urllib.request.urlopen(req, timeout=600) as resp:
            for raw in resp:
                line = raw.decode().strip()
                if not line.startswith("data: "):
                    continue
                ev = json.loads(line[len("data: "):])
                if "token" in ev:
                    stamps.append(time.perf_counter())
                if ev.get("done") or ev.get("error"):
                    final = ev
                    break
        results[i] = {"status": 200 if final and final.get("done") else 500, "t_send": t0,
                      "t_done": time.perf_counter(), "stamps": stamps,
                      "tokens": (final or {}).get("tokens"), "rid": (final or {}).get("rid"),
                      "body": final}

    threads = [threading.Thread(target=one, args=(i, p, n)) for i, (p, n) in enumerate(jobs)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    bad = [(i, r["status"], r["body"]) for i, r in enumerate(results) if r["status"] != 200]
    if bad:
        fail(f"HTTP requests failed: {bad[:4]}")
    return results, wall


def client_latency(results, wall: float) -> dict:
    """Client-side tokens/s over the run, TTFT (the streams' first token)
    and ITL (the streams' token gaps) quantiles in ms, and the unary
    requests' answer time."""
    streams = [r for r in results if "stamps" in r]
    ttft = [r["stamps"][0] - r["t_send"] for r in streams]
    itl = [b - a for r in streams for a, b in zip(r["stamps"], r["stamps"][1:])]
    unary = [r["t_done"] - r["t_send"] for r in results if "stamps" not in r]
    tokens = sum(len(r["tokens"]) for r in results)
    return {
        "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
        "ttft_ms": {"p50": quantile(ttft, 0.5) * 1e3, "p99": quantile(ttft, 0.99) * 1e3},
        "itl_ms": {"p50": quantile(itl, 0.5) * 1e3, "p99": quantile(itl, 0.99) * 1e3},
        "unary_answer_ms": {"p50": quantile(unary, 0.5) * 1e3, "p99": quantile(unary, 0.99) * 1e3},
        "streams": len(streams), "unary": len(unary),
    }


def engine_latency(done, wall: float) -> dict:
    """The same numbers for an in-process run, from the requests' own
    stamps (ITL as each request's mean gap: a block lands its tokens at
    once)."""
    tokens = sum(len(r.tokens) for r in done)
    ttft = [r.first_token_at - r.submitted_at for r in done]
    itl = [(r.finished_at - r.first_token_at) / (len(r.tokens) - 1) for r in done]
    # The requests the HTTP run streams, and those it sends unary: the
    # same populations as client_latency's.
    ttft_streamed = ttft[:SERVE_STREAMED]
    answer = [r.finished_at - r.submitted_at for r in done[SERVE_STREAMED:]]
    return {
        "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
        "ttft_ms": {"p50": quantile(ttft, 0.5) * 1e3, "p99": quantile(ttft, 0.99) * 1e3},
        "itl_ms": {"p50": quantile(itl, 0.5) * 1e3, "p99": quantile(itl, 0.99) * 1e3},
        "ttft_streamed_jobs_ms": {"p50": quantile(ttft_streamed, 0.5) * 1e3,
                                  "p99": quantile(ttft_streamed, 0.99) * 1e3},
        "unary_jobs_answer_ms": {"p50": quantile(answer, 0.5) * 1e3,
                                 "p99": quantile(answer, 0.99) * 1e3},
    }


def profile_delta(before: dict, after: dict, admission: dict) -> dict:
    """What ``/debug/profile`` (engine_profiler.snapshot) accrued between
    two reads: steps, tokens and seconds per phase, plus the overload
    limiter's state at the second read."""
    return {
        "steps": after["steps"] - before["steps"],
        "tokens": after["tokens"] - before["tokens"],
        "phase_s": {ph: after["phases"][ph]["total_s"] - before["phases"][ph]["total_s"]
                    for ph in after["phases"]},
        "limit": {k: admission[k] for k in ("limit", "limit_decreases", "limit_increases")},
    }


def lint_metrics(port: int) -> None:
    """/metrics must pass tools/metrics_lint.py."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent / "tools" / "metrics_lint.py"
    spec = importlib.util.spec_from_file_location("metrics_lint", path)
    lint = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lint)
    errors = lint.lint_url(f"http://127.0.0.1:{port}/metrics")
    if errors:
        fail(f"/metrics fails tools/metrics_lint.py: {errors[:5]}")


def warm_up(port: int, jobs) -> float:
    """What the in-process twin's warm-up runs, over HTTP: the first two
    prompts for 32 tokens, unary, one after the other, so the first
    launches, the prefill bucket and every block's CUDA graph are behind
    the measured traffic.  One at a time: a request queued behind a cold
    server's first step (seconds) would feed that wait to the overload
    limiter, which would cut the measured run's concurrency for it.
    Returns the seconds until both answered."""
    t0 = time.perf_counter()
    for prompt, _ in jobs[:2]:
        status, body = http_call(port, "/generate", {"prompt": prompt, "max_new_tokens": 32})
        if status != 200:
            fail(f"warm-up request failed: {status} {body}")
    return time.perf_counter() - t0


def serve_once(flags, jobs, log_path, env, sampled: bool) -> dict:
    """One server run: a warm-up, greedy traffic over HTTP, optionally the
    sampled requests, the debug reads, the launch accounting, then
    SIGTERM."""
    proc, port = start_server(flags, log_path, env)
    try:
        cold_s = warm_up(port, jobs)
        limit0 = http_call(port, "/debug/admission")[1]["limit"]
        prof0 = http_call(port, "/debug/profile")[1]
        results, wall = http_traffic(port, jobs)
        out = {"results": results, "client": client_latency(results, wall),
               "cold_warm_up_s": cold_s, "limit_at_start": limit0,
               "traffic_profile": profile_delta(prof0, http_call(port, "/debug/profile")[1],
                                                http_call(port, "/debug/admission")[1])}
        if sampled:
            # 8 sampled requests (n=2 is unary only), concurrently.
            import threading

            answers = [None] * 8

            def one(i):
                p, n = jobs[i]
                answers[i] = http_call(port, "/generate", {
                    "prompt": p, "max_new_tokens": n, "temperature": 0.8, "top_k": 50,
                    "n": 2, "logprobs": True})

            ts = [threading.Thread(target=one, args=(i,)) for i in range(len(answers))]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            for status, body in answers:
                if status != 200:
                    fail(f"sampled request answered {status}: {body}")
                for choice in body["choices"]:
                    lps = choice["logprobs"]
                    if len(lps) != len(choice["tokens"]) or not all(
                            math.isfinite(x) and x <= 0.0 for x in lps):
                        fail(f"sampled logprobs not finite and <= 0: {lps[:8]}")
            out["sampled"] = {"requests": len(answers), "choices": 2 * len(answers),
                              "all_logprobs_finite_and_nonpositive": True}
        status, out["summary"] = http_call(port, "/debug/state?summary=1")
        status, out["profile"] = http_call(port, "/debug/profile")
        status, out["admission"] = http_call(port, "/debug/admission")
        status, state = http_call(port, "/debug/state")
        status, flight = http_call(port, "/debug/flight")
        lint_metrics(port)
    except BaseException:
        proc.kill()
        raise
    out["drain_s"] = stop_server(proc, log_path)
    eng = state["engine"]
    dev = eng["device"]
    out["preemptions"] = eng["preemptions"]
    out["device"] = dev
    launches = dev["paged_launches"]["f"]
    if launches != dev["num_layers"] * dev["device_steps"] or launches <= 0:
        fail(f"the server counted {launches} paged launches over {dev['device_steps']} "
             f"dispatched steps of {dev['num_layers']} layers")
    preempt = {}
    for ev in flight["events"]:
        if ev["kind"] == "engine.preempt":
            preempt[ev["rid"]] = min(preempt.get(ev["rid"], 1 << 30), ev["generated"])
    out["preempted_at"] = preempt
    out["flight_dropped"] = flight["dropped"]
    return out


def run_serve(torch, tf, http_server, smi, phase_4d: dict) -> dict:
    """Phase 4e: the port's HTTP server as the deployment runs it, on the
    card, at full width: phase 4d's traffic over HTTP (greedy tokens
    equal to an in-process engine built from the same flags), 8 sampled
    requests with logprobs, the debug reads, /metrics linted, the launch
    accounting, and a drain on SIGTERM; then again at 96 pages, where
    optimistic admission preempts; and GPTConfig.tiny() in float32 in
    process, where preempted streams must equal unpreempted ones in full."""
    import os
    import pathlib

    from k8s_device_plugin_tpu_torch.models.engine import synthetic_jobs

    root = pathlib.Path(__file__).resolve().parent
    out_dir = root / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(root))
    jobs = synthetic_jobs(32, 128, 128, 32000)

    # The in-process twin: the same flags, weights and traffic.
    args = http_server.parse_args([*SERVE_FLAGS, f"--device={DEVICE}"])
    eng = http_server.build_engine(args)
    eng.run([(p, 32) for p, _ in jobs[:2]])  # warm: kernels, graphs, buckets
    prof0 = eng.profiler.snapshot()
    t0 = time.perf_counter()
    done = eng.run(jobs)
    torch.cuda.synchronize()
    inproc = engine_latency(done, time.perf_counter() - t0)
    inproc["preemptions"] = eng.preemptions
    inproc["traffic_profile"] = profile_delta(prof0, eng.profiler.snapshot(),
                                              eng.overload.snapshot())
    want = [r.tokens for r in done]
    del eng, done
    torch.cuda.empty_cache()
    log(f"phase 4e in-process twin: {inproc}")

    full = serve_once(SERVE_FLAGS, jobs, out_dir / "serve_512.log", env, sampled=True)
    got = [r["tokens"] for r in full["results"]]
    if got != want:
        fail(f"HTTP greedy tokens differ from the in-process engine's at "
             f"{first_difference(got, want)}")
    if full["preemptions"]:
        log(f"the 512-page run preempted {full['preemptions']} times")
    log(f"phase 4e 512 pages: client {full['client']}, preemptions {full['preemptions']}")

    small_flags = tuple(f for f in SERVE_FLAGS if not f.startswith("--num-pages")) + (
        "--num-pages=96",)
    small = serve_once(small_flags, jobs, out_dir / "serve_96.log", env, sampled=False)
    # Preemption does not hang on timing: the limiter only cuts on queue
    # waits past its setpoint, which the first wave (admitted as it
    # arrives, at the full limit the serial warm-up leaves) does not have,
    # and any 8 of the jobs need more pages than the pool holds: the 8
    # that share a prefix need the fewest.
    demand = first_wave_pages(jobs[0::2][:8], page_size=16)
    small["first_wave_pages"] = demand
    if small["limit_at_start"] < 8:
        fail(f"the warm-up left the 96-page server's limiter at {small['limit_at_start']}, "
             f"not 8")
    if demand <= 95:
        fail(f"the first wave needs {demand} pages, which 95 allocatable pages hold")
    if small["preemptions"] <= 0:
        fail(f"the 96-page server never preempted (the first wave needs {demand} of 95 "
             f"pages)")
    if any(len(r["tokens"]) != n for r, (_, n) in zip(small["results"], jobs)):
        fail("a request on the 96-page server did not end with its 128 tokens")
    # Both runs served the same 32 jobs: compare by job index (a server's
    # rids are its own), with each 96-page request's first preemption
    # point from that server's flight recorder.
    divergence = {}
    for i, (a, b) in enumerate(zip(small["results"], full["results"])):
        at = small["preempted_at"].get(a["rid"])
        if at is None:
            if a["tokens"] != b["tokens"]:
                fail(f"request {i} was never preempted at 96 pages but differs from the 512-page "
                     f"run at {first_difference([a['tokens']], [b['tokens']])}")
            continue
        if a["tokens"][:at] != b["tokens"][:at]:
            fail(f"request {i} differs from the 512-page run before its preemption at {at}")
        diff = next((j for j, (x, y) in enumerate(zip(a["tokens"], b["tokens"])) if x != y), None)
        divergence[i] = {"preempted_at": at, "first_difference": diff}
    log(f"phase 4e 96 pages: client {small['client']}, preemptions {small['preemptions']}, "
        f"preempted requests {divergence}")

    tiny = run_tiny_preemption(torch, tf)
    keep = ("client", "cold_warm_up_s", "limit_at_start", "traffic_profile", "preemptions",
            "drain_s", "device", "flight_dropped")
    report = {
        "card": smi,
        "flags": list(SERVE_FLAGS),
        "in_process": inproc,
        "phase_4d_in_process": {
            "flags": phase_4d["flags"], "tokens_per_s": phase_4d["value"],
            "ttft_ms": phase_4d["ttft_exact_ms"], "itl_ms": phase_4d["itl_request_mean_ms"],
        },
        "http_512": {k: full[k] for k in keep},
        "http_96": {k: small[k] for k in keep},
        "preempted_96": divergence,
        "first_wave_pages_96": demand,
        "sampled": full["sampled"],
        "summary_512": full["summary"],
        "admission_512": full["admission"],
        "profile_512": full["profile"],
        "profile_96": small["profile"],
        "admission_96": small["admission"],
        "tiny_f32": tiny,
    }
    return report


def first_wave_pages(jobs, page_size: int) -> int:
    """Pages ``jobs`` hold together once each has its every token: each
    prompt's whole pages shared with an earlier job's (the prefix trie)
    counted once."""
    seen, pages = set(), 0
    for prompt, n in jobs:
        total = -(-(len(prompt) + n) // page_size)
        shared = 0
        for i in range(len(prompt) // page_size):
            key = tuple(prompt[: (i + 1) * page_size])
            if key not in seen:
                break
            shared += 1
        seen.update(tuple(prompt[: (i + 1) * page_size]) for i in range(len(prompt) // page_size))
        pages += total - shared
    return pages


def run_tiny_preemption(torch, tf) -> dict:
    """GPTConfig.tiny() in float32 on the card: optimistic admission on a
    pool that preempts must return, in full, the streams of a pool that
    does not (block 16, overlap, CUDA graphs)."""
    from k8s_device_plugin_tpu_torch.models.engine import ServingEngine

    cfg = tf.GPTConfig.tiny()
    params = tf.init_params(cfg, seed=3)
    gen = torch.Generator().manual_seed(4)
    jobs = [(torch.randint(1, 512, (8 + 3 * i,), generator=gen).tolist(), 40 + 4 * i)
            for i in range(8)]
    streams, pre = [], []
    for pages in (200, 36):
        eng = ServingEngine(cfg, params, tf.PagedConfig(4, pages, 32), max_slots=4,
                            decode_block=16, overlap_steps=1, admission="optimistic",
                            device=DEVICE)
        streams.append([r.tokens for r in eng.run(jobs)])
        pre.append(eng.preemptions)
    if pre[1] <= 0 or pre[0]:
        fail(f"tiny float32: preemptions {pre} (want 0 on 200 pages, > 0 on 36)")
    if streams[1] != streams[0]:
        fail(f"tiny float32: preempted streams differ at {first_difference(streams[1], streams[0])}")
    log(f"tiny float32 preemption: {pre[1]} preemptions, streams identical")
    return {"preemptions": pre[1], "requests": len(jobs), "identical": True}


def run_blocks(torch, engine, pa, fa, dp, sync_tokens) -> dict:
    """Phase 4d: the full-width engine at decode block 16 with the overlap
    round and CUDA graphs must return phase 4's greedy tokens exactly,
    discard overlapped rounds at the finishes and replay graphs; sampled
    (temperature 0.8, top-k 50) it must repeat itself under one rng with
    graphs on and off.  Then decode_profile's step wall against device
    time per token at block 1 (synchronous and eager, then overlapped and
    graphed) and at block 16."""
    greedy, launches, tokens = run_engine(torch, engine, pa, fa, BLOCKS)
    if tokens != sync_tokens:
        fail(f"block 16 with overlap and graphs differs from phase 4's greedy tokens at "
             f"{first_difference(tokens, sync_tokens)}")
    if greedy["overlap_discards"] <= 0 or greedy["graph_replays"] <= 0:
        fail(f"block 16 run: {greedy['overlap_discards']} discards, "
             f"{greedy['graph_replays']} graph replays")
    sampled = {}
    for graphs in (1, 0):
        summary, _, stream = run_engine(torch, engine, pa, fa,
                                        BLOCKS + SAMPLED + (f"--cuda-graphs={graphs}",))
        sampled[graphs] = (summary, stream)
    if sampled[1][1] != sampled[0][1]:
        fail(f"sampled block 16 streams differ with graphs on and off at "
             f"{first_difference(sampled[1][1], sampled[0][1])}")
    if sampled[1][1] == tokens:
        fail("the sampled run returned the greedy tokens")
    profiles = {}
    for name, flags, steps in (
        ("block1_sync_eager", SYNC_EAGER, 16),
        ("block1_overlap_graphs", ("--decode-block=1", "--overlap-steps=1"), 16),
        ("block16_overlap_graphs", BLOCKS, 8),  # 8 blocks: 128 tokens a row, twice
    ):
        prof = dp.profile_decode(steps, flags)
        profiles[name] = {key: prof[key] for key in (
            "flags", "steps", "tokens", "step_ms", "wall_ms_per_token", "device_ms_per_step",
            "device_ms_per_token", "busy_share", "unprofiled_step_ms",
            "unprofiled_wall_ms_per_token", "paged_launches", "top")}
        log(f"decode profile {name}: {profiles[name]}")
    return {"greedy": greedy, "paged_launches": launches["f"],
            "sampled_graphs": sampled[1][0], "sampled_eager": sampled[0][0],
            "decode_profile": profiles}


def quantile(values, q: float) -> float:
    """Linear-interpolated q-quantile of ``values``."""
    xs = sorted(values)
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def run_generate(torch, tf, pa, fa):
    """Phase 5: greedy_generate at full width; returns flash launches."""
    cfg = tf.GPTConfig(
        vocab_size=32000, hidden_size=1024, num_layers=8, num_heads=16,
        intermediate_size=3072, max_seq=512, num_kv_heads=4,
    )
    params = tf.init_params(cfg, seed=0)
    prompt = torch.randint(0, 32000, (8, 128), generator=torch.Generator().manual_seed(2))
    pa.reset_launches()
    fa.reset_launches()
    t0 = time.perf_counter()
    out = tf.greedy_generate(cfg, params, prompt, 32, device=DEVICE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    log(f"greedy_generate: {tuple(out.shape)} in {dt:.3f}s; flash launches "
        f"{fa.flash_attention.launches_by_design}")
    if launches <= 0:
        fail("greedy_generate's bulk prefill never launched the flash kernel")
    expect_designs(fa.flash_attention.launches_by_design, "wgmma", launches,
                   "greedy_generate's bf16 prefill")
    if tuple(out.shape) != (8, 160) or not torch.equal(out[:, :128].cpu(), prompt):
        fail(f"greedy_generate returned {tuple(out.shape)} or altered the prompt")
    if int(out.min()) < 0 or int(out.max()) >= 32000:
        fail("greedy_generate emitted a token id outside the vocabulary")
    return launches


def check_paths_agree(torch, tf, engine, cfg=None, page=(16, 512, 32), prompt_len=64,
                      **quant_kw):
    """Phases 6 and 6b: fp32, 2 layers, full width (``quant_kw`` sets the
    weight and KV formats), or ``cfg`` at the paged geometry ``page`` (6:
    GPTConfig.tiny(), head_dim 16, at page 4): kernel path == gather path
    wherever the top-2 margin of the reference decode clears TOL_MARGIN."""
    if cfg is None:
        cfg = tf.GPTConfig(
            vocab_size=32000, hidden_size=1024, num_layers=2, num_heads=16,
            intermediate_size=3072, max_seq=512, num_kv_heads=4, dtype=torch.float32,
            **quant_kw,
        )
    params = tf.init_params(cfg, seed=3)
    jobs = engine.synthetic_jobs(8, prompt_len, 16, cfg.vocab_size)
    streams = {}
    for use_kernel in (None, False):
        paged = tf.PagedConfig(*page, use_kernel=use_kernel)
        eng = engine.ServingEngine(cfg, params, paged, max_slots=8, device=DEVICE)
        streams[use_kernel] = [r.tokens for r in eng.run(jobs)]
    model = eng.model
    checked = ties = 0
    for (prompt, _), a, b in zip(jobs, streams[None], streams[False]):
        for j, (x, y) in enumerate(zip(a, b)):
            checked += 1
            if x == y:
                continue
            with torch.no_grad():
                # The cached append over the whole sequence: each position
                # attends over the (dequantized) cache as a decode step does.
                ids = torch.tensor([prompt + a[:j]], device=DEVICE)
                cache = tf.DenseCache.zeros(cfg, 1, DEVICE, max_seq=ids.shape[1])
                top2 = model(ids, cache=cache, append_mode="cached")[0, -1].topk(2).values
            margin = float(top2[0] - top2[1])
            if margin >= TOL_MARGIN:
                fail(f"kernel and gather paths disagree at token {j} with margin {margin}")
            ties += 1
            break  # past a near-tie the two streams legitimately differ
    log(f"fp32 {quant_kw or 'float'} head_dim {cfg.head_dim} page {page[0]}: paths agree on "
        f"{checked} tokens ({ties} near-ties)")
    return {"checked": checked, "near_ties": ties}


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in float32."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def sdpa_forward(torch, q, k, v):
    """A call of SDPA's causal forward on these inputs (the yardstick,
    never called by the port)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        sdpa(q, k, v, is_causal=True, enable_gqa=True)
        return lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)
    except TypeError:  # a PyTorch without enable_gqa: expanded kv
        group = q.shape[1] // k.shape[1]
        ke, ve = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
        return lambda: sdpa(q, ke, ve, is_causal=True)


def profiled_ms(torch, fn, what: str, iters: int = 10, warmup: int = 3) -> float:
    """Device time per call of ``fn`` (``decode_profile.profiled_device_us``).
    SDPA's backward is timed this way because a CUDA graph cannot capture
    its ``autograd.grad`` here; the backward kernels are timed the same way
    beside it, so the two compare by one method."""
    from k8s_device_plugin_tpu_torch.decode_profile import profiled_device_us

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    try:
        return profiled_device_us(fn, iters) / 1e3
    except RuntimeError as err:
        fail(f"{what}: {err}")


def sdpa_backward(torch, q, k, v, dout):
    """A call of SDPA's backward on these inputs (one call yields dq, dk
    and dv; the yardstick, never called by the port)."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = sdpa_forward(torch, *leaves)()
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def hold_backward(got, want, tol: float, label: str, worst: dict, dtype_name: str) -> None:
    """Fail unless each of (dq, dk, dv) is within ``tol`` of the plain
    backward's, as max |got - want| / max |want|; fold the errors into
    ``worst``, keyed as FLASH_ROWS: dq's under ("dq", dtype_name), dk and
    dv's under ("dkv", dtype_name)."""
    rels = [rel_err(g, w) for g, w in zip(got, want)]
    log(f"flash bwd {label}: rel dq {rels[0]:.2e} dk {rels[1]:.2e} dv {rels[2]:.2e} (tol {tol})")
    if not max(rels) <= tol:
        fail(f"flash backward {label}: {rels} > {tol}")
    abss = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
    for key, idx in ((("dq", dtype_name), (0,)), (("dkv", dtype_name), (1, 2))):
        worst[key][0] = max(worst[key][0], *(abss[i] for i in idx))
        worst[key][1] = max(worst[key][1], *(rels[i] for i in idx))


def check_flash_bwd(torch, fa, facts):
    """Phase 3b: kernels 3 and 4 (both variants of each) against the plain
    backward; times them at the training shape and returns their
    kernel-line entries, keyed as FLASH_ROWS."""
    dev = torch.device(DEVICE)
    B, H, D = 2, 16, 64
    gen = torch.Generator(device=dev).manual_seed(4)
    types = (("bfloat16", TOL_BWD_BF16, BF16_FLOPS), ("float32", TOL_BWD_F32, FP32_FLOPS))
    worst = {key: [0.0, 0.0] for key in FLASH_ROWS if key[0] != "forward"}  # (abs, rel)
    for dtype_name, tol, _ in types:
        dtype = getattr(torch, dtype_name)
        for s in (128, 200, 512, 1024):  # 200: ragged last q and kv tiles
            for group in (4, 1):
                hk = H // group
                q = torch.randn((B, H, s, D), generator=gen, device=dev).to(dtype)
                k = torch.randn((B, hk, s, D), generator=gen, device=dev).to(dtype)
                v = torch.randn((B, hk, s, D), generator=gen, device=dev).to(dtype)
                dout = torch.randn((B, H, s, D), generator=gen, device=dev).to(dtype)
                for causal, window in ((True, None), (True, 100), (False, None)):
                    out, lse = fa.flash_forward(q, k, v, causal=causal, window=window)
                    fa.reset_launches()
                    got = fa.flash_backward(q, k, v, out, lse, dout, causal=causal, window=window)
                    for kernel in ("dq", "dkv"):
                        expect_designs(getattr(fa.flash_backward, f"{kernel}_launches_by_design"),
                                       facts[(kernel, dtype_name)]["design"], 1,
                                       f"flash_backward {dtype}'s {kernel} kernel")
                    want = fa.flash_attention_backward_reference(
                        q, k, v, out, lse, dout, causal=causal, sm_scale=D ** -0.5,
                        window=window, block_kv=128,
                    )
                    hold_backward(got, want, tol,
                                  f"{dtype} s={s} group={group} causal={causal} window={window}",
                                  worst, dtype_name)
    # The training shape: the kernels exactly as the training step launches
    # them (bf16; float32 for the FMA variants), held against the plain
    # backward, then timed (L2 warm between launches).
    B, H, HK, S = 8, 16, 4, 1024
    opts = dict(causal=True, sm_scale=D ** -0.5, window=None)
    pairs = B * H * S * (S + 1) // 2  # causal (row, col) pairs
    rows = {}
    for dtype_name, tol, peak in types:
        dtype = getattr(torch, dtype_name)
        q = torch.randn((B, H, S, D), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, HK, S, D), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, HK, S, D), generator=gen, device=dev).to(dtype)
        dout = torch.randn((B, H, S, D), generator=gen, device=dev).to(dtype)
        shape = f"b{B} h{H} hk{HK} s{S} d{D} causal {dtype_name}"
        out, lse = fa.flash_forward(q, k, v, causal=True)
        dq, delta = fa.launch_dq(q, k, v, out, lse, dout, **opts)
        got = (dq, *fa.launch_dkv(q, k, v, lse, delta, dout, **opts))
        want = fa.flash_attention_backward_reference(q, k, v, out, lse, dout, block_kv=128,
                                                     **opts)
        hold_backward(got, want, tol, f"at {shape}", worst, dtype_name)
        calls = {"dq": lambda: fa.launch_dq(q, k, v, out, lse, dout, **opts),
                 "dkv": lambda: fa.launch_dkv(q, k, v, lse, delta, dout, **opts)}
        plain_ms, _ = time_ms(
            lambda: fa.flash_attention_backward_reference(q, k, v, out, lse, dout, block_kv=128,
                                                          **opts),
            iters=5, warmup=2,
        )
        library_ms = profiled_ms(torch, sdpa_backward(torch, q, k, v, dout),
                                 f"SDPA's backward ({shape})")
        size = q.element_size()
        row_q, row_kv, vec = B * H * S * D * size, B * HK * S * D * size, B * H * S * 4
        for kernel, call in calls.items():
            key = (kernel, dtype_name)
            ms, eager = time_ms(call, iters=20)
            prof = profiled_ms(torch, call, f"{facts[key]['name']} ({shape})")
            if kernel == "dq":
                # kernel 3 reads q, dO, O, lse, k, v and writes dq, D: 6 d flops a pair
                nbytes, flops, line = 4 * row_q + 2 * vec + 2 * row_kv, 6 * D * pairs, 433
            else:
                # kernel 4 reads q, dO, lse, D, k, v and writes dk, dv: 8 d flops a pair
                nbytes, flops, line = 2 * row_q + 2 * vec + 4 * row_kv, 8 * D * pairs, 500
            b_ms, b_by = bound(nbytes, flops, peak)
            rows[key] = {
                **facts[key],
                "replaces": f"k8s_device_plugin_tpu/ops/flash_attention.py:{line}",
                "launches": None,
                "max_abs_err": worst[key][0],
                "max_rel_err": worst[key][1],
                "tolerance": tol,
                "ms": ms,
                "eager_ms": eager,
                "profiled_ms": prof,
                "plain_ms": plain_ms,
                "plain_note": "the plain backward computes dq, dk and dv together",
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": library_ms,
                "library_note": "SDPA backward (profiler device time, compare with the sum of "
                                "the dq and dk/dv rows' profiled_ms), one call yields dq, dk "
                                "and dv",
                "shape": shape,
            }
            log(f"flash bwd {facts[key]['name']} at {shape}: graph {ms:.4f} ms, profiler "
                f"{prof:.4f} ms (bound {b_ms:.4f}); SDPA backward {library_ms:.4f} ms; "
                f"plain {plain_ms:.3f} ms")
    return rows


def model_flops_per_step(cfg, batch: int, seq: int) -> float:
    """The MFU numerator: 6 x non-embedding parameters x tokens (forward and
    backward products) plus 3 x the causal attention forward's products
    (4 x head_dim flops per (row, col) pair and head, per layer)."""
    from k8s_device_plugin_tpu_torch.models.transformer import param_shapes

    n = sum(math.prod(shape) for name, shape in param_shapes(cfg).items()
            if not name.startswith("embed."))
    pairs = batch * seq * (seq + 1) // 2
    attn_fwd = cfg.num_layers * cfg.num_heads * 4 * cfg.head_dim * pairs
    return 6 * n * batch * seq + 3 * attn_fwd


def run_training(torch, fa, bench, smi):
    """Phase 7: LM training at full width through the benchmark entry
    point; then one profiled step.  Returns (train summary, launches)."""
    from torch.profiler import ProfilerActivity, profile

    from k8s_device_plugin_tpu_torch.decode_profile import trace_stats

    args = bench.parse_args([
        "--model=gpt", "--batch-size=8", "--seq-len=1024", "--steps=5", "--warmup=2",
        "--dtype=bfloat16", f"--device={DEVICE}",
    ])
    cfg, state, step, batch = bench.build(args)
    fa.reset_launches()
    state, losses, dt = bench.timed_steps(step, state, batch, args.warmup, args.steps)
    torch.cuda.synchronize()
    launches = {
        "flash_attention": fa.flash_attention.launches,
        "flash_attention_bwd_dq": fa.flash_backward.dq_launches,
        "flash_attention_bwd_dkv": fa.flash_backward.dkv_launches,
    }
    by_design = {"forward": dict(fa.flash_attention.launches_by_design),
                 "dq": dict(fa.flash_backward.dq_launches_by_design),
                 "dkv": dict(fa.flash_backward.dkv_launches_by_design)}
    record = bench.make_record(args, state, losses, dt)
    log(f"training: {record}; launches {launches}, by design {by_design} over {state.step} steps")
    n = cfg.num_layers * state.step
    for name, count in launches.items():
        if count != n:
            fail(f"training launched {name} {count} times, not {cfg.num_layers} x "
                 f"{state.step} steps")
    # bf16 runs the tensor-core kernels 2, 3 and 4, never their FMA variants.
    for kernel, counts in by_design.items():
        expect_designs(counts, "wgmma", n, f"the bf16 training run's {kernel} kernel")
    bad = [i for i, loss in enumerate(losses) if not torch.isfinite(loss).item()]
    if bad:
        fail(f"training loss not finite at steps {bad}")
    step_s, steps_run = dt / args.steps, state.step
    flops = model_flops_per_step(cfg, args.batch_size, args.seq_len)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        loss.item()
        wall = time.perf_counter() - t0
    stats = trace_stats(prof, top=16)  # deep enough to list kernels 2 and 4
    summary = {
        "config": "vocab 32000, hidden 1024, 8 layers, 16/4 heads, intermediate 2816, "
                  "bf16 compute, float32 params, batch 8, seq 1024",
        "tokens_per_s": args.batch_size * args.seq_len / step_s,
        "step_time_ms": step_s * 1e3,
        "steps_run": steps_run,
        "losses": [loss.item() for loss in losses],
        "model_flops_per_step": flops,
        "mfu": flops / step_s / BF16_FLOPS,
        "mfu_formula": "(6 x non-embedding params x tokens + 3 x causal attention forward "
                       "flops) / step time / 989e12",
        "profiled_step": {"wall_ms": wall * 1e3, **stats},
        "launches": launches,
        "launches_by_design": by_design,
        "record": record,
        "card": smi,
    }
    return summary, launches


def check_train_parity(torch, fa, tf, train, data):
    """Phase 8: one fp32 train step on the card (kernels) and on the CPU
    (plain versions) from the same weights and batch."""
    cfg = tf.GPTConfig(
        vocab_size=32000, hidden_size=1024, num_layers=2, num_heads=16, num_kv_heads=4,
        intermediate_size=2816, max_seq=256, dtype=torch.float32,
    )
    params = tf.init_params(cfg, seed=5)
    batch = data.synthetic_lm_batch(2, 256, cfg.vocab_size,
                                    generator=torch.Generator().manual_seed(6), device="cpu")
    result = {}
    for device in (DEVICE, "cpu"):
        state = train.create_train_state(cfg, params, 0.1, 0.9, device=device)
        fa.reset_launches()
        state, loss = train.make_train_step()(state, {k: v.to(device) for k, v in batch.items()})
        result[device] = loss.item(), {k: v.cpu() for k, v in state.model.state_dict().items()}
        if device == DEVICE:
            # float32 runs the FMA kernels 2, 3 and 4, never the tensor-core ones.
            launches = {"forward": dict(fa.flash_attention.launches_by_design),
                        "dq": dict(fa.flash_backward.dq_launches_by_design),
                        "dkv": dict(fa.flash_backward.dkv_launches_by_design)}
            for kernel, counts in launches.items():
                expect_designs(counts, "fma", cfg.num_layers, f"the float32 step's {kernel} kernel")
    (card_loss, card_params), (cpu_loss, cpu_params) = result[DEVICE], result["cpu"]
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    param_err = max((card_params[k] - cpu_params[k]).abs().max().item() for k in cpu_params)
    log(f"fp32 train step card vs CPU: loss {card_loss:.6f} vs {cpu_loss:.6f} (rel {loss_rel:.2e}), "
        f"max param diff {param_err:.2e} (tol {TOL_TRAIN}); kernel launches {launches}")
    if not (loss_rel <= TOL_TRAIN and param_err <= TOL_TRAIN):
        fail(f"train step card vs CPU: loss rel {loss_rel}, params {param_err}")
    return {"loss_rel_err": loss_rel, "param_max_abs_err": param_err,
            "launches_by_design": launches}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    from k8s_device_plugin_tpu_torch.models import benchmark as bench
    from k8s_device_plugin_tpu_torch.models import data, engine, train
    from k8s_device_plugin_tpu_torch import decode_profile as dp
    from k8s_device_plugin_tpu_torch.models import transformer as tf
    from k8s_device_plugin_tpu_torch.ops import _build, quant, tuning
    from k8s_device_plugin_tpu_torch.ops import flash_attention as fa
    from k8s_device_plugin_tpu_torch.ops import paged_attention as pa
    from k8s_device_plugin_tpu_torch.utils.device import fp32_reference_precision

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    fp32_reference_precision()

    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f}s")
    facts = build_facts(torch, fa, _build)
    paged_builds = paged_build_facts(_build)

    paged = {row["kv_format"]: row for row in check_paged(torch, pa, quant, tuning, dp)}
    paged_hgmma = sum(sass_hgmma(_build.library_path("paged_attention")).values())
    for fmt, row in paged.items():
        # The row's registers and spills are the main path's build: bf16
        # queries, 64 wide.
        row.update(design="fma", hgmma=paged_hgmma, **paged_builds[fmt]["bfloat16_64"],
                   builds=paged_builds[fmt])
    flash, flash_fma = check_flash(torch, fa, facts)
    bwd = check_flash_bwd(torch, fa, facts)
    widths = check_widths(torch, pa, fa, quant, tuning)
    by_width = {D: time_head_dim(torch, pa, fa, dp, tuning, D) for D in (80, 96, 128)}
    dq, dq_fma = bwd[("dq", "bfloat16")], bwd[("dq", "float32")]
    dkv, dkv_fma = bwd[("dkv", "bfloat16")], bwd[("dkv", "float32")]
    summary, launches, sync_tokens = run_engine(torch, engine, pa, fa, SYNC_EAGER)
    paged["f"]["launches"] = launches["f"]
    quant_runs = []
    for flags in (["--quant=w8"], ["--quant=w8", "--quant-kv"], ["--quant=w8a8", "--quant-kv"]):
        q_summary, launches, _ = run_engine(torch, engine, pa, fa, (*SYNC_EAGER, *flags))
        q_summary["paged_launches"] = launches
        quant_runs.append(q_summary)
    blocks = run_blocks(torch, engine, pa, fa, dp, sync_tokens)
    from k8s_device_plugin_tpu_torch.models import http_server

    serve = run_serve(torch, tf, http_server, smi, blocks["greedy"])
    paged["f"]["block16_launches"] = blocks["paged_launches"]
    paged["int8"]["launches"] = quant_runs[1]["paged_launches"]["int8"]
    paged["int8"]["w8a8_launches"] = quant_runs[2]["paged_launches"]["int8"]
    sweep = dp.sweep_formats(iters=100)
    log(f"format sweep (kernel benchmark): {sweep}")
    for row in sweep["rows"]:
        paged[row["format"]]["profiled_ms"] = row["device_us_per_call"] / 1e3
    paged["int4"]["launches"] = sweep["launches"]["int4"]
    if paged["int4"]["launches"] <= 0:
        fail("the kernel benchmark never launched the paged kernel's int4 branch")
    flash["launches"] = run_generate(torch, tf, pa, fa)
    check_paths_agree(torch, tf, engine)
    agree_tiny = check_paths_agree(torch, tf, engine, cfg=tf.GPTConfig.tiny(), page=(4, 64, 16),
                                   prompt_len=16)
    agree_quant = check_paths_agree(torch, tf, engine, quant="w8", quant_kv=True)
    trained, launches = run_training(torch, fa, bench, smi)
    flash["train_launches"] = launches["flash_attention"]
    dq["launches"] = launches["flash_attention_bwd_dq"]
    dkv["launches"] = launches["flash_attention_bwd_dkv"]
    trained["card_vs_cpu"] = check_train_parity(torch, fa, tf, train, data)
    # The FMA variants run on float32 inputs only: their launches are phase
    # 8's, the float32 train step's.
    fma_launches = trained["card_vs_cpu"]["launches_by_design"]
    for row, kernel in ((flash_fma, "forward"), (dq_fma, "dq"), (dkv_fma, "dkv")):
        row["launches"] = fma_launches[kernel]["fma"]
        row["launches_from"] = "phase 8, the float32 train step (2 layers, 1 step)"

    for row, name in ((paged["f"], "paged_attention"), (flash, "flash_attention"),
                      (dq, "flash_attention_bwd_dq"), (dkv, "flash_attention_bwd_dkv")):
        for D, timed in by_width.items():
            row[f"head_dim_{D}"] = timed[name]
    kernels = [paged["f"], paged["int8"], paged["int4"], flash, flash_fma, dq, dq_fma, dkv,
               dkv_fma]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"slice": summary, "card": smi}), flush=True)
    print(json.dumps({"blocks": blocks, "widths_worst_err": widths,
                      "paths_agree_tiny_page4": agree_tiny, "card": smi}), flush=True)
    print(json.dumps({"quant": quant_runs, "format_sweep": sweep, "paths_agree_w8_int8kv": agree_quant,
                      "card": smi}), flush=True)
    print(json.dumps({"train": trained}), flush=True)
    print(json.dumps({"serve": serve}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
