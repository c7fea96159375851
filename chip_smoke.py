#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero):

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the port from csrc/ (one nvcc each, in
   parallel);
3. hold each kernel against its plain PyTorch version on the card at the
   serving slice's shapes (the flash forward at s 1024 too, the training
   shape; the paged kernel in each pool format: bf16/f32, int8 and int4
   codes with float32 scale pools, and the int4 unpack on every byte
   value), and time the kernel, the plain version and, where one PyTorch
   call computes the same function, that call;
3b. hold the flash-backward kernels (dQ; dK/dV) against the plain backward
   over bf16 and f32, s 128, 200 (ragged) and 1024, window none and 100,
   causal and non-causal, kv group 4 and 1; at the training shape (b8 h16
   hk4 s1024 d64, causal, bf16) hold the forward and both backward kernels
   against their plain versions once more, then time them, the plain
   backward, and SDPA's backward (by profiler device time, with the two
   kernels timed the same way beside it);
4. run the batch serving engine at the deployed model's full width (vocab
   32000, hidden 1024, 8 layers, 16 heads / 4 kv heads, page 16, 512 pages,
   32 pages per sequence, 8 slots; 32 requests, prompt 128, 128 new
   tokens, greedy), with the launch counters set to 0 just before and read
   just after: the paged-decode kernel must have launched (float pools);
4b. the same engine run with the deployed pod's ``--quant=w8``, then with
   ``--quant=w8 --quant-kv``, then with ``--quant=w8a8 --quant-kv``: each
   must return 32 x 128 in-vocab tokens, and the ``--quant-kv`` runs must
   have launched the paged kernel's int8 branch on every decode step;
4c. ``decode_profile.sweep_formats``, the kernel benchmark (the reference
   reaches int4 pools only from its kernel benchmark): each pool format
   at the decode shape, launches counted by format;
5. run greedy_generate at full width (batch 8, prompt 128, 32 new tokens)
   the same way: the flash-forward kernel must have launched;
6. at 2 layers in float32, the engine's greedy tokens on the kernel path
   must equal those on the gathered-page path wherever the reference's
   top-2 logit margin clears the tolerance;
6b. the same with ``quant="w8"`` and ``quant_kv`` (int8 pools: the kernel
   scales scores and probabilities, the gather path dequantizes first);
7. train the decoder LM through ``models/benchmark.py`` at the reference's
   single-chip configuration (vocab 32000, hidden 1024, 8 layers, 16 heads
   / 4 kv heads, intermediate 2816, bf16 compute, float32 parameters,
   batch 8, seq 1024; 2 warmup and 5 timed steps on one synthetic batch),
   with the launch counters set to 0 just before and read just after: the
   forward, dQ and dK/dV kernels must each have launched 8 layers x the
   steps run, and every step's loss must be finite; then profile one more
   step under ``torch.profiler``;
8. at 2 layers in float32 (full width, batch 2, seq 256, TF32 off), one
   train step on the card (the kernels) and the same step on the CPU (the
   plain versions) from the same weights: losses within 1e-5 relative and
   every updated parameter within 1e-5.

Then it prints one ``kernels`` JSON line, one ``slice`` JSON line, one
``quant`` JSON line, one ``train`` JSON line, and last the line
``{"ok": true, "device": {...}}``.
Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import math
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


def check_paged(torch, pa, quant, tuning, dp):
    """Kernel 1 against its plain version in each pool format; returns its
    kernel-line entries (float, int8, int4)."""
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
    check_int4_bytes(torch, pa, quant)
    # Timing at the main path's shapes: bf16 queries, pools as the engine
    # sizes them in each format, the tuned split count, lens spread over
    # the decode phase (prompt 128 plus up to 128 new tokens).  L2 is warm
    # between launches.
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
            "library_ms": None,
            "shape": f"B{B} H{H} Hk{HK} D{D} page{PS} mpp{MPP} splits{tuned} "
                     f"lens{live[0]}..{live[-1]} bf16 q, {kv_format} pools",
        })
    return rows


def check_flash(torch, fa):
    """Kernel 2 against its plain version; returns its kernel-line entry."""
    dev = torch.device(DEVICE)
    B, H, HK, D = 8, 16, 4, 64
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        for s in (128, 200, 512, 1024):  # 200: ragged last q and kv tiles; 1024: training
            q = torch.randn((B, H, s, D), generator=gen, device=dev).to(dtype)
            k = torch.randn((B, HK, s, D), generator=gen, device=dev).to(dtype)
            v = torch.randn((B, HK, s, D), generator=gen, device=dev).to(dtype)
            for window in (None, 100):
                out, lse = fa.flash_forward(q, k, v, causal=True, window=window)
                ref, ref_lse = fa.flash_attention_reference(
                    q, k, v, causal=True, sm_scale=D ** -0.5, window=window, block_kv=128
                )
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                lerr = (lse - ref_lse).abs().max().item()
                log(f"flash {dtype} s={s} window={window}: max_abs_err {err:.3e} (tol {tol}), lse {lerr:.3e}")
                if not (err <= tol and lerr <= TOL_LSE):
                    fail(f"flash_attention {dtype} s={s} window={window}: out {err}, lse {lerr}")
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
    # Timing at the main path's shape: greedy_generate's bulk prefill.
    s = 128
    q = torch.randn((B, H, s, D), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, HK, s, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, HK, s, D), generator=gen, device=dev).to(torch.bfloat16)
    ms, eager_ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    plain_ms, _ = time_ms(
        lambda: fa.flash_attention_reference(
            q, k, v, causal=True, sm_scale=D ** -0.5, window=None, block_kv=128
        ),
        iters=20,
    )
    library_ms, _ = time_ms(sdpa_forward(torch, q, k, v))
    pairs = B * H * s * (s + 1) // 2  # causal (row, col) pairs
    nbytes = (B * H * s * D * 2) * 2 + (B * HK * s * D * 2) * 2 + B * H * s * 4
    b_ms, b_by = bound(nbytes, 4 * D * pairs, BF16_FLOPS)
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "k8s_device_plugin_tpu_torch/csrc/flash_attention.cu",
        "replaces": "k8s_device_plugin_tpu/ops/flash_attention.py:218",
        "launches": None,
        "max_abs_err": worst,
        "tolerance": TOL_BF16,
        "ms": ms,
        "eager_ms": eager_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": library_ms,
        "shape": f"b{B} h{H} hk{HK} s{s} d{D} causal bf16",
    }


def run_engine(torch, engine, pa, fa, flags=()):
    """Phases 4 and 4b: the batch engine at full width with the extra
    ``flags``; returns (summary, paged launches by pool format)."""
    args = engine.parse_args([
        "--hidden=1024", "--layers=8", "--heads=16", "--kv-heads=4", "--vocab=32000",
        "--page-size=16", "--num-pages=512", "--max-pages-per-seq=32", "--slots=8",
        "--requests=32", "--prompt-len=128", "--max-new=128", f"--device={DEVICE}", *flags,
    ])
    pa.reset_launches()
    fa.flash_attention.launches = 0
    summary, done = engine.benchmark(args)
    torch.cuda.synchronize()
    launches = dict(pa.paged_attention.launches_by_format)
    log(f"engine {list(flags)}: {summary}; paged launches {launches}, "
        f"flash launches {fa.flash_attention.launches}")
    want, other = ("int8", "f") if "--quant-kv" in flags else ("f", "int8")
    if launches[want] <= 0 or launches[other] or launches["int4"]:
        fail(f"the engine's decode {list(flags)} launched the paged kernel as {launches}, "
             f"not in its {want} branch alone")
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
    return summary, launches


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
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    out = tf.greedy_generate(cfg, params, prompt, 32, device=DEVICE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    log(f"greedy_generate: {tuple(out.shape)} in {dt:.3f}s; flash launches {launches}")
    if launches <= 0:
        fail("greedy_generate's bulk prefill never launched the flash kernel")
    if tuple(out.shape) != (8, 160) or not torch.equal(out[:, :128].cpu(), prompt):
        fail(f"greedy_generate returned {tuple(out.shape)} or altered the prompt")
    if int(out.min()) < 0 or int(out.max()) >= 32000:
        fail("greedy_generate emitted a token id outside the vocabulary")
    return launches


def check_paths_agree(torch, tf, engine, **quant_kw):
    """Phases 6 and 6b: fp32, 2 layers, full width (``quant_kw`` sets the
    weight and KV formats): kernel path == gather path wherever the top-2
    margin of the reference decode clears TOL_MARGIN."""
    cfg = tf.GPTConfig(
        vocab_size=32000, hidden_size=1024, num_layers=2, num_heads=16,
        intermediate_size=3072, max_seq=512, num_kv_heads=4, dtype=torch.float32, **quant_kw,
    )
    params = tf.init_params(cfg, seed=3)
    jobs = engine.synthetic_jobs(8, 64, 16, cfg.vocab_size)
    streams = {}
    for use_kernel in (None, False):
        paged = tf.PagedConfig(16, 512, 32, use_kernel=use_kernel)
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
    log(f"fp32 {quant_kw or 'float'} paths agree on {checked} tokens ({ties} near-ties)")
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
    """Device time per call of ``fn``: the kernels' time summed under
    torch.profiler.  SDPA's backward is timed this way because a CUDA graph
    cannot capture its ``autograd.grad`` here; the backward kernels are
    timed the same way beside it, so the two compare by one method."""
    from torch.profiler import ProfilerActivity, profile

    from k8s_device_plugin_tpu_torch.decode_profile import trace_stats

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    device_us = trace_stats(prof)["device_us"]
    if device_us is None:
        fail(f"the profiler traced no device time for {what}")
    return device_us / iters / 1e3


def sdpa_backward(torch, q, k, v, dout):
    """A call of SDPA's backward on these inputs (one call yields dq, dk
    and dv; the yardstick, never called by the port)."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = sdpa_forward(torch, *leaves)()
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def hold_backward(got, want, tol: float, label: str, worst: dict | None) -> None:
    """Fail unless each of (dq, dk, dv) is within ``tol`` of the plain
    backward's, as max |got - want| / max |want|; fold the errors into
    ``worst`` (bf16 cases)."""
    rels = [rel_err(g, w) for g, w in zip(got, want)]
    log(f"flash bwd {label}: rel dq {rels[0]:.2e} dk {rels[1]:.2e} dv {rels[2]:.2e} (tol {tol})")
    if not max(rels) <= tol:
        fail(f"flash backward {label}: {rels} > {tol}")
    if worst is not None:
        abss = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
        for key, idx in (("dq", (0,)), ("dkv", (1, 2))):
            worst[key][0] = max(worst[key][0], *(abss[i] for i in idx))
            worst[key][1] = max(worst[key][1], *(rels[i] for i in idx))


def check_flash_bwd(torch, fa, flash_row):
    """Phase 3b: kernels 3 and 4 against the plain backward; times them at
    the training shape, adds the forward's training-shape time to
    ``flash_row``, and returns the two kernel-line entries."""
    dev = torch.device(DEVICE)
    B, H, D = 2, 16, 64
    gen = torch.Generator(device=dev).manual_seed(4)
    worst = {"dq": [0.0, 0.0], "dkv": [0.0, 0.0]}  # bf16 (abs, rel)
    for dtype, tol in ((torch.bfloat16, TOL_BWD_BF16), (torch.float32, TOL_BWD_F32)):
        for s in (128, 200, 1024):  # 200: ragged last q and kv tiles
            for group in (4, 1):
                hk = H // group
                q = torch.randn((B, H, s, D), generator=gen, device=dev).to(dtype)
                k = torch.randn((B, hk, s, D), generator=gen, device=dev).to(dtype)
                v = torch.randn((B, hk, s, D), generator=gen, device=dev).to(dtype)
                dout = torch.randn((B, H, s, D), generator=gen, device=dev).to(dtype)
                for causal, window in ((True, None), (True, 100), (False, None)):
                    out, lse = fa.flash_forward(q, k, v, causal=causal, window=window)
                    got = fa.flash_backward(q, k, v, out, lse, dout, causal=causal, window=window)
                    want = fa.flash_attention_backward_reference(
                        q, k, v, out, lse, dout, causal=causal, sm_scale=D ** -0.5,
                        window=window, block_kv=128,
                    )
                    hold_backward(got, want, tol,
                                  f"{dtype} s={s} group={group} causal={causal} window={window}",
                                  worst if dtype == torch.bfloat16 else None)
    # The training shape: the two kernels exactly as the training step
    # launches them, held against the plain backward, then timed (L2 warm
    # between launches).  check_flash holds the forward at this shape.
    B, H, HK, S = 8, 16, 4, 1024
    q = torch.randn((B, H, S, D), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, HK, S, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, HK, S, D), generator=gen, device=dev).to(torch.bfloat16)
    dout = torch.randn((B, H, S, D), generator=gen, device=dev).to(torch.bfloat16)
    shape = f"b{B} h{H} hk{HK} s{S} d{D} causal bf16"
    opts = dict(causal=True, sm_scale=D ** -0.5, window=None)
    out, lse = fa.flash_forward(q, k, v, causal=True)
    dq, delta = fa.launch_dq(q, k, v, out, lse, dout, **opts)
    got = (dq, *fa.launch_dkv(q, k, v, lse, delta, dout, **opts))
    want = fa.flash_attention_backward_reference(q, k, v, out, lse, dout, block_kv=128, **opts)
    hold_backward(got, want, TOL_BWD_BF16, f"at {shape}", worst)
    dq_ms, dq_eager = time_ms(lambda: fa.launch_dq(q, k, v, out, lse, dout, **opts), iters=20)
    dkv_ms, dkv_eager = time_ms(lambda: fa.launch_dkv(q, k, v, lse, delta, dout, **opts), iters=20)
    plain_ms, _ = time_ms(
        lambda: fa.flash_attention_backward_reference(q, k, v, out, lse, dout, block_kv=128,
                                                      **opts),
        iters=5, warmup=2,
    )
    library_ms = profiled_ms(torch, sdpa_backward(torch, q, k, v, dout), "SDPA's backward")
    dq_prof = profiled_ms(torch, lambda: fa.launch_dq(q, k, v, out, lse, dout, **opts), "dQ")
    dkv_prof = profiled_ms(torch, lambda: fa.launch_dkv(q, k, v, lse, delta, dout, **opts),
                           "dK/dV")
    fwd_ms, _ = time_ms(lambda: fa.flash_attention(q, k, v, causal=True), iters=20)
    pairs = B * H * S * (S + 1) // 2  # causal (row, col) pairs
    row_q, row_kv, vec = B * H * S * D * 2, B * HK * S * D * 2, B * H * S * 4
    fwd_bound = bound(2 * row_q + 2 * row_kv + vec, 4 * D * pairs, BF16_FLOPS)
    flash_row.update(
        train_shape=shape, train_ms=fwd_ms,
        train_bound_ms=fwd_bound[0], train_bound_by=fwd_bound[1],
        train_library_ms=time_ms(sdpa_forward(torch, q, k, v), iters=20)[0],
    )
    rows = []
    for name, ms, eager, prof_ms, nbytes, flops, key, line in (
        # kernel 3 reads q, dO, O, lse, k, v and writes dq: 6 d flops a pair
        ("flash_attention_bwd_dq", dq_ms, dq_eager, dq_prof, 4 * row_q + vec + 2 * row_kv,
         6 * D * pairs, "dq", 433),
        # kernel 4 reads q, dO, lse, D, k, v and writes dk, dv: 8 d flops a pair
        ("flash_attention_bwd_dkv", dkv_ms, dkv_eager, dkv_prof, 2 * row_q + 2 * vec + 4 * row_kv,
         8 * D * pairs, "dkv", 500),
    ):
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "k8s_device_plugin_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"k8s_device_plugin_tpu/ops/flash_attention.py:{line}",
            "launches": None,
            "max_abs_err": worst[key][0],
            "max_rel_err": worst[key][1],
            "tolerance": TOL_BWD_BF16,
            "ms": ms,
            "eager_ms": eager,
            "profiled_ms": prof_ms,
            "plain_ms": plain_ms,
            "plain_note": "the plain backward computes dq, dk and dv together",
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": library_ms,
            "library_note": "SDPA backward (profiler device time, compare with the sum of "
                            "both rows' profiled_ms), one call yields dq, dk and dv",
            "shape": shape,
        })
    log(f"flash bwd at {shape}: profiler device time dq {dq_prof:.3f} + dkv {dkv_prof:.3f} ms "
        f"vs SDPA backward {library_ms:.3f} ms; graph replay dq {dq_ms:.3f} + dkv {dkv_ms:.3f} ms; "
        f"plain {plain_ms:.3f} ms; forward {fwd_ms:.3f} ms")
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
    fa.flash_attention.launches = 0
    fa.flash_backward.dq_launches = fa.flash_backward.dkv_launches = 0
    state, losses, dt = bench.timed_steps(step, state, batch, args.warmup, args.steps)
    torch.cuda.synchronize()
    launches = {
        "flash_attention": fa.flash_attention.launches,
        "flash_attention_bwd_dq": fa.flash_backward.dq_launches,
        "flash_attention_bwd_dkv": fa.flash_backward.dkv_launches,
    }
    record = bench.make_record(args, state, losses, dt)
    log(f"training: {record}; launches {launches} over {state.step} steps")
    for name, n in launches.items():
        if n != cfg.num_layers * state.step:
            fail(f"training launched {name} {n} times, not {cfg.num_layers} x {state.step} steps")
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
    stats = trace_stats(prof, top=10)
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
        "record": record,
        "card": smi,
    }
    return summary, launches


def check_train_parity(torch, tf, train, data):
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
        state, loss = train.make_train_step()(state, {k: v.to(device) for k, v in batch.items()})
        result[device] = loss.item(), {k: v.cpu() for k, v in state.model.state_dict().items()}
    (card_loss, card_params), (cpu_loss, cpu_params) = result[DEVICE], result["cpu"]
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    param_err = max((card_params[k] - cpu_params[k]).abs().max().item() for k in cpu_params)
    log(f"fp32 train step card vs CPU: loss {card_loss:.6f} vs {cpu_loss:.6f} (rel {loss_rel:.2e}), "
        f"max param diff {param_err:.2e} (tol {TOL_TRAIN})")
    if not (loss_rel <= TOL_TRAIN and param_err <= TOL_TRAIN):
        fail(f"train step card vs CPU: loss rel {loss_rel}, params {param_err}")
    return {"loss_rel_err": loss_rel, "param_max_abs_err": param_err}


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

    paged = {row["kv_format"]: row for row in check_paged(torch, pa, quant, tuning, dp)}
    flash = check_flash(torch, fa)
    dq, dkv = check_flash_bwd(torch, fa, flash)
    summary, launches = run_engine(torch, engine, pa, fa)
    paged["f"]["launches"] = launches["f"]
    quant_runs = []
    for flags in (["--quant=w8"], ["--quant=w8", "--quant-kv"], ["--quant=w8a8", "--quant-kv"]):
        q_summary, launches = run_engine(torch, engine, pa, fa, flags)
        q_summary["paged_launches"] = launches
        quant_runs.append(q_summary)
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
    agree_quant = check_paths_agree(torch, tf, engine, quant="w8", quant_kv=True)
    trained, launches = run_training(torch, fa, bench, smi)
    flash["train_launches"] = launches["flash_attention"]
    dq["launches"] = launches["flash_attention_bwd_dq"]
    dkv["launches"] = launches["flash_attention_bwd_dkv"]
    trained["card_vs_cpu"] = check_train_parity(torch, tf, train, data)

    kernels = [paged["f"], paged["int8"], paged["int4"], flash, dq, dkv]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"slice": summary, "card": smi}), flush=True)
    print(json.dumps({"quant": quant_runs, "format_sweep": sweep, "paths_agree_w8_int8kv": agree_quant,
                      "card": smi}), flush=True)
    print(json.dumps({"train": trained}), flush=True)
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
