#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero):

1. print the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the port from csrc/ (one nvcc each, in
   parallel);
3. hold each kernel against its plain PyTorch version on the card at the
   serving slice's shapes, and time the kernel, the plain version and,
   where one PyTorch call computes the same function, that call;
4. run the batch serving engine at the deployed model's full width (vocab
   32000, hidden 1024, 8 layers, 16 heads / 4 kv heads, page 16, 512 pages,
   32 pages per sequence, 8 slots; 32 requests, prompt 128, 128 new
   tokens, greedy), with the launch counters set to 0 just before and read
   just after: the paged-decode kernel must have launched;
5. run greedy_generate at full width (batch 8, prompt 128, 32 new tokens)
   the same way: the flash-forward kernel must have launched;
6. at 2 layers in float32, the engine's greedy tokens on the kernel path
   must equal those on the gathered-page path wherever the reference's
   top-2 logit margin clears the tolerance.

Then it prints one ``kernels`` JSON line, one ``slice`` JSON line, and last
the line ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
1 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

TOL_BF16 = 2e-2  # bf16 output rounding (one ulp at |x| < 2 is 7.8e-3) plus f32 sum order
TOL_F32 = 2e-5  # f32 sum order over a few hundred terms
TOL_LSE = 1e-3  # f32 log-sum-exp, sum order in 16- vs 128-column online updates
TOL_MARGIN = 1e-3  # fp32 logits: kernel vs gather paths differ by sum order only
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


def check_paged(torch, pa, tuning):
    """Kernel 1 against its plain version; returns its kernel-line entry."""
    dev = torch.device(DEVICE)
    B, H, HK, D, PS, MPP, P = 8, 16, 4, 64, 16, 32, 512
    G = H // HK
    gen = torch.Generator(device=dev).manual_seed(0)
    tuned = tuning.pick_num_splits(MPP, tuning.device_generation(dev))
    table = (torch.randperm(P - 1, generator=gen, device=dev)[: B * MPP] + 1)
    table = table.reshape(B, MPP).to(torch.int32)
    ragged = torch.tensor([1, 17, 100, 255, 256, 333, 480, 512], dtype=torch.int32, device=dev)
    worst = 0.0
    for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        q = torch.randn((B, H, D), generator=gen, device=dev).to(dtype)
        pk = torch.randn((P, PS, HK, D), generator=gen, device=dev).to(dtype)
        pv = torch.randn((P, PS, HK, D), generator=gen, device=dev).to(dtype)
        for splits in sorted({1, tuned}):
            for window in (None, 100):
                out = pa.paged_attention(q, pk, pv, table, ragged, window=window, num_splits=splits)
                ref = pa.paged_attention_reference(
                    q.reshape(B, HK, G, D), pk, pv, table, ragged,
                    sm_scale=D ** -0.5, window=window, num_splits=splits,
                ).reshape(B, H, D)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                log(f"paged {dtype} splits={splits} window={window}: max_abs_err {err:.3e} (tol {tol})")
                if not err <= tol:
                    fail(f"paged_attention {dtype} splits={splits} window={window}: {err} > {tol}")
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
    # Timing at the main path's shapes: bf16 pools as the engine sizes them,
    # the tuned split count, lens spread over the decode phase (prompt 128
    # plus up to 128 new tokens).  L2 is warm between launches.
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    pk = torch.randn((P, PS, HK, D), generator=gen, device=dev).to(torch.bfloat16)
    pv = torch.randn((P, PS, HK, D), generator=gen, device=dev).to(torch.bfloat16)
    lens = torch.tensor([129 + 16 * i for i in range(B)], dtype=torch.int32, device=dev)
    ms, eager_ms = time_ms(lambda: pa.paged_attention(q, pk, pv, table, lens, num_splits=tuned))
    plain_ms, _ = time_ms(
        lambda: pa.paged_attention_reference(
            q.reshape(B, HK, G, D), pk, pv, table, lens,
            sm_scale=D ** -0.5, window=None, num_splits=tuned,
        ),
        iters=20,
    )
    live = lens.long().tolist()
    pages_read = sum(-(-n // PS) for n in live)
    nbytes = (
        2 * B * H * D * 2  # q in, out
        + sum(live) * HK * D * 2 * 2  # live K and V rows
        + pages_read * 4 + B * 4  # table entries and lens
    )
    flops = sum(4 * H * n * D for n in live)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    return {
        "name": "paged_attention",
        "route": "cuda",
        "source": "k8s_device_plugin_tpu_torch/csrc/paged_attention.cu",
        "replaces": "k8s_device_plugin_tpu/ops/paged_attention.py:197",
        "launches": None,
        "max_abs_err": worst,
        "tolerance": TOL_BF16,
        "ms": ms,
        "eager_ms": eager_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "shape": f"B{B} H{H} Hk{HK} D{D} page{PS} mpp{MPP} splits{tuned} lens{live[0]}..{live[-1]} bf16",
    }


def check_flash(torch, fa):
    """Kernel 2 against its plain version; returns its kernel-line entry."""
    dev = torch.device(DEVICE)
    B, H, HK, D = 8, 16, 4, 64
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        for s in (128, 200, 512):  # 200: ragged last q and kv tiles
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
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        sdpa(q, k, v, is_causal=True, enable_gqa=True)
        lib = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)  # noqa: E731
    except TypeError:  # a PyTorch without enable_gqa: time it on expanded kv
        ke, ve = k.repeat_interleave(H // HK, 1), v.repeat_interleave(H // HK, 1)
        lib = lambda: sdpa(q, ke, ve, is_causal=True)  # noqa: E731
    library_ms, _ = time_ms(lib)
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


def run_engine(torch, engine, pa, fa):
    """Phase 4: the batch engine at full width; returns (summary, launches)."""
    args = engine.parse_args([
        "--hidden=1024", "--layers=8", "--heads=16", "--kv-heads=4", "--vocab=32000",
        "--page-size=16", "--num-pages=512", "--max-pages-per-seq=32", "--slots=8",
        "--requests=32", "--prompt-len=128", "--max-new=128", f"--device={DEVICE}",
    ])
    pa.paged_attention.launches = 0
    fa.flash_attention.launches = 0
    summary, done = engine.benchmark(args)
    torch.cuda.synchronize()
    launches = pa.paged_attention.launches
    log(f"engine: {summary}; paged launches {launches}, flash launches {fa.flash_attention.launches}")
    if launches <= 0:
        fail("the engine's decode never launched the paged-attention kernel")
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
    pa.paged_attention.launches = 0
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


def check_paths_agree(torch, tf, engine):
    """Phase 6: fp32, 2 layers, full width: kernel path == gather path
    wherever the reference's top-2 margin clears TOL_MARGIN."""
    cfg = tf.GPTConfig(
        vocab_size=32000, hidden_size=1024, num_layers=2, num_heads=16,
        intermediate_size=3072, max_seq=512, num_kv_heads=4, dtype=torch.float32,
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
                ids = torch.tensor([prompt + a[:j]], device=DEVICE)
                top2 = model(ids)[0, -1].topk(2).values
            margin = float(top2[0] - top2[1])
            if margin >= TOL_MARGIN:
                fail(f"kernel and gather paths disagree at token {j} with margin {margin}")
            ties += 1
            break  # past a near-tie the two streams legitimately differ
    log(f"fp32 paths agree on {checked} tokens ({ties} near-ties)")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    from k8s_device_plugin_tpu_torch.models import engine
    from k8s_device_plugin_tpu_torch.models import transformer as tf
    from k8s_device_plugin_tpu_torch.ops import _build, tuning
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

    kernels = [check_paged(torch, pa, tuning), check_flash(torch, fa)]
    summary, kernels[0]["launches"] = run_engine(torch, engine, pa, fa)
    kernels[1]["launches"] = run_generate(torch, tf, pa, fa)
    check_paths_agree(torch, tf, engine)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"slice": summary, "card": smi}), flush=True)
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
