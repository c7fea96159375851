"""Decoder-LM training benchmark (the reference's ``models/benchmark.py
--model gpt``).

    python -m k8s_device_plugin_tpu_torch.models.benchmark --model gpt \\
        --batch-size 8 --seq-len 1024 --steps 5 --warmup 2
    python -m k8s_device_plugin_tpu_torch.models.benchmark --model gpt --tiny \\
        --device cpu --dtype float32 --batch-size 2 --seq-len 32

Trains the reference's single-chip LM configuration (vocab 32000, hidden
1024, 8 layers, 16 heads / 4 kv heads, intermediate 2816; ``--tiny`` for
``GPTConfig.tiny()``) from seeded random weights on one fixed synthetic
batch with ``SGD(0.1, momentum=0.9)``, and prints one JSON record with the
reference CLI's keys plus ``device``.  Runs on ``cuda`` unless ``--device
cpu`` is given.  Only ``--model gpt`` is ported; the other models come
with later slices.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from ..utils.device import resolve_device
from .data import synthetic_lm_batch
from .train import create_train_state, make_fused_lm_train_step, make_train_step
from .transformer import GPTConfig, init_params

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def log(msg: str) -> None:
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def _positive_int(text: str) -> int:
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {value}")
    return value


def measure_two_point(run_small, run_big, n_delta: int, n_big: int):
    """The reference's two-point timer: ``run_small`` twice (their spread
    estimates the dispatch and sync jitter), then ``run_big``; the
    long-short delta counts only when it clears 3x that jitter.  Returns
    (seconds for the ``n_delta`` extra units, fell_back); on fallback the
    long run scaled by ``n_delta / n_big``."""
    times = []
    for fn in (run_small, run_small, run_big):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    t_small = min(times[0], times[1])
    jitter = abs(times[1] - times[0])
    dt = times[2] - t_small
    if dt <= 3 * jitter or dt <= 0:
        return times[2] * n_delta / max(n_big, 1), True
    return dt, False


def timed_steps(step, state, batch, warmup: int, steps: int):
    """``warmup`` untimed steps (the lazy first-use work: kernel builds and
    loads, cuBLAS handles, allocator growth), then the two-point timer over
    runs of ``small = warmup`` and ``small + steps`` steps, each ending in a
    sync on its last loss.  The state advances ``4 * warmup + steps`` steps.
    Returns (state, every step's loss, seconds for the timed steps)."""
    losses = []

    def run(n):
        nonlocal state
        for _ in range(n):
            state, loss = step(state, batch)
            losses.append(loss)
        losses[-1].item()  # wait for the device through a host copy

    run(warmup)
    dt, fell_back = measure_two_point(lambda: run(warmup), lambda: run(warmup + steps), steps,
                                      warmup + steps)
    if fell_back:
        log("two-point step delta below noise floor; reporting single-point")
    return state, losses, dt


def gpt_config(args) -> GPTConfig:
    """The reference's ``_gpt_config`` in ``--dtype``."""
    dtype = DTYPES[args.dtype]
    if args.tiny:
        return dataclasses.replace(GPTConfig.tiny(), dtype=dtype)
    return GPTConfig(
        vocab_size=32000, hidden_size=1024, num_layers=8, num_heads=16, num_kv_heads=4,
        intermediate_size=2816, max_seq=args.seq_len, dtype=dtype,
    )


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="torch-benchmark")
    p.add_argument("--model", choices=["gpt"], default="gpt")
    p.add_argument("--batch-size", type=_positive_int, default=128, help="GLOBAL batch size")
    p.add_argument("--seq-len", type=_positive_int, default=384)
    p.add_argument("--steps", type=_positive_int, default=30)
    p.add_argument("--warmup", type=_positive_int, default=5)
    p.add_argument("--fused-xent", action="store_true",
                   help="fused LM-head + cross-entropy loss tail (ops/fused_xent.py): "
                   "the [batch, seq, vocab] logits tensor never exists")
    p.add_argument("--grad-accum", type=_positive_int, default=1,
                   help="microbatches per optimizer step (the batch must divide evenly)")
    p.add_argument("--tiny", action="store_true", help="GPTConfig.tiny() (CPU smoke)")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16",
                   help="compute type (parameters stay float32)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.fused_xent and args.grad_accum > 1:
        p.error("--grad-accum does not combine with --fused-xent (as in the reference)")
    return args


def build(args):
    """(config, train state, step function, batch) for ``args``."""
    device = resolve_device(args.device)
    cfg = gpt_config(args)
    if args.seq_len > cfg.max_seq:
        raise SystemExit(f"--seq-len {args.seq_len} exceeds the config's max_seq {cfg.max_seq}")
    state = create_train_state(cfg, init_params(cfg, seed=0), 0.1, 0.9, device=device)
    if args.fused_xent:
        step = make_fused_lm_train_step()
        log("loss tail: fused LM-head + cross-entropy (no logits tensor)")
    else:
        step = make_train_step(grad_accum=args.grad_accum)
    gen = torch.Generator(device=device).manual_seed(0)
    batch = synthetic_lm_batch(args.batch_size, args.seq_len, cfg.vocab_size, generator=gen,
                               device=device)
    return cfg, state, step, batch


def make_record(args, state, losses, dt) -> dict:
    """The reference CLI's JSON record (plus ``device``) for a timed run."""
    throughput = args.batch_size * args.seq_len * args.steps / dt if dt > 0 else 0.0
    device = state.model.device
    return {
        "model": args.model,
        "chips": 1,
        "global_batch": args.batch_size,
        "throughput": round(throughput, 2),
        "throughput_per_chip": round(throughput, 2),
        "unit": "tokens/sec",
        "step_time_ms": round(dt / args.steps * 1e3, 2),
        "final_loss": losses[-1].item(),
        "final_step": state.step,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }


def run(args) -> dict:
    """Build, train and time; returns the record."""
    _, state, step, batch = build(args)
    return make_record(args, *timed_steps(step, state, batch, args.warmup, args.steps))


def main(argv=None) -> None:
    print(json.dumps(run(parse_args(argv))), flush=True)


if __name__ == "__main__":
    main()
