"""Training benchmark (the training path of the reference's
``models/benchmark.py``): what the training pods run.

    python -m k8s_device_plugin_tpu_torch.models.benchmark --model resnet50 \\
        --batch-size 128 --steps 5 --warmup 2
    python -m k8s_device_plugin_tpu_torch.models.benchmark --model alexnet --batch-size 256
    python -m k8s_device_plugin_tpu_torch.models.benchmark --model vit --batch-size 64
    python -m k8s_device_plugin_tpu_torch.models.benchmark --model bert --batch-size 32 \\
        --seq-len 384
    python -m k8s_device_plugin_tpu_torch.models.benchmark --model gpt --batch-size 8 \\
        --seq-len 1024
    python -m k8s_device_plugin_tpu_torch.models.benchmark --model vit --tiny \\
        --device cpu --dtype float32 --batch-size 2 --steps 2 --warmup 1

Each model at the reference's widths: AlexNet (``--image-size``, 224),
ResNet-50 (``--stem conv7|space_to_depth``), ViT-B/16 (256 px, 256 tokens,
when ``--image-size`` is left at 224; ``--tiny`` for ``ViTConfig.tiny()``),
BERT-base (``--seq-len``, at most 512) and the single-chip LM (``--tiny``
for ``GPTConfig.tiny()``), from seeded random weights, on one fixed
synthetic batch, with ``SGD(0.1, momentum=0.9)``.  It prints one JSON
record with the reference CLI's keys plus ``device``: throughput in
images/sec (AlexNet, ResNet-50, ViT) or tokens/sec (BERT, the LM).  Runs on
``cuda`` unless ``--device cpu`` is given; ``--dtype`` is the compute type
(bfloat16 by default; parameters and BatchNorm statistics stay float32).

``--checkpoint-dir`` saves every ``--checkpoint-every`` steps and once at
the end (``models/checkpoint.py``), and ``--resume`` restores the newest
step first; ``--steps`` is then the absolute target step, and the record
adds ``resumed_from`` and ``noop``.  ``--trace-dir`` writes a
``torch.profiler`` trace of the timed region.  ``--dp``, ``--mp`` and
``--pp`` are taken at their one-card values only (ROADMAP.md queue 1 item
7 ports the parallel layers).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from ..utils import tracing
from ..utils.device import resolve_device
from .data import synthetic_image_batch, synthetic_lm_batch, synthetic_token_batch
from .train import (
    TrainState,
    create_train_state,
    make_fused_lm_train_step,
    make_train_step,
    state_for,
)
from .transformer import GPTConfig, init_params

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
MODELS = ("alexnet", "resnet50", "vit", "bert", "gpt")
TOKEN_MODELS = ("bert", "gpt")


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


def checkpointed_steps(step, state, batch, target_steps: int, ckpt, every: int,
                       warmup: int = 0):
    """Train from the state's step up to ``target_steps`` (absolute), saving
    at every multiple of ``every`` and once at the end (not again at a step
    already saved), as the reference's ``checkpointed_steps``.  The first
    ``warmup`` steps run outside the timed region but are real steps: they
    advance the step and take part in the save cadence, so resume
    arithmetic stays exact.  The device is synced where a save needs the
    post-step state and where the clock starts and stops; saves are
    synchronous, so the timed region holds those that fall in it.  Returns
    (state, losses, timed seconds, steps timed)."""
    start = state.step
    warm_until = min(start + warmup, target_steps)
    losses = []
    t0 = time.perf_counter() if warm_until <= start < target_steps else None
    while state.step < target_steps:
        state, loss = step(state, batch)
        losses.append(loss)
        s = state.step
        if s % every == 0 or s == warm_until or s == target_steps:
            loss.item()
        if s % every == 0:
            ckpt.save(state)
            log(f"checkpoint saved at step {s}")
        if s == warm_until and s != target_steps:
            t0 = time.perf_counter()
    dt = time.perf_counter() - t0 if t0 is not None else 0.0
    if state.step != ckpt.latest_step():
        ckpt.save(state)
    return state, losses, dt, max(target_steps - warm_until, 0)


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
    p.add_argument("--model", choices=MODELS, default="resnet50")
    p.add_argument("--batch-size", type=_positive_int, default=128, help="GLOBAL batch size")
    p.add_argument("--image-size", type=_positive_int, default=224)
    p.add_argument("--seq-len", type=_positive_int, default=384)
    p.add_argument("--steps", type=_positive_int, default=30)
    p.add_argument("--warmup", type=_positive_int, default=5)
    p.add_argument("--dp", type=int, default=-1, help="data-parallel axis size (one card: -1 or 1)")
    p.add_argument("--mp", type=int, default=1, help="param-sharding axis size (one card: 1)")
    p.add_argument("--pp", type=int, default=0, help="pipeline stages (one card: 0 or 1)")
    p.add_argument("--stem", choices=["conv7", "space_to_depth"], default="conv7",
                   help="resnet50 stem: the 7x7/s2 conv or the space-to-depth packing")
    p.add_argument("--fused-xent", action="store_true",
                   help="gpt only: fused LM-head + cross-entropy loss tail (ops/fused_xent.py): "
                   "the [batch, seq, vocab] logits tensor never exists")
    p.add_argument("--grad-accum", type=_positive_int, default=1,
                   help="microbatches per optimizer step (the batch must divide evenly)")
    p.add_argument("--tiny", action="store_true", help="tiny model config (CPU smoke; gpt and vit)")
    p.add_argument("--trace-dir", default=tracing.default_trace_dir(),
                   help="write a torch.profiler trace of the timed region here")
    p.add_argument("--checkpoint-dir", default="",
                   help="checkpoint directory (models/checkpoint.py): saves every "
                   "--checkpoint-every steps and at exit")
    p.add_argument("--checkpoint-every", type=_positive_int, default=10,
                   help="steps between checkpoint saves (with --checkpoint-dir)")
    p.add_argument("--resume", action="store_true",
                   help="restore the newest checkpoint under --checkpoint-dir first; --steps is "
                   "then the absolute target step")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16",
                   help="compute type (parameters and BatchNorm statistics stay float32)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.fused_xent and args.model != "gpt":
        p.error("--fused-xent requires --model gpt")
    if args.fused_xent and args.grad_accum > 1:
        p.error("--grad-accum does not combine with --fused-xent (as in the reference)")
    if args.batch_size % args.grad_accum:
        p.error(f"--batch-size {args.batch_size} is not divisible by --grad-accum "
                f"{args.grad_accum}")
    if args.dp not in (-1, 1) or args.mp != 1 or args.pp not in (0, 1):
        p.error(f"--dp {args.dp} --mp {args.mp} --pp {args.pp}: this port trains on one card "
                "(--dp -1 or 1, --mp 1, --pp 0 or 1); the parallel layers are ROADMAP.md "
                "queue 1 item 7")
    return args


class Built(NamedTuple):
    """What a run trains: its state, step function, fixed batch, and items
    (images or tokens) per step."""

    state: TrainState
    step: Callable
    batch: dict
    items_per_step: int


def build_model(args, device) -> nn.Module:
    """The image or encoder model ``--model`` names, in ``--dtype``, from
    seed 0."""
    dtype = DTYPES[args.dtype]
    if args.model == "alexnet":
        from .alexnet import AlexNet

        return AlexNet(1000, dtype, image_size=args.image_size, device=device)
    if args.model == "resnet50":
        from .resnet import ResNet50

        return ResNet50(num_classes=1000, dtype=dtype, norm_dtype=dtype, stem=args.stem,
                        device=device)
    if args.model == "vit":
        from .vit import ViT, ViTConfig

        if args.tiny:
            cfg = ViTConfig.tiny()
        else:
            # 256 px / patch 16 = 256 tokens, the flash route; --image-size overrides.
            cfg = ViTConfig(image_size=args.image_size if args.image_size != 224 else 256)
        return ViT(dataclasses.replace(cfg, dtype=dtype), device=device)
    if args.model == "bert":
        from .bert import Bert, BertConfig

        cfg = dataclasses.replace(BertConfig.base(), dtype=dtype)
        if args.seq_len > cfg.max_position:
            raise SystemExit(f"--seq-len {args.seq_len} exceeds BERT's max_position "
                             f"{cfg.max_position}")
        return Bert(cfg, device=device)
    raise SystemExit(f"unknown model {args.model!r}")


def build(args, model: Optional[nn.Module] = None) -> Built:
    """The state, step, batch and items per step for ``args``.  ``model``,
    when given, stands in for the one ``--model`` names (the same kind of
    input; a test or a smoke run passes a cut-down model)."""
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    input_key = "input_ids" if args.model in TOKEN_MODELS else "images"
    if args.model == "gpt" and model is None:
        cfg = gpt_config(args)
        if args.seq_len > cfg.max_seq:
            raise SystemExit(f"--seq-len {args.seq_len} exceeds the config's max_seq {cfg.max_seq}")
        state = create_train_state(cfg, init_params(cfg, seed=0), 0.1, 0.9, device=device)
    else:
        state = state_for(build_model(args, device) if model is None else model, 0.1, 0.9)
    model = state.model
    if args.model == "gpt":
        batch = synthetic_lm_batch(args.batch_size, args.seq_len, model.config.vocab_size,
                                   generator=gen, device=device)
    elif args.model == "bert":
        batch = synthetic_token_batch(args.batch_size, args.seq_len, model.config.vocab_size,
                                      generator=gen, device=device)
    else:
        size = model.config.image_size if args.model == "vit" else args.image_size
        batch = synthetic_image_batch(args.batch_size, size, model.num_classes, generator=gen,
                                      device=device)
    if args.fused_xent:
        step = make_fused_lm_train_step()
        log("loss tail: fused LM-head + cross-entropy (no logits tensor)")
    else:
        step = make_train_step(grad_accum=args.grad_accum, input_key=input_key)
        if args.grad_accum > 1:
            log(f"grad accumulation: {args.grad_accum} microbatches/step")
    items = args.batch_size * (args.seq_len if args.model in TOKEN_MODELS else 1)
    return Built(state, step, batch, items)


def make_record(args, state, losses, dt, steps_run: int, items_per_step: int) -> dict:
    """The reference CLI's JSON record (plus ``device``) for a run."""
    throughput = items_per_step * steps_run / dt if dt > 0 else 0.0
    device = next(state.model.parameters()).device
    return {
        "model": args.model,
        "chips": 1,
        "global_batch": args.batch_size,
        "throughput": round(throughput, 2),
        "throughput_per_chip": round(throughput, 2),
        "unit": "tokens/sec" if args.model in TOKEN_MODELS else "images/sec",
        "step_time_ms": round(dt / steps_run * 1e3, 2) if steps_run else 0.0,
        "final_loss": losses[-1].item() if losses else None,
        "final_step": state.step,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }


def run(args, model: Optional[nn.Module] = None) -> tuple[dict, TrainState]:
    """Build, train and time; returns (the record, the final state)."""
    built = build(args, model)
    state, step, batch = built.state, built.step, built.batch
    if not args.checkpoint_dir:
        with tracing.trace(args.trace_dir):
            state, losses, dt = timed_steps(step, state, batch, args.warmup, args.steps)
        return make_record(args, state, losses, dt, args.steps, built.items_per_step), state
    from .checkpoint import CheckpointManager

    ckpt = CheckpointManager(args.checkpoint_dir)
    resumed_from = 0
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        resumed_from = state.step
        log(f"resumed from checkpoint step {resumed_from}")
    if resumed_from >= args.steps:
        log(f"WARNING: checkpoint already at step {resumed_from} >= --steps {args.steps}; "
            "nothing to train. Stale checkpoint dir from a previous run? Clear it (or raise "
            "--steps) to re-benchmark.")
    with tracing.trace(args.trace_dir):
        state, losses, dt, steps_run = checkpointed_steps(
            step, state, batch, args.steps, ckpt, args.checkpoint_every, warmup=args.warmup)
    ckpt.close()
    record = make_record(args, state, losses, dt, steps_run, built.items_per_step)
    record["resumed_from"] = resumed_from
    # True when this run trained nothing (the checkpoint was at or past --steps).
    record["noop"] = record["final_step"] == resumed_from
    return record, state


def main(argv=None) -> None:
    print(json.dumps(run(parse_args(argv))[0]), flush=True)


if __name__ == "__main__":
    main()
