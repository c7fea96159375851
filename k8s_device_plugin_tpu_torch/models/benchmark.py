"""The reference's ``models/benchmark.py``: what the training pods run,
and the inference benchmarks (``--model gpt-decode``, ``--model serving``).

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
``torch.profiler`` trace of the timed region.

Training runs one process per card (:func:`launch`): ``--dp``/``--mp`` lay
the ranks out as the reference's ``make_slice_mesh({"dp", "mp"})`` lays
devices out (``parallel/``), and the step is FSDP over that mesh
(``parallel/sharding.shard_train_step``), so it computes the global batch's
step.  One card joins a world of one over NCCL; several are spawned, rank r
on card r; a multi-host slice (``TPU_WORKER_HOSTNAMES``/``TPU_WORKER_ID``,
or the ``JAX_*`` overrides: ``parallel/distributed.py``) numbers its ranks
host-major.  ``--device cpu`` runs dp·mp gloo ranks (``--dp -1`` counting
as 1).  The global batch must divide over the ``dp`` replicas (times
``--grad-accum``); the ``mp`` ranks of one take the same rows.  The record counts every rank in ``chips`` and prints
once per host::

    python -m k8s_device_plugin_tpu_torch.models.benchmark --model bert \
        --batch-size 64 --seq-len 384 --dp 2 --mp 4
    python -m k8s_device_plugin_tpu_torch.models.benchmark --model vit --tiny \
        --device cpu --dtype float32 --dp 2 --mp 2 --batch-size 4 --steps 2 --warmup 1

``--pp N`` (N > 1, ``--model gpt``) trains the decoder LM through the
pipelined path instead (:func:`run_pipelined`, ``parallel/pipeline_lm.py``):
N ranks, one stage each on its own card (``--device cpu``: gloo ranks),
over every host of the slice (N / hosts stages on each host, ranked
host-major as above), with ``--pp-schedule gpipe|1f1b`` over ``--n-micro``
microbatches a step; it prints the reference's ``gpt-pp`` record (plus
``device``) once per host.  As in the reference, the pipelined path saves
no checkpoint: it takes ``--checkpoint-dir`` and says so on stderr, as it
says of ``--compilation-cache-dir`` (XLA's cache) on any path::

    python -m k8s_device_plugin_tpu_torch.models.benchmark --model gpt --pp 8 \
        --pp-schedule 1f1b --n-micro 16 --batch-size 64 --seq-len 1024
    python -m k8s_device_plugin_tpu_torch.models.benchmark --model gpt --tiny \
        --device cpu --dtype float32 --pp 2 --pp-schedule 1f1b --batch-size 8 \
        --seq-len 32 --steps 2 --warmup 1

The inference modes print the reference's records, key for key::

    python -m k8s_device_plugin_tpu_torch.models.benchmark --model serving
    python -m k8s_device_plugin_tpu_torch.models.benchmark --model gpt-decode \
        --batch-size 128 [--temperature 0.8 --top-k 50]
    python -m k8s_device_plugin_tpu_torch.models.benchmark --model serving --tiny \
        --device cpu --dtype float32 --router-replicas 0 --requests 8 --slots 4 \
        --prompt-len 16 --decode-tokens 48
    python -m k8s_device_plugin_tpu_torch.models.benchmark --model gpt-decode --tiny \
        --device cpu --dtype float32 --batch-size 2 --prompt-len 4 --decode-tokens 8

``gpt-decode`` times ``greedy_generate`` (``sample_generate`` under
``--temperature``) two-point, as the reference; ``serving`` runs the
engine's phases (``run_serving``), then the router-side phases: tiny
replicas on the same device behind the port's router (``router/``) and the
fleet controller's simulation (``controller/``); ``tp`` prints null on one
card, and ``--router-replicas 0`` (or 1) prints ``router``, ``fabric``,
``canary`` and ``postmortem`` null, as the reference does.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import tempfile
import time
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from ..utils import tracing
from ..utils.device import fp32_reference_precision, resolve_device
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
MODELS = ("alexnet", "resnet50", "vit", "bert", "gpt", "gpt-decode", "serving")
TOKEN_MODELS = ("bert", "gpt")


def log(msg: str) -> None:
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def _positive_int(text: str) -> int:
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {value}")
    return value


def _sync(device: torch.device) -> None:
    """Wait for the device (the reference's ``_sync``: every timed region
    ends here).  The CPU runs eagerly and has nothing to wait for."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    """The reference's ``_gpt_config`` in ``--dtype``: room for the
    training sequence and for a prompt plus its decoded tokens."""
    dtype = DTYPES[args.dtype]
    if args.tiny:
        return dataclasses.replace(GPTConfig.tiny(), dtype=dtype)
    return GPTConfig(
        vocab_size=32000, hidden_size=1024, num_layers=8, num_heads=16, num_kv_heads=4,
        intermediate_size=2816, max_seq=max(args.seq_len, args.prompt_len + args.decode_tokens),
        dtype=dtype,
    )


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="torch-benchmark")
    p.add_argument("--model", choices=MODELS, default="resnet50")
    p.add_argument("--batch-size", type=_positive_int, default=128, help="GLOBAL batch size")
    p.add_argument("--image-size", type=_positive_int, default=224)
    p.add_argument("--seq-len", type=_positive_int, default=384)
    p.add_argument("--steps", type=_positive_int, default=30)
    p.add_argument("--warmup", type=_positive_int, default=5)
    p.add_argument("--dp", type=int, default=-1, help="data-parallel axis size (-1: all devices)")
    p.add_argument("--mp", type=int, default=1, help="param-sharding axis size")
    p.add_argument("--pp", type=int, default=0,
                   help="pipeline stages (gpt only): run the decoder through the pipelined-LM "
                   "path over a pp mesh axis instead of dp/mp")
    p.add_argument("--pp-schedule", choices=["gpipe", "1f1b"], default="gpipe",
                   help="pipeline schedule (with --pp): gpipe (autodiff backward) or 1f1b "
                   "(interleaved, O(stages) activation memory)")
    p.add_argument("--n-micro", type=_positive_int, default=4,
                   help="microbatches per step in the pipelined path (with --pp)")
    p.add_argument("--stem", choices=["conv7", "space_to_depth"], default="conv7",
                   help="resnet50 stem: the 7x7/s2 conv or the space-to-depth packing")
    p.add_argument("--fused-xent", action="store_true",
                   help="gpt only: fused LM-head + cross-entropy loss tail (ops/fused_xent.py): "
                   "the [batch, seq, vocab] logits tensor never exists")
    p.add_argument("--grad-accum", type=_positive_int, default=1,
                   help="microbatches per optimizer step (the batch must divide evenly)")
    p.add_argument("--prompt-len", type=_positive_int, default=64,
                   help="gpt-decode/serving prompt")
    p.add_argument("--decode-tokens", type=_positive_int, default=128,
                   help="gpt-decode/serving new tokens")
    p.add_argument("--slots", type=_positive_int, default=4,
                   help="serving: engine decode slots (continuous-batching width)")
    p.add_argument("--requests", type=_positive_int, default=16,
                   help="serving: synthetic requests pushed through the engine")
    p.add_argument("--kernel", action=argparse.BooleanOptionalAction, default=True,
                   help="serving: run the KERNELS phase (the paged-attention kernel against "
                   "the engine's gather path and the kernel at one split, per shape and KV "
                   "format; --no-kernel skips it)")
    p.add_argument("--router-replicas", type=int, default=2,
                   help="serving: replicas in the ROUTER phase (prefix-affinity vs "
                   "random-placement control over K tiny real serving replicas behind the "
                   "router daemon; 0/1 skips the phase)")
    p.add_argument("--temperature", type=float, default=None,
                   help="gpt-decode: sample with this temperature instead of greedy argmax")
    p.add_argument("--top-k", type=_positive_int, default=None,
                   help="gpt-decode: restrict sampling to the k highest logits")
    p.add_argument("--tiny", action="store_true", help="tiny model config (CPU smoke; gpt, gpt-decode, serving and vit)")
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
    p.add_argument("--compilation-cache-dir",
                   default=os.environ.get("TPU_COMPILATION_CACHE_DIR", ""),
                   help="XLA's persistent compilation cache: accepted and unused here "
                   "(the CUDA kernels build once per checkout under build/)")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16",
                   help="compute type (parameters and BatchNorm statistics stay float32)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.fused_xent and args.model != "gpt":
        p.error("--fused-xent requires --model gpt")
    if args.fused_xent and args.grad_accum > 1:
        p.error("--grad-accum does not combine with --fused-xent (as in the reference)")
    if args.model == "gpt-decode" and args.grad_accum > 1:
        p.error("--grad-accum applies to training; gpt-decode does not train (as in the "
                "reference)")
    if args.grad_accum > 1 and args.pp > 1:
        p.error("--grad-accum applies to the standard train step only (the fused-xent and "
                "pipelined steps manage their own microbatching, and gpt-decode does not "
                "train)")
    if args.batch_size % args.grad_accum:
        p.error(f"--batch-size {args.batch_size} is not divisible by --grad-accum "
                f"{args.grad_accum}")
    if args.fused_xent and args.pp > 1:
        p.error("--fused-xent is not supported with --pp (the pipelined LM head runs inside "
                "the 1F1B/GPipe objective); drop one of the flags")
    if args.pp > 1 and args.model not in ("gpt", "gpt-decode", "serving"):
        p.error("--pp requires --model gpt (the pipelined decoder)")
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


def build(args, model: Optional[nn.Module] = None, device=None) -> Built:
    """The state, step, batch and items per step for ``args``, on
    ``device`` (default: ``--device`` resolved).  ``model``, when given,
    stands in for the one ``--model`` names (the same kind of input; a test
    or a smoke run passes a cut-down model)."""
    device = resolve_device(args.device) if device is None else device
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


def make_record(args, state, losses, dt, steps_run: int, items_per_step: int,
                chips: int = 1) -> dict:
    """The reference CLI's JSON record (plus ``device``) for a run over
    ``chips`` ranks; ``losses`` are global-batch means."""
    throughput = items_per_step * steps_run / dt if dt > 0 else 0.0
    device = next(state.model.parameters()).device
    return {
        "model": args.model,
        "chips": chips,
        "global_batch": args.batch_size,
        "throughput": round(throughput, 2),
        "throughput_per_chip": round(throughput / chips, 2),
        "unit": "tokens/sec" if args.model in TOKEN_MODELS else "images/sec",
        "step_time_ms": round(dt / steps_run * 1e3, 2) if steps_run else 0.0,
        "final_loss": losses[-1].item() if losses else None,
        "final_step": state.step,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }


def _train(args, state, step, batch, items_per_step: int, chips: int = 1):
    """Time ``step`` from ``state`` (checkpointed under
    ``--checkpoint-dir``); returns (record, final state, every step's
    loss)."""
    if not args.checkpoint_dir:
        with tracing.trace(args.trace_dir):
            state, losses, dt = timed_steps(step, state, batch, args.warmup, args.steps)
        return (make_record(args, state, losses, dt, args.steps, items_per_step, chips), state,
                losses)
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
    record = make_record(args, state, losses, dt, steps_run, items_per_step, chips)
    record["resumed_from"] = resumed_from
    # True when this run trained nothing (the checkpoint was at or past --steps).
    record["noop"] = record["final_step"] == resumed_from
    return record, state, losses


# ------------------------------------------------------------ ranks and meshes


class DistributedRun(NamedTuple):
    """What :func:`launch` returns from local rank 0: its record, the global
    mean loss of every step, the full state dict after the run (parameters
    and buffers on the CPU, on global rank 0; None unless
    ``gather_params``) and the parameter + optimizer-state bytes each rank
    held."""

    record: dict
    losses: list
    state_dict: Optional[dict]
    rank_bytes: list


def local_rank_count(args) -> int:
    """Ranks on this host: one per visible card, or on ``--device cpu``
    this host's share of ``pp`` past 1 (its stages), else dp·mp (-1
    counting as 1)."""
    if resolve_device(args.device).type == "cuda":
        return torch.cuda.device_count()
    if args.pp > 1:
        return max(args.pp // slice_hosts(), 1)
    return max(args.dp, 1) * max(args.mp, 1)


def slice_hosts() -> int:
    """Hosts of this pod's slice (``process_group_from_env``: 1 for a
    single-host allocation); exits on an environment it cannot read."""
    from ..parallel import distributed

    try:
        config = distributed.process_group_from_env()
    except ValueError as e:
        raise SystemExit(str(e))
    return config.num_processes if config else 1


def check_layout(args, local_ranks: int) -> int:
    """Exit, as the reference does before it builds anything, when
    ``--dp``/``--mp`` do not lay out the slice's ranks or the global batch
    does not split over the ``dp`` replicas (the ``mp`` ranks of one take
    the same rows, as the reference replicates the batch over ``mp``);
    under ``--pp`` past 1, when its stages do not fit the devices or the
    model (:func:`check_pipeline`).  Returns the world size."""
    from ..parallel import distributed
    from ..parallel.mesh import mesh_shape

    if args.pp > 1:
        return check_pipeline(args, local_ranks)
    try:
        config = distributed.process_group_from_env()
        world = (config.num_processes if config else 1) * local_ranks
        dp = mesh_shape({"dp": args.dp, "mp": args.mp}, world)["dp"]
    except ValueError as e:
        raise SystemExit(str(e))
    if args.batch_size % (dp * args.grad_accum):
        raise SystemExit(
            f"--batch-size {args.batch_size} does not split over dp={dp} replicas"
            + (f" x --grad-accum {args.grad_accum}" if args.grad_accum > 1 else "")
            + ": each dp replica takes an equal share of every microbatch")
    return world


def check_pipeline(args, local_ranks: int) -> int:
    """The reference's refusals of ``--pp``: fewer devices than stages, and
    layers the stages do not split; and a global batch ``--n-micro`` does
    not split, before a rank raises it.  The stages run over every host of
    the slice (the reference's ``jax.devices()``), ``pp / hosts`` on each
    host's devices, ranked host-major, so ``pp`` must split evenly over
    the hosts.  Returns the device count of the slice."""
    hosts = slice_hosts()
    if args.pp % hosts:
        raise SystemExit(f"--pp {args.pp} does not split over the slice's {hosts} hosts "
                         "(each host runs pp / hosts stages)")
    if local_ranks * hosts < args.pp:
        raise SystemExit(f"--pp {args.pp} but only {local_ranks * hosts} device(s)")
    layers = gpt_config(args).num_layers
    if layers % args.pp:
        raise SystemExit(f"num_layers {layers} not divisible by --pp {args.pp}")
    if args.batch_size % args.n_micro:
        raise SystemExit(f"batch {args.batch_size} not divisible by n_micro={args.n_micro}")
    return local_ranks * hosts


def launch(args, *, backend: Optional[str] = None, local_ranks: Optional[int] = None,
           model_fn: Optional[Callable] = None, gather_params: bool = False) -> DistributedRun:
    """Train ``args`` on every local rank: in this process when there is
    one, else one spawned process per rank (``torch.multiprocessing``,
    rank r on card r, with this process's TF32 settings).  ``backend``
    (default NCCL on cards, gloo on the CPU) and ``local_ranks`` (default
    :func:`local_rank_count`) let ranks share one card over gloo;
    ``model_fn(device=...)`` (picklable) stands in for the model
    ``--model`` names.  Under ``--pp`` past 1 it runs this host's ``pp /
    hosts`` ranks of :func:`run_pipelined` instead (``model_fn`` unused;
    on a multi-host slice every host runs its own stages, global ranks
    host-major from the slice's env).  Returns local rank 0's
    :class:`DistributedRun`."""
    n = local_rank_count(args) if local_ranks is None else local_ranks
    chips = check_layout(args, n)
    if args.pp > 1:
        n = args.pp // slice_hosts()  # one rank a stage, on devices 0..n-1
    from ..parallel.distributed import local_init_method

    init_method = local_init_method()
    if n == 1:
        return _rank_main(0, args, 1, backend, init_method, model_fn, gather_params, None, None,
                          chips)
    import torch.multiprocessing as mp

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with tempfile.TemporaryDirectory(prefix="ranks-") as out:
        mp.start_processes(_rank_main, nprocs=n, start_method="spawn", args=(
            args, n, backend, init_method, model_fn, gather_params, out, tf32, chips))
        return DistributedRun(*torch.load(os.path.join(out, "rank0.pt"), weights_only=False))


def _rank_main(local_rank: int, args, local_ranks: int, backend, init_method, model_fn,
               gather_params: bool, out_dir: Optional[str], tf32: Optional[tuple],
               chips: int) -> DistributedRun:
    """One rank: join the group, build, shard, train, record; leaves the
    group at the end."""
    from ..parallel import distributed
    from ..parallel.sharding import (
        gather_full_state,
        local_state_bytes,
        dp_coordinate,
        shard_batch,
        shard_train_step,
    )

    dist = torch.distributed
    if tf32 is not None:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    device = distributed.join_local(args.device, local_rank, local_ranks, init_method, backend)
    try:
        if args.pp > 1:
            result = run_pipelined(args, device, chips, gather_params)
            if out_dir is not None and local_rank == 0:
                torch.save(tuple(result), os.path.join(out_dir, "rank0.pt"))
            dist.barrier()
            return result
        rank, world = dist.get_rank(), dist.get_world_size()
        mesh = distributed.make_slice_mesh({"dp": args.dp, "mp": args.mp},
                                           device_type=device.type)
        if rank == 0:
            log(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} over {world} "
                f"rank(s), {dist.get_backend()}")
        built = build(args, model_fn(device=device) if model_fn else None, device=device)
        step, state = shard_train_step(built.step, mesh, built.state)
        batch = shard_batch(built.batch, *dp_coordinate(mesh), args.grad_accum)
        items_per_step = built.items_per_step
        del built  # the global batch: each rank keeps its rows
        record, state, losses = _train(args, state, step, batch, items_per_step, world)
        rank_bytes = [None] * world
        dist.all_gather_object(rank_bytes, local_state_bytes(state))
        full = gather_full_state(state.model) if gather_params else None
        result = DistributedRun(record, [float(x) for x in losses], full, rank_bytes)
        if out_dir is not None and local_rank == 0:
            torch.save(tuple(result), os.path.join(out_dir, "rank0.pt"))
        dist.barrier()
        return result
    finally:
        dist.destroy_process_group()


def run_pipelined(args, device: torch.device, chips: int,
                  gather_params: bool = False) -> DistributedRun:
    """One rank of the pipelined path (the reference's ``run_pipelined``):
    the decoder LM at ``gpt_config`` over a ``pp`` mesh of every rank, this
    rank its group rank's stage, seeded weights (``init_params(cfg, 0)``,
    so any stage count trains the same LM) and one seeded synthetic batch
    on every rank, SGD(0.1, momentum 0.9), ``--pp-schedule`` over
    ``--n-micro`` microbatches, timed as the standard path.  The record is
    the reference's ``gpt-pp`` record (plus ``device``); ``chips`` counts
    the devices the run saw, as the reference's ``len(jax.devices())``."""
    from ..parallel import distributed
    from ..parallel.pipeline_lm import PipelinedLM
    from ..parallel.sharding import local_state_bytes

    dist = torch.distributed
    mesh = distributed.make_slice_mesh({"pp": args.pp}, device_type=device.type)
    if dist.get_rank() == 0:
        log(f"mesh: {{'pp': {args.pp}}} over {dist.get_world_size()} rank(s), "
            f"{dist.get_backend()}, schedule {args.pp_schedule}, {args.n_micro} microbatches")
    cfg = gpt_config(args)
    if args.seq_len > cfg.max_seq:
        raise SystemExit(f"--seq-len {args.seq_len} exceeds the config's max_seq {cfg.max_seq}")
    plm = PipelinedLM(cfg, mesh, n_micro=args.n_micro, device=device)
    plm.init(0)
    state = plm.create_train_state(0.1, 0.9)
    batch = synthetic_lm_batch(args.batch_size, args.seq_len, cfg.vocab_size,
                               generator=torch.Generator().manual_seed(0), device=device)
    with tracing.trace(args.trace_dir):
        state, losses, dt = timed_steps(plm.make_train_step(args.pp_schedule), state, batch,
                                        args.warmup, args.steps)
    record = {
        "model": "gpt-pp",
        "schedule": args.pp_schedule,
        "chips": chips,
        "pp": args.pp,
        "n_micro": args.n_micro,
        "global_batch": args.batch_size,
        "throughput": round(args.batch_size * args.seq_len * args.steps / dt, 2),
        "unit": "tokens/sec",
        "step_time_ms": round(dt / args.steps * 1e3, 2),
        "final_loss": losses[-1].item(),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    world = dist.get_world_size()
    rank_bytes = [None] * world
    dist.all_gather_object(rank_bytes, local_state_bytes(state))
    full = None
    if gather_params:
        states = [None] * world if dist.get_rank() == 0 else None
        dist.gather_object({k: v.detach().cpu() for k, v in plm.state_dict().items()}, states,
                           dst=0)
        full = {k: v for st in states for k, v in st.items()} if states else None
    return DistributedRun(record, [float(x) for x in losses], full, rank_bytes)


# ------------------------------------------------------------- inference modes


def run_decode(args, params: Optional[dict] = None) -> tuple[dict, torch.Tensor]:
    """Autoregressive decode throughput (tokens/sec) through the KV cache,
    the reference's ``run_decode``: ``greedy_generate`` (``sample_generate``
    under ``--temperature``, key ``PRNGKey(1)``) at ``gpt_config`` on a
    seeded [batch, prompt_len] prompt.  Two-point timing: a 1-token
    generate covers the constant costs (the bulk prefill, launches, the
    sync); the full one adds exactly ``decode_tokens - 1`` decode steps.
    ``params`` (a state dict) stands in for ``init_params(cfg, 0)``.
    Returns (the reference's record, the last full generate's tokens)."""
    from ..utils import prng
    from .transformer import greedy_generate, sample_generate

    device = resolve_device(args.device)
    fp32_reference_precision()
    cfg = gpt_config(args)
    gen = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch_size, args.prompt_len),
                           generator=gen).to(device)
    # On the device once: each generate loads its model from these.
    params = {name: t.to(device) for name, t in
              (init_params(cfg, 0) if params is None else params).items()}
    if args.temperature is None:
        def generate(n):
            return greedy_generate(cfg, params, prompt, n, device=device)
    else:
        key = prng.PRNGKey(1)

        def generate(n):
            return sample_generate(cfg, params, prompt, n, rng=key, temperature=args.temperature,
                                   top_k=args.top_k, device=device)
    held = {}

    def run_n(n):
        held["out"] = generate(n)
        _sync(device)

    two_point = args.decode_tokens > 1
    full_steps = args.decode_tokens
    t0 = time.perf_counter()
    if two_point:
        run_n(1)
    run_n(args.decode_tokens)
    log(f"decode first runs (kernel builds, warm-up) {time.perf_counter() - t0:.1f}s")
    with tracing.trace(args.trace_dir):
        if two_point:
            dt, fell_back = measure_two_point(lambda: run_n(1), lambda: run_n(args.decode_tokens),
                                              args.decode_tokens - 1, full_steps)
            if fell_back:
                log("decode delta below noise floor; reporting single-point")
                two_point = False
                dt = dt * full_steps / (args.decode_tokens - 1)
        else:
            t0 = time.perf_counter()
            run_n(args.decode_tokens)
            dt = time.perf_counter() - t0
    steps = args.decode_tokens - 1 if two_point else full_steps
    record = {
        "model": "gpt-decode",
        "sampler": "greedy" if args.temperature is None
        else f"temperature={args.temperature},top_k={args.top_k}",
        "chips": 1,
        "batch": args.batch_size,
        "prompt_len": args.prompt_len,
        "new_tokens": args.decode_tokens,
        "steps": steps,
        "throughput": round(args.batch_size * steps / dt, 2),
        "unit": "decoded tokens/sec (two-point, prefill+overhead excluded)" if two_point
        else "generated tokens/sec (incl. prefill cost)",
        "ms_per_token": round(dt / steps * 1e3, 3),
    }
    return record, held["out"]


class ServingRun(NamedTuple):
    """What ``run_serving`` measured: the reference's record, the finished
    requests of the timed overlapped run, and what a caller checks beyond
    the record (``extras``: each engine's dispatched device steps, the
    paged-kernel launches and the arms' errors of the kernels phase, the
    dispatch shapes seen after the warm-up and after the timed runs, and
    the greedy streams of the synchronous run and of tracing off and on)."""

    record: dict
    done: list
    extras: dict


def _ttfts(reqs) -> list:
    return sorted(r.first_token_at - r.submitted_at for r in reqs if r.first_token_at)


def _q(sorted_vals, q: float):
    """The reference's index quantile of an ascending list (None if empty)."""
    if not sorted_vals:
        return None
    return sorted_vals[min(int(q * len(sorted_vals)), len(sorted_vals) - 1)]


def _ms(value):
    return None if value is None else round(value * 1e3, 3)


# (name, batch, heads, kv_heads, head_dim, page_size, pages, fill, fmt): the
# reference's kernels-phase shapes; fill < 1 leaves a partial last page.
KERNEL_SHAPES = (
    ("b4_gqa_f32", 4, 8, 4, 64, 16, 8, 0.75, "f32"),
    ("b2_mqa_long_f32", 2, 16, 2, 64, 16, 32, 0.4, "f32"),
    ("b4_gqa_bf16", 4, 8, 4, 64, 16, 8, 0.75, "bf16"),
    ("b4_gqa_int8", 4, 8, 4, 64, 16, 8, 0.75, "int8"),
    ("b4_gqa_int4", 4, 8, 4, 64, 16, 8, 0.75, "int4"),
)


def _run_kernels_phase(args) -> tuple[Optional[dict], Optional[dict]]:
    """KERNELS phase, the reference's per-shape ledger: three arms on the
    same inputs, per shape and KV format.

    - **kernel**: ``ops.paged_attention`` through its default routing (the
      CUDA kernel on the card, its plain version on the CPU) with the split
      count ``ops/tuning.py`` picks for the device;
    - **gather**: the engine's gather-path math from ``transformer.py``
      (the [max_len] view gathered through the table and dequantized, then
      ``cached_group_attention``);
    - **single**: the kernel forced to one split.

    Every arm is warmed twice, then timed as the minimum over N calls, each
    ended by a device sync: wall milliseconds of a synced call, launch and
    sync included, not replayed device time.  Returns the ``kernels``
    block and, for a caller that holds the arms, per shape each arm's max
    |arm - gather| and the paged-kernel launches the phase made (both None
    under ``--no-kernel``)."""
    if not args.kernel:
        return None, None
    import zlib

    from ..ops import paged_attention as pa
    from ..ops import tuning
    from ..ops.quant import quantize_kv, quantize_kv4
    from .transformer import cached_group_attention, gather_pages

    device = resolve_device(args.device)

    def _time(fn, iters):
        fn()
        _sync(device)
        fn()
        _sync(device)
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            _sync(device)
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    generation = tuning.device_generation(device)
    launches0 = dict(pa.paged_attention.launches_by_format)
    rows: dict[str, dict] = {}
    held: dict = {}
    for name, batch, heads, kv_heads, head_dim, ps, pages, fill, fmt in KERNEL_SHAPES:
        dt = torch.float32 if fmt == "f32" else torch.bfloat16
        gen = torch.Generator().manual_seed(zlib.crc32(name.encode()) % (1 << 31))
        n_pool = batch * pages + 1
        q = torch.randn((batch, heads, head_dim), generator=gen).to(device, dt)
        pool_k, pool_v = (torch.randn((n_pool, ps, kv_heads, head_dim), generator=gen)
                          .to(device, dt) for _ in range(2))
        table = (torch.arange(batch * pages, dtype=torch.int32).reshape(batch, pages) + 1
                 ).to(device)
        max_len = pages * ps
        lens = torch.tensor([max(1, int(max_len * fill) - 3 * i) for i in range(batch)],
                            dtype=torch.int32, device=device)
        sk = sv = None
        if fmt in ("int8", "int4"):
            quantize = quantize_kv if fmt == "int8" else quantize_kv4
            (pool_k, sk), (pool_v, sv) = quantize(pool_k), quantize(pool_v)
        splits = tuning.pick_num_splits(pages, generation)
        quant_kw = {"scale_k": sk, "scale_v": sv} if sk is not None else {}

        def kernel():
            return pa.paged_attention(q, pool_k, pool_v, table, lens, **quant_kw)

        def single():
            return pa.paged_attention(q, pool_k, pool_v, table, lens, num_splits=1, **quant_kw)

        def gather():
            int4 = fmt == "int4"
            positions = (lens.long() - 1)[:, None]
            out = cached_group_attention(q[:, None], gather_pages(pool_k, sk, table, dt, int4=int4),
                                         gather_pages(pool_v, sv, table, dt, int4=int4),
                                         positions, None, heads)
            return out.reshape(batch, heads, head_dim)

        kernel_ms = _time(kernel, iters=7)
        gather_ms = _time(gather, iters=7)
        single_ms = _time(single, iters=2)
        want = gather().float()
        held[name] = {
            "fmt": fmt,
            "kernel_err": (kernel().float() - want).abs().max().item(),
            "single_err": (single().float() - want).abs().max().item(),
        }
        rows[name] = {
            "fmt": fmt,
            "batch": batch,
            "heads": heads,
            "kv_heads": kv_heads,
            "head_dim": head_dim,
            "page_size": ps,
            "pages": pages,
            "splits": splits,
            "kernel_ms": round(kernel_ms, 4),
            "gather_ms": round(gather_ms, 4),
            "single_ms": round(single_ms, 4),
            "kernel_vs_gather": round(gather_ms / kernel_ms, 3),
            "single_vs_gather": round(gather_ms / single_ms, 3),
        }
        log(f"  kernels {name:<16} {fmt:<5} S={splits} kernel {kernel_ms:.3f}ms gather "
            f"{gather_ms:.3f}ms single {single_ms:.3f}ms -> {gather_ms / kernel_ms:.2f}x gather "
            "(min wall ms of a synced call)")
    held["launches"] = {fmt: n - launches0[fmt]
                        for fmt, n in pa.paged_attention.launches_by_format.items()}
    min_ratio = min(r["kernel_vs_gather"] for r in rows.values())
    int8_vs_bf16 = round(rows["b4_gqa_bf16"]["kernel_ms"] / rows["b4_gqa_int8"]["kernel_ms"], 3)
    log(f"perf-ledger row: | KERNELS split-K paged attention ({len(rows)} shapes) | kernel vs "
        f"gather min {min_ratio:.2f}x (int8 vs bf16 {int8_vs_bf16}x; splits from {generation} "
        "row) | - | `benchmark.py --model serving --kernel` | update on bench round |")
    return {
        "generation": generation,
        "shapes": rows,
        "min_kernel_vs_gather": min_ratio,
        "int8_vs_bf16": int8_vs_bf16,
    }, held


def _job_prompt(eng, args, i: int) -> list:
    """The phases' prompt ``i`` (the main jobs' shape)."""
    return [(13 * i + j) % eng.cfg.vocab_size for j in range(args.prompt_len)]


def _run_overload_phase(eng, args, baseline_tps: float) -> dict:
    """OVERLOAD phase: a 2x sustained storm of mixed priorities through the
    same engine with an overload controller installed (submit-side shedding
    off, so the shed ledger isolates the deadline path).  High-priority
    TTFT p99 unloaded against during the storm, the goodput ratio (tokens
    inside their deadline over all emitted), the sheds, and whether the
    sheds returned every page (``pool_exact``).  The storm sizes itself
    from the measured decode rate: low-priority deadlines are half its
    expected drain, so its tail must shed."""
    from .engine_overload import OverloadConfig, OverloadController

    eng.overload = OverloadController(
        eng.max_slots, OverloadConfig(target_queue_wait_s=0.25, shed_wait_factor=1e9),
        metrics=eng.metrics, flight=eng.flight,
    )
    n_new = args.decode_tokens
    # Warm the admission-burst shapes a mixed storm can hit (2- and 3-wide).
    eng.run([(_job_prompt(eng, args, 90 + i), 2) for i in range(2)])
    eng.run([(_job_prompt(eng, args, 94 + i), 2) for i in range(3)])

    def _ttft_p99(reqs):
        return _q(_ttfts(reqs), 0.99)

    unloaded = []
    for i in range(4):
        unloaded += eng.run([(_job_prompt(eng, args, i), n_new)], priority=0)
    hi_unloaded = _ttft_p99(unloaded)
    n_hi, n_norm, n_low = eng.max_slots, 2 * eng.max_slots, 2 * eng.max_slots
    est_drain_s = ((n_hi + n_norm + n_low) * n_new) / max(baseline_tps, 1.0)
    low_deadline_s = max(est_drain_s / 2, 0.05)
    goodput0, raw0 = eng.overload.goodput_tokens, eng.overload.raw_tokens
    sheds0 = eng.overload.sheds_total
    storm, hi_reqs = [], []
    for i in range(n_norm):
        storm.append(eng.submit(_job_prompt(eng, args, 10 + i), n_new, priority=1,
                                tenant="norm"))
    for i in range(n_low):
        storm.append(eng.submit(_job_prompt(eng, args, 30 + i), n_new, priority=2,
                                tenant="low", deadline_s=low_deadline_s))
    for i in range(n_hi):
        req = eng.submit(_job_prompt(eng, args, 50 + i), n_new, priority=0, tenant="hi")
        storm.append(req)
        hi_reqs.append(req)
    t0 = time.perf_counter()
    guard = 0
    while not all(r.done for r in storm):
        eng.step()
        guard += 1
        if guard > 200_000:
            raise RuntimeError("overload storm failed to drain")
    storm_s = time.perf_counter() - t0
    hi_storm = _ttft_p99(hi_reqs)
    sheds = eng.overload.sheds_total - sheds0
    goodput = eng.overload.goodput_tokens - goodput0
    raw = eng.overload.raw_tokens - raw0
    pool_exact = (len(eng.free_pages) == eng.paged.num_pages - 1
                  and all(s is None for s in eng.slots))
    ratio = (hi_storm / hi_unloaded) if hi_unloaded and hi_storm else None
    block = {
        "storm_requests": len(storm),
        "storm_seconds": round(storm_s, 2),
        "low_deadline_s": round(low_deadline_s, 3),
        "hi_ttft_p99_unloaded_ms": round(hi_unloaded * 1e3, 3) if hi_unloaded else None,
        "hi_ttft_p99_storm_ms": round(hi_storm * 1e3, 3) if hi_storm else None,
        "hi_ttft_p99_ratio": round(ratio, 3) if ratio else None,
        "goodput_tokens": goodput,
        "raw_tokens": raw,
        "goodput_ratio": round(goodput / raw, 3) if raw else None,
        "sheds": sheds,
        "sheds_by_kind": dict(eng.overload.shed_counts),
        "limit_final": round(eng.overload.limit, 2),
        "pool_exact": pool_exact,
    }
    log(f"perf-ledger row: | OVERLOAD control (b{eng.max_slots}, {len(storm)}-req storm) | "
        f"hi-pri TTFT p99 {block['hi_ttft_p99_unloaded_ms']} -> {block['hi_ttft_p99_storm_ms']} "
        f"ms ({block['hi_ttft_p99_ratio']}x), goodput {block['goodput_ratio']}, {sheds} sheds, "
        f"pool exact {pool_exact} | - | `benchmark.py --model serving` | update on bench round |")
    eng.overload = None  # the next phase expects none
    return block


def _run_slo_phase(eng, args) -> dict:
    """SLO phase: the same jobs with the SLO plane detached, then attached
    (a host-side toggle); the per-token cost difference is the accounting
    overhead.  A synthetic burn on the live tracker must fire the fast-burn
    page rule."""
    from ..utils.slo import SLOTracker, UsageMeter

    jobs = [(_job_prompt(eng, args, 120 + i), args.decode_tokens)
            for i in range(2 * eng.max_slots)]
    eng.slo = eng.usage = None
    t0 = time.perf_counter()
    off_tokens = sum(len(r.tokens) for r in eng.run(jobs))
    off_dt = time.perf_counter() - t0
    eng.slo, eng.usage = SLOTracker(), UsageMeter()
    t0 = time.perf_counter()
    on_tokens = sum(len(r.tokens) for r in eng.run(jobs))
    on_dt = time.perf_counter() - t0
    off_tps = off_tokens / off_dt if off_dt else 0.0
    on_tps = on_tokens / on_dt if on_dt else 0.0
    overhead = (off_tps / on_tps) - 1.0 if on_tps else 0.0
    verdicts = sum(pair[1] for pair in eng.slo.totals().values())
    tenants_metered = eng.usage.snapshot()["tracked_tenants"]
    # A sustained burn (half the availability verdicts bad, budget 0.001).
    eng.slo.record("availability", True, n=50)
    eng.slo.record("availability", False, n=50)
    burn_alert_fired = any(t["state"] == "fired" and t["rule"] == "fast_burn"
                           for t in eng.slo.evaluate())
    eng.slo = eng.usage = None  # the next phase expects none
    block = {
        "overhead": round(overhead, 4),
        "off_tokens_per_sec": round(off_tps, 2),
        "on_tokens_per_sec": round(on_tps, 2),
        "sli_verdicts": verdicts,
        "tenants_metered": tenants_metered,
        "burn_alert_fired": burn_alert_fired,
    }
    log(f"perf-ledger row: | SLO accounting (b{eng.max_slots}) | slo off {off_tps:.2f} -> on "
        f"{on_tps:.2f} tokens/sec (overhead {overhead * 100.0:+.2f}%; {verdicts} verdicts, burn "
        f"alert fired {burn_alert_fired}) | - | `benchmark.py --model serving` | update on "
        "bench round |")
    return block


def _prefix_sessions(eng, args, first: int, stride: int, tail0: int) -> Optional[tuple]:
    """Four sessions sharing a full-page prompt prefix (tokens from
    ``first``), their tails from ``tail0 + stride * s``; None when the
    prompt holds no full page."""
    page = eng.paged.page_size
    pl = (args.prompt_len // page) * page
    if pl < page:
        return None
    prefix = [(first + j) % eng.cfg.vocab_size for j in range(pl)]
    return pl, [prefix + [(tail0 + stride * s + j) % eng.cfg.vocab_size
                          for j in range(args.prompt_len - pl)] for s in range(4)]


def _warm_tiers(eng, sessions, n_new: int) -> None:
    """Serve the sessions, spill the retained tier into the host arena, and
    run one restore, so the timed passes meet no first-use work."""
    eng.kvcache_clear()
    for s in sessions:
        eng.run([(s, n_new)])
    with eng._lock:
        eng._kv_reclaim(len(eng._kv_retained))
    eng.run([(sessions[0], n_new)])


def _serial_pass(eng, sessions, n_new: int) -> tuple:
    """The sessions one at a time (TTFT is prefill, not queueing): (sorted
    TTFTs, host hits, pages restored)."""
    hits0, restores0 = eng.kv_host_hits, eng.kv_restores
    reqs = [eng.run([(s, n_new)])[0] for s in sessions]
    return _ttfts(reqs), eng.kv_host_hits - hits0, eng.kv_restores - restores0


def _run_restart_phase(eng, args) -> dict:
    """RESTART phase: cold against warm post-restart TTFT through the
    arena snapshot (engine_snapshot.py).  The restart is modelled on the
    same engine: ``kvcache_clear()`` is the serving state a process death
    loses; warm then loads the snapshot saved after the warm-up."""
    import tempfile

    from .engine_snapshot import load_arena_snapshot, save_arena_snapshot

    got = _prefix_sessions(eng, args, 17, 3, 70)
    if got is None:
        return {"skipped": f"prompt_len {args.prompt_len} < one page ({eng.paged.page_size})"}
    pl, sessions = got
    n_new = args.decode_tokens
    _warm_tiers(eng, sessions, n_new)
    path = f"{tempfile.mkdtemp(prefix='kv-restart-')}/kv_arena.snapshot"
    saved = save_arena_snapshot(eng, path, trigger="bench")
    if not saved.get("ok"):
        return {"skipped": f"snapshot save failed: {saved.get('reason')}"}
    eng.kvcache_clear()
    cold, cold_hits, _ = _serial_pass(eng, sessions, n_new)
    eng.kvcache_clear()
    loaded = load_arena_snapshot(eng, path)
    warm, warm_hits, restored_pages = _serial_pass(eng, sessions, n_new)
    eng.kvcache_clear()
    cold_p99, warm_p99 = _q(cold, 0.99), _q(warm, 0.99)
    block = {
        "sessions": len(sessions),
        "prefix_tokens": pl,
        "snapshot_bytes": saved["bytes"],
        "snapshot_entries": saved["entries"],
        "entries_loaded": loaded.get("restored", 0),
        "cold": {"ttft_p50_ms": _ms(_q(cold, 0.5)), "ttft_p99_ms": _ms(cold_p99),
                 "prefix_hits": cold_hits},
        "warm": {"ttft_p50_ms": _ms(_q(warm, 0.5)), "ttft_p99_ms": _ms(warm_p99),
                 "prefix_hits": warm_hits, "restored_pages": restored_pages},
        "warm_speedup": round(cold_p99 / warm_p99, 3) if warm_p99 else None,
    }
    log(f"perf-ledger row: | RESTART warm vs cold (b{eng.max_slots}, {len(sessions)} sessions) "
        f"| post-restart TTFT p99 cold {block['cold']['ttft_p99_ms']} -> warm "
        f"{block['warm']['ttft_p99_ms']} ms ({block['warm_speedup']}x; {restored_pages} pages "
        f"restored, {block['entries_loaded']} arena entries, snapshot {saved['bytes']} B) | - | "
        "`benchmark.py --model serving` | update on bench round |")
    return block


def _run_elastic_phase(eng, args) -> dict:
    """ELASTIC phase: cold join against a peer-warmed join.  The donor is
    the same engine after a shared-prefix session set, its state encoded as
    ``GET /debug/snapshot`` streams it; a cold join clears every tier, a
    warmed one clears them and admits the donor's bytes through the fetch
    path's parse, verify and admit (minus the socket)."""
    import io

    from . import engine_snapshot as snap_mod

    got = _prefix_sessions(eng, args, 23, 5, 90)
    if got is None:
        return {"skipped": f"prompt_len {args.prompt_len} < one page ({eng.paged.page_size})"}
    pl, sessions = got
    n_new = args.decode_tokens
    _warm_tiers(eng, sessions, n_new)
    with eng._lock:
        layout = snap_mod.snapshot_layout(eng)
    fingerprint = eng.params_fingerprint
    entries = snap_mod.collect_entries(eng)
    wire = b"".join(snap_mod.encode_snapshot(layout, fingerprint, entries))
    eng.kvcache_clear()
    cold, cold_hits, _ = _serial_pass(eng, sessions, n_new)
    eng.kvcache_clear()
    _, parsed = snap_mod._parse_snapshot(io.BytesIO(wire), layout, fingerprint)
    restored_entries = snap_mod._admit_entries(eng, parsed)
    warm, warm_hits, restored_pages = _serial_pass(eng, sessions, n_new)
    eng.kvcache_clear()
    cold_p99, warm_p99 = _q(cold, 0.99), _q(warm, 0.99)
    block = {
        "sessions": len(sessions),
        "prefix_tokens": pl,
        "wire_bytes": len(wire),
        "entries": len(entries),
        "entries_restored": restored_entries,
        "cold_join": {"ttft_p50_ms": _ms(_q(cold, 0.5)), "ttft_p99_ms": _ms(cold_p99),
                      "prefix_hits": cold_hits},
        "warmed_join": {"ttft_p50_ms": _ms(_q(warm, 0.5)), "ttft_p99_ms": _ms(warm_p99),
                        "prefix_hits": warm_hits, "restored_pages": restored_pages},
        "warmed_speedup": round(cold_p99 / warm_p99, 3) if warm_p99 else None,
    }
    log(f"perf-ledger row: | ELASTIC cold vs peer-warmed join (b{eng.max_slots}, "
        f"{len(sessions)} sessions) | join TTFT p99 cold {block['cold_join']['ttft_p99_ms']} -> "
        f"warmed {block['warmed_join']['ttft_p99_ms']} ms ({block['warmed_speedup']}x; "
        f"{restored_entries} entries / {restored_pages} pages restored over {len(wire)} wire "
        "bytes) | - | `benchmark.py --model serving` | update on bench round |")
    return block


def _run_disagg_phase(eng, args, params: dict) -> tuple[dict, int]:
    """DISAGG phase: decode ITL p99 (per-step wall) of chatty traffic alone,
    with long prompts injected into the same loop every 24 steps (the
    unified control), and on a decode-role engine fed the long prompts'
    pages through the handoff wire at twice that rate.  The decode engine's
    tokens for the injected prompts must equal the unified engine's
    (greedy).  Keeps the reference's sizing: the chatty requests take
    ``max(decode_tokens, 6 * 24 // n_chatty)`` tokens, which a small paged
    window can refuse.  Returns the ``disagg`` block and the decode-role
    engine's dispatched device steps."""
    import io

    from ..utils.metrics import MetricsRegistry
    from . import engine_handoff as handoff_mod
    from . import engine_snapshot as snap_mod
    from .engine import ServingEngine
    from .engine_types import EngineMetrics

    page = eng.paged.page_size
    long_new = 4
    long_len = ((eng.paged.max_len - long_new - 2) // page) * page
    if long_len < 2 * page or long_len <= args.prompt_len:
        return {"skipped": f"max_len {eng.paged.max_len} leaves no room for a long prompt"}, 0
    chatty_prompts = [_job_prompt(eng, args, i) for i in range(max(2, args.slots - 1))]
    long_prompts = [[(17 * i + 29 + j) % eng.cfg.vocab_size for j in range(long_len)]
                    for i in range(8)]
    interval = 24  # steps between injected long prompts (the control's rate)
    chatty_new = max(args.decode_tokens, 6 * interval // len(chatty_prompts))

    def _measure(engine, inject=None):
        """(per-step wall p99, injected requests): every active chatty slot
        emits one token a step, so a step's wall is that token's gap."""
        gaps: list[float] = []
        reqs = [engine.submit(p, chatty_new) for p in chatty_prompts]
        injected = []
        steps = 0
        while any(not r.done for r in reqs):
            t0 = time.perf_counter()
            engine.step()
            gaps.append(time.perf_counter() - t0)
            steps += 1
            if inject is not None:
                got = inject(steps)
                if got is not None:
                    injected.append(got)
        guard = 0
        while any(not r.done for r in injected):
            engine.step()
            guard += 1
            if guard > 50_000:
                raise RuntimeError("disagg phase failed to drain")
        return _q(sorted(gaps), 0.99), injected

    prev_chunk = eng._prefill_chunk
    eng._prefill_chunk = page * 2

    def _warm_mixed(engine, pre_admit=None):
        """Untimed: the measured traffic's shape, the long admission in the
        same slot beside the same chatty slots."""
        reqs = [engine.submit(p, 8) for p in chatty_prompts]
        long_req = None
        steps = 0
        while any(not r.done for r in reqs) or (long_req is not None and not long_req.done):
            engine.step()
            steps += 1
            if steps == 2:
                if pre_admit is not None:
                    pre_admit()
                long_req = engine.submit(long_prompts[0], long_new)
        engine.kvcache_clear()

    eng.kvcache_clear()
    dec = None
    try:
        _warm_mixed(eng)
        itl_unloaded, _ = _measure(eng)

        def inject_unified(step, _next=[0]):
            if step % interval or _next[0] >= len(long_prompts) // 2:
                return None
            prompt = long_prompts[_next[0]]
            _next[0] += 1
            return eng.submit(prompt, long_new)

        itl_unified, _ = _measure(eng, inject_unified)
        dec = ServingEngine(
            dataclasses.replace(eng.cfg, paged=None), params, eng.paged,
            max_slots=eng.max_slots, metrics=EngineMetrics(MetricsRegistry()),
            prefill_chunk=page * 2, kv_retain=True, kv_host_cache_mb=64, role="decode",
            device=eng.device,
        )
        eng.kvcache_clear()
        with eng._lock:
            layout = snap_mod.snapshot_layout(eng)
        fingerprint = eng.params_fingerprint
        wires, oracle_tokens = [], []
        for prompt in long_prompts:
            # The unified run is the local-prefill oracle; the wire is a
            # real prefill probe's (the tap /v1/prefill serves).
            oracle_tokens.append(list(eng.run([(prompt, long_new)])[0].tokens))
            tap = eng.handoff_begin(prompt, None)
            entries = []
            try:
                for _ in range(10_000):
                    eng.step()
                    while True:
                        e = tap.pop(0.0)
                        if e is None:
                            break
                        entries.append(e)
                    if tap.req.done and tap.pushed <= len(entries):
                        break
            finally:
                eng.handoff_end(tap)
            wires.append(
                snap_mod.encode_preamble(layout, fingerprint, len(entries))
                + b"".join(snap_mod.encode_entry(layout, k, r) for k, r in entries)
                + (handoff_mod.encode_logits_section(tap.logits) if tap.logits is not None
                   else b"")
            )
            eng.kvcache_clear()

        def _admit_wire(idx):
            buf = io.BytesIO(wires[idx])
            _, parsed = snap_mod._parse_snapshot(buf, layout, fingerprint)
            admitted = snap_mod._admit_entries(dec, parsed)
            logits = handoff_mod.read_logits_section(buf)
            if logits is not None:
                with dec._lock:
                    dec._kv_arena.put(("logits", dec._trie_root(None), tuple(long_prompts[idx])),
                                      {"logits": logits}, logits.nbytes)
            return admitted

        dec.run([(chatty_prompts[0], 2)])
        _warm_mixed(dec, pre_admit=lambda: _admit_wire(0))
        if dec.handoff_skipped_tokens <= 0:
            raise RuntimeError("disagg warm-up never skipped covered prefill")
        handoff_entries = 0

        def inject_disagg(step, _next=[0]):
            nonlocal handoff_entries
            if step % (interval // 2) or _next[0] >= len(long_prompts) // 2:
                return None
            idx = _next[0]
            _next[0] += 1
            handoff_entries += _admit_wire(idx)
            return dec.submit(long_prompts[idx], long_new)

        itl_disagg, disagg_long = _measure(dec, inject_disagg)
        tokens_match = bool(disagg_long) and (
            [list(r.tokens) for r in disagg_long] == oracle_tokens[: len(disagg_long)])
    finally:
        eng._prefill_chunk = prev_chunk
        eng.kvcache_clear()

    def _ratio(loaded):
        return round(loaded / itl_unloaded, 3) if loaded and itl_unloaded else None

    block = {
        "prefill_jobs": len(long_prompts) // 2,
        "long_prompt_tokens": long_len,
        "itl_p99_unloaded_ms": _ms(itl_unloaded),
        "unified": {"itl_p99_loaded_ms": _ms(itl_unified), "ratio": _ratio(itl_unified)},
        "disagg": {
            "itl_p99_loaded_ms": _ms(itl_disagg),
            "ratio": _ratio(itl_disagg),
            "handoff_entries": handoff_entries,
            "skipped_prefill_tokens": dec.handoff_skipped_tokens,
            "tokens_match": tokens_match,
        },
    }
    log(f"perf-ledger row: | DISAGG prefill/decode split (b{eng.max_slots}, {long_len}-token "
        f"prefills) | decode ITL p99 {block['itl_p99_unloaded_ms']} ms unloaded -> unified "
        f"{block['unified']['itl_p99_loaded_ms']} ({block['unified']['ratio']}x) vs disagg "
        f"{block['disagg']['itl_p99_loaded_ms']} ms at 2x prefill load "
        f"({block['disagg']['ratio']}x; {handoff_entries} entries shipped, "
        f"{dec.handoff_skipped_tokens} prefill tokens skipped, tokens "
        f"{'bit-identical' if tokens_match else 'DIVERGED'}) | - | `benchmark.py --model "
        "serving` | update on bench round |")
    return block, dec.device_steps


# The router-side phases: tiny replicas behind the port's router/ and
# controller/ (the reference's sizes, seeds and traffic).
ROUTER_PAGE = 4  # one prefix block = one KV page of the tiny replicas


def _tiny_replicas(args, seeds, **engine_kw) -> tuple[list, list]:
    """(servers, engines): one started ``EngineServer`` (ephemeral port,
    admin routes on) per seed, over ``GPTConfig.tiny()`` at max_seq 64, page
    4, 64 pages, 4 slots on ``args.device``, weights ``init_params(cfg,
    seed)``; ``engine_kw`` goes to every ``ServingEngine``."""
    from ..utils.metrics import MetricsRegistry
    from .engine import ServingEngine
    from .engine_types import EngineMetrics
    from .http_server import EngineServer
    from .transformer import PagedConfig

    device = resolve_device(args.device)
    cfg = dataclasses.replace(GPTConfig.tiny(), max_seq=64)
    paged = PagedConfig(ROUTER_PAGE, num_pages=64, max_pages_per_seq=16)
    servers, engines = [], []
    for seed in seeds:
        registry = MetricsRegistry()
        engine = ServingEngine(cfg, init_params(cfg, seed), paged, max_slots=4,
                               metrics=EngineMetrics(registry), device=device, **engine_kw)
        engines.append(engine)
        servers.append(EngineServer(engine, host="127.0.0.1", port=0, registry=registry,
                                    enable_admin=True).start())
    return servers, engines


def _post_replica(port: int, prompt, max_new: int) -> None:
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({"prompt": prompt, "max_new_tokens": max_new}).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        resp.read()


def _warm_replicas(servers, prompt_len: int) -> None:
    """One server at a time, bursts of 1 to 4 concurrent ``prompt_len``-token
    requests: every (batch, prompt) shape the replay admits, and every
    decode dispatch (a CUDA graph on the card) captured before any timed
    pass."""
    import threading

    for server in servers:
        for group in (1, 2, 3, 4):
            threads = [threading.Thread(target=_post_replica,
                                        args=(server.port, [7 + g] * prompt_len, 6))
                       for g in range(group)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()


def _ttft_p99_ms(router, snap):
    return _ms(router.metrics.ttft_seconds.quantile(0.99, since=snap))


def _run_router_phase(args) -> tuple[Optional[dict], int]:
    """ROUTER phase: prefix-affinity routing against a random-placement
    control over the same seeded multi-session traffic, K tiny replicas
    behind the router.  The hit rate is the replicas' KV-tier hits
    (retained + host arena) per routed request; TTFT p99 is the router's
    own first-token histogram.  Both passes run over the same replicas
    with the tiers cleared between, affinity first, so residual warmth
    favours the control.  Returns the ``router`` block (None below 2
    replicas) and the replicas' dispatched device steps."""
    from ..router.server import RouterServer
    from .traffic import RouterTraffic

    n_replicas = args.router_replicas
    if n_replicas < 2:
        return None, 0
    servers, engines = _tiny_replicas(args, range(n_replicas), kv_retain=True,
                                      kv_host_cache_mb=16)
    _warm_replicas(servers, 18)
    names = [f"127.0.0.1:{s.port}" for s in servers]
    # More sessions than replicas: random placement pays a cold prefix
    # graft on every extra replica a session touches, affinity one.
    sessions, prefix_len, n_requests = 8, 16, 32

    def kv_hits():
        return sum(e.kv_retained_hits + e.kv_host_hits for e in engines)

    def measure(mode):
        router = RouterServer(names, host="127.0.0.1", port=0, prefix_block_tokens=ROUTER_PAGE,
                              prefix_max_blocks=prefix_len // ROUTER_PAGE, poll_interval_s=0.2,
                              hedge=False, policy_mode=mode, seed=3).start()
        try:
            traffic = RouterTraffic("127.0.0.1", router.port, seed=17, sessions=sessions,
                                    prefix_len=prefix_len, vocab=engines[0].cfg.vocab_size)
            # A warm pass of the same seed (the same shapes), then every
            # tier cleared so the measured pass starts cold.
            traffic.run(n_requests, concurrency=4, suffix_len=(1, 4), max_new=(4, 8))
            for engine in engines:
                engine.kvcache_clear()
            hits0, snap = kv_hits(), router.metrics.ttft_seconds.snapshot()
            report = traffic.run(n_requests, concurrency=4, suffix_len=(1, 4), max_new=(4, 8))
            placements = {key: router.metrics.placements.value(placement=key)
                          for key in ("home", "overflow", "random", "failover")}
            return {
                "prefix_hits": kv_hits() - hits0,
                "hit_rate": round((kv_hits() - hits0) / n_requests, 3),
                "ttft_p99_ms": _ttft_p99_ms(router, snap),
                "home_rate": round(placements["home"] / max(1, sum(placements.values())), 3),
                "dropped": report.dropped,
                "failovers": int(router.metrics.failovers.value()),
                "retries": int(router.metrics.retries.value()),
            }
        finally:
            router.stop()

    try:
        affinity = measure("affinity")
        random_ctl = measure("random")
    finally:
        for server in servers:
            server.stop()
    block = {"replicas": n_replicas, "requests": n_requests, "sessions": sessions,
             "affinity": affinity, "random": random_ctl}
    log(f"perf-ledger row: | ROUTER prefix-affinity (K={n_replicas}, {sessions} sessions) | "
        f"affinity {affinity['hit_rate']:.2f} KV hits/req, TTFT p99 {affinity['ttft_p99_ms']} ms "
        f"(home rate {affinity['home_rate']:.2f}) vs random {random_ctl['hit_rate']:.2f} "
        f"hits/req, {random_ctl['ttft_p99_ms']} ms | - | `benchmark.py --model serving` | "
        "update on bench round |")
    return block, sum(e.device_steps for e in engines)


def _run_fabric_phase(args) -> tuple[Optional[dict], int]:
    """FABRIC phase: the fleet KV fabric (``router/fabric.py``) against an
    affinity-only control over the same seeded traffic, every session
    opening with one shared system prompt, on at least 3 replicas with
    identical weights (the handoff's fingerprint check refuses KV across
    others).  With the fabric the shared prefix is prefilled once and the
    other replicas pull it: fleet KV hits per request must beat the
    control's, at no TTFT cost.  The fabric pass runs first; the control
    waits the locator-settle time the fabric pass measured.  Returns the
    ``fabric`` block (None below 2 router replicas) and the replicas'
    dispatched device steps."""
    from ..router.fabric import FabricConfig
    from ..router.server import RouterServer
    from .traffic import RouterTraffic

    if args.router_replicas < 2:
        return None, 0
    # With three, affinity alone cannot keep the shared prompt hot on
    # every replica, so the control pays the recompute the fabric avoids.
    n_replicas = max(3, args.router_replicas)
    servers, engines = _tiny_replicas(args, [0] * n_replicas, kv_retain=True,
                                      kv_host_cache_mb=16)
    _warm_replicas(servers, 36)
    names = [f"127.0.0.1:{s.port}" for s in servers]
    # A 16-token system prompt shared by every session and a 16-token
    # unique tail: affinity homes sessions apart, the fabric dedups the head.
    sessions, prefix_len, shared_len, n_requests = 8, 32, 16, 32

    def kv_hits():
        return sum(e.kv_retained_hits + e.kv_host_hits for e in engines)

    def pulls():
        return sum(e.handoff_fetches for e in engines)

    def measure(use_fabric, settle_s):
        router = RouterServer(names, host="127.0.0.1", port=0, prefix_block_tokens=ROUTER_PAGE,
                              prefix_max_blocks=prefix_len // ROUTER_PAGE, poll_interval_s=0.2,
                              hedge=False, policy_mode="affinity", seed=3, fabric=use_fabric,
                              fabric_config=FabricConfig(default_page_size=ROUTER_PAGE)).start()
        try:
            traffic = RouterTraffic("127.0.0.1", router.port, seed=17, sessions=sessions,
                                    prefix_len=prefix_len, shared_prefix_len=shared_len,
                                    vocab=engines[0].cfg.vocab_size)
            traffic.run(n_requests, concurrency=4, suffix_len=(1, 4), max_new=(4, 8))
            for engine in engines:
                engine.kvcache_clear()
            # One owner of the shared prompt, placed through the router as
            # production would; the locator then settles on the truth:
            # exactly that owner advertises, the rest read empty.
            t0 = time.monotonic()
            _post_replica(router.port, traffic.prefixes[0][:shared_len], 4)
            if use_fabric:
                deadline = time.monotonic() + 10.0
                while time.monotonic() < deadline:
                    roots = router.fabric.advertised_roots()
                    if sum(1 for v in roots.values() if v) == 1:
                        break
                    time.sleep(0.05)
                settle_s = time.monotonic() - t0
            else:
                time.sleep(max(0.0, settle_s - (time.monotonic() - t0)))
            hits0, pulls0 = kv_hits(), pulls()
            snap = router.metrics.ttft_seconds.snapshot()
            report = traffic.run(n_requests, concurrency=4, suffix_len=(1, 4), max_new=(4, 8))
            return {
                "fleet_hits": kv_hits() - hits0,
                "hit_rate": round((kv_hits() - hits0) / n_requests, 3),
                "ttft_p99_ms": _ttft_p99_ms(router, snap),
                "cross_peer_pulls": pulls() - pulls0,
                "dropped": report.dropped,
            }, settle_s
        finally:
            router.stop()

    try:
        fabric_run, settle_s = measure(True, 0.0)
        control, _ = measure(False, settle_s)
    finally:
        for server in servers:
            server.stop()
    block = {"replicas": n_replicas, "requests": n_requests, "sessions": sessions,
             "shared_prefix_len": shared_len, "fabric": fabric_run, "control": control}
    log(f"perf-ledger row: | FABRIC fleet KV (K={n_replicas}, {sessions} sessions, shared "
        f"{shared_len}) | fabric {fabric_run['hit_rate']:.2f} KV hits/req, TTFT p99 "
        f"{fabric_run['ttft_p99_ms']} ms, {fabric_run['cross_peer_pulls']} cross-peer pulls vs "
        f"control {control['hit_rate']:.2f} hits/req, {control['ttft_p99_ms']} ms | - | "
        "`benchmark.py --model serving` | update on bench round |")
    return block, sum(e.device_steps for e in engines)


def _client_pass(router_port: int, seed: int, vocab: int):
    """(tokens/s, report): a warm pass of 8 requests, then 24 measured, over
    4 sessions of a 16-token prefix (the canary and postmortem passes)."""
    from .traffic import RouterTraffic

    traffic = RouterTraffic("127.0.0.1", router_port, seed=seed, sessions=4, prefix_len=16,
                            vocab=vocab)
    traffic.run(8, concurrency=4, suffix_len=(1, 4), max_new=(4, 8))
    report = traffic.run(24, concurrency=4, suffix_len=(1, 4), max_new=(4, 8))
    return report.tokens / max(report.duration_s, 1e-9), report


def _run_canary_phase(args) -> tuple[Optional[dict], int]:
    """CANARY phase: the canary prober's (``router/prober.py``) overhead,
    client tokens/s through the router with the prober at an aggressive
    interval against it off (prober on first, so warmth favours the
    control), and its detection self-check: the ``engine.readback=corrupt``
    failpoint flips one token byte of every readback and the prober must
    call the mismatch and fence.  Returns the ``canary`` block (None below
    2 router replicas) and the replicas' dispatched device steps."""
    from ..router.prober import CanaryConfig
    from ..router.server import RouterServer
    from ..utils import failpoints

    if args.router_replicas < 2:
        return None, 0
    servers, engines = _tiny_replicas(args, (100, 101))
    _warm_replicas(servers, 18)
    for server in servers:
        _post_replica(server.port, [11, 13, 17, 19], 4)  # the probe's own shape
    names = [f"127.0.0.1:{s.port}" for s in servers]
    canary_cfg = CanaryConfig(interval_s=0.25, probe_tokens=4, prompts=((11, 13, 17, 19),),
                              k_mismatch=2, fence=True)

    def start(canary_on):
        return RouterServer(names, host="127.0.0.1", port=0, prefix_block_tokens=ROUTER_PAGE,
                            prefix_max_blocks=4, poll_interval_s=0.2, hedge=False, seed=3,
                            canary=canary_on, canary_config=canary_cfg).start()

    try:
        router_on = start(True)
        try:
            tps_on, report_on = _client_pass(router_on.port, 23, engines[0].cfg.vocab_size)
            probes = sum(row["probes"]
                         for row in router_on.prober.snapshot()["replicas"].values())
            # Every readback corrupted: the still-running prober must call
            # the mismatch and fence.
            failpoints.arm_spec("engine.readback=corrupt")
            mismatch_detected, fences = False, 0
            try:
                deadline = time.monotonic() + 15.0
                while time.monotonic() < deadline:
                    fences = router_on.prober.snapshot()["fences_fired"]
                    if fences >= 1:
                        mismatch_detected = True
                        break
                    time.sleep(0.1)
            finally:
                failpoints.disarm("engine.readback")
        finally:
            router_on.stop()
        for server in servers:
            server.unfence()
        router_off = start(False)
        try:
            tps_off, report_off = _client_pass(router_off.port, 23, engines[0].cfg.vocab_size)
        finally:
            router_off.stop()
    finally:
        for server in servers:
            server.stop()
    overhead = max(0.0, 1.0 - tps_on / tps_off) if tps_off else None
    block = {
        "replicas": 2,
        "interval_s": canary_cfg.interval_s,
        "tokens_per_sec_canary": round(tps_on, 2),
        "tokens_per_sec_control": round(tps_off, 2),
        "overhead": round(overhead, 4) if overhead is not None else None,
        "probes": probes,
        "dropped": report_on.dropped + report_off.dropped,
        "mismatch_detected": mismatch_detected,
        "fences": fences,
    }
    log(f"perf-ledger row: | CANARY active probing (interval {canary_cfg.interval_s:.2f}s) | "
        f"overhead {block['overhead']} ({tps_on:.2f} vs {tps_off:.2f} tokens/sec, {probes} "
        f"probes); injected corruption {'detected+fenced' if mismatch_detected else 'MISSED'} "
        f"({fences} fences) | - | `benchmark.py --model serving` | update on bench round |")
    return block, sum(e.device_steps for e in engines)


def _postmortem_tool():
    """The repository's ``tools/postmortem.py`` (stdlib only), loaded by path
    as the reference's phase loads it: the bundle's classifier."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    spec = importlib.util.spec_from_file_location(
        "postmortem_tool", os.path.join(root, "tools", "postmortem.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _run_postmortem_phase(args) -> tuple[Optional[dict], int]:
    """POSTMORTEM phase: the fleet postmortem collector's
    (``router/postmortem.py``) overhead, client tokens/s through the router
    with the collector armed against it off (armed first), and its
    self-check: a watchdog-source fence incident on one replica must ride
    the summary poll into one fleet bundle that ``tools/postmortem.py``
    classifies ``watchdog_hang`` from disk.  Returns the ``postmortem``
    block (None below 2 router replicas) and the replicas' dispatched
    device steps."""
    import shutil

    from ..router.server import RouterServer

    if args.router_replicas < 2:
        return None, 0
    pm_tool = _postmortem_tool()
    servers, engines = _tiny_replicas(args, (200, 201))
    _warm_replicas(servers, 18)
    names = [f"127.0.0.1:{s.port}" for s in servers]
    dump_dir = tempfile.mkdtemp(prefix="bench-postmortem-")

    def start(postmortem_on):
        return RouterServer(names, host="127.0.0.1", port=0, prefix_block_tokens=ROUTER_PAGE,
                            prefix_max_blocks=4, poll_interval_s=0.2, hedge=False, seed=3,
                            postmortem=postmortem_on, postmortem_dir=dump_dir).start()

    try:
        router_on = start(True)
        try:
            tps_on, report_on = _client_pass(router_on.port, 29, engines[0].cfg.vocab_size)
            # What the hung-step watchdog emits on replica 0: the flight
            # event and the discrete incident.
            victim = servers[0].engine
            victim.flight.record("engine.fenced", reason="hung_step", source="watchdog")
            victim.anomaly.report("engine.fenced", reason="hung_step", source="watchdog")
            bundle_found, root_cause = False, None
            deadline = time.monotonic() + 20.0
            while time.monotonic() < deadline:
                if router_on.postmortem.captures >= 1:
                    bundle_found = True
                    break
                time.sleep(0.1)
            captures = router_on.postmortem.captures
            if bundle_found:
                loaded = pm_tool.load_bundle(router_on.postmortem.last_bundle)
                timeline = pm_tool.build_timeline(loaded["components"])
                root_cause = pm_tool.classify(timeline)["root_cause"]
        finally:
            router_on.stop()
        router_off = start(False)
        try:
            tps_off, report_off = _client_pass(router_off.port, 29, engines[0].cfg.vocab_size)
        finally:
            router_off.stop()
    finally:
        for server in servers:
            server.stop()
        shutil.rmtree(dump_dir, ignore_errors=True)
    overhead = max(0.0, 1.0 - tps_on / tps_off) if tps_off else None
    rootcause_ok = root_cause == "watchdog_hang"
    block = {
        "replicas": 2,
        "tokens_per_sec_postmortem": round(tps_on, 2),
        "tokens_per_sec_control": round(tps_off, 2),
        "overhead": round(overhead, 4) if overhead is not None else None,
        "dropped": report_on.dropped + report_off.dropped,
        "captures": captures,
        "bundle_found": bundle_found,
        "root_cause": root_cause,
        "rootcause_ok": rootcause_ok,
    }
    log(f"perf-ledger row: | POSTMORTEM fleet capture | overhead {block['overhead']} "
        f"({tps_on:.2f} vs {tps_off:.2f} tokens/sec); injected watchdog fence "
        f"{'captured' if bundle_found else 'MISSED'} ({captures} bundles, classified "
        f"{root_cause if rootcause_ok else f'WRONG ({root_cause})'}) | - | `benchmark.py "
        "--model serving` | update on bench round |")
    return block, sum(e.device_steps for e in engines)


def _run_autoscale_phase(args) -> dict:
    """AUTOSCALE phase: the fleet controller (``controller/``: the real
    ``Reconciler`` and ``FleetSimActuator`` on a fake clock) against a
    static fleet provisioned for the peak, over one deterministic
    600-sim-second diurnal plus flash-crowd demand trace.  Replica-minutes
    come from each fleet's accrual (serving and warming replicas billed);
    TTFT is a fluid-queue model, a backlog drained at ``cap_rps`` a serving
    replica plus an M/M/1 in-service wait, and a sim-second above
    ``slo_ms`` is a violation.  No RNG, no wall time, no device: the block
    is exactly reproducible (``tools/bench_diff.py`` gates
    REPLICA-MINUTES-REGRESSED and AUTOSCALE-SLO-VIOLATED on it)."""
    import math

    from ..controller import ControllerConfig, FleetSimActuator, Reconciler
    from ..router.migration import scale_recommendation

    sim_seconds = 600
    cap_rps = 40.0  # one replica's drain rate
    base_ttft_ms = 60.0
    slo_ms = 2500.0  # TTFT budget: base + queue wait
    hot_wait_s, cold_wait_s = 0.2, 0.02
    warm_lag_s = 3.0  # spawn -> serving (a peer-warmed join)

    def demand(t: float) -> float:
        """A 5-minute "day" between 15 and 75 rps, and a flash crowd on the
        second peak: +80 rps ramping in over 30 s, 60 s held, ramping out."""
        diurnal = 45.0 + 30.0 * math.sin(2 * math.pi * (t - 225.0) / 300.0)
        if 300 <= t < 330:
            flash = 80.0 * (t - 300) / 30.0
        elif 330 <= t < 390:
            flash = 80.0
        elif 390 <= t < 420:
            flash = 80.0 * (420 - t) / 30.0
        else:
            flash = 0.0
        return max(0.0, diurnal + flash)

    class _Sim:
        """The fluid-queue fleet: the actuator's verbs change it, ``fleet()``
        is the ``/debug/fleet`` view the controller polls."""

        def __init__(self, n0: int):
            self.n = n0
            self.names = [f"sim-{i}" for i in range(n0)]
            self.counter = n0
            self.warming: list = []  # [ready_at, name]
            self.queue = 0.0
            self.t = 0.0
            self.ttfts_ms: list = []
            self.violations = 0
            self.replica_seconds = 0.0
            self.peak = n0

        def spawn(self, role: str) -> str:
            name = f"sim-{self.counter}"
            self.counter += 1
            self.warming.append([self.t + warm_lag_s, name])
            return name

        def reap(self, name: str) -> None:
            if name in self.names:
                self.names.remove(name)
                self.n -= 1

        def wait_s(self, d: float) -> float:
            # rho held below 1: past saturation the backlog term carries
            # the overload (the M/M/1 term would diverge over an empty queue).
            rho = min(0.98, d / (self.n * cap_rps))
            return self.queue / (self.n * cap_rps) + rho / (1.0 - rho) / cap_rps

        def step(self) -> None:
            for entry in [w for w in self.warming if w[0] <= self.t]:
                self.warming.remove(entry)
                self.names.append(entry[1])
                self.n += 1
            d = demand(self.t)
            self.queue = max(0.0, self.queue + d - self.n * cap_rps)
            ttft = base_ttft_ms + self.wait_s(d) * 1000.0
            self.ttfts_ms.append(ttft)
            self.violations += ttft > slo_ms
            self.replica_seconds += self.n + len(self.warming)
            self.peak = max(self.peak, self.n + len(self.warming))
            self.t += 1.0

        def fleet(self) -> dict:
            wait = round(self.wait_s(demand(self.t)), 4)
            per_q = int(self.queue / self.n)
            row = {"role": "unified", "reachable": True, "draining": False, "fenced": False}
            rows = {name: dict(row, pressure_s=wait, queue_depth=per_q, eligible=True)
                    for name in self.names}
            # Warming joiners: billed but ineligible, so they neither read
            # as cold headroom nor get reaped.
            for _, name in self.warming:
                rows[name] = dict(row, pressure_s=0.0, queue_depth=0, eligible=False)
            return {"replicas": rows,
                    "recommendation": scale_recommendation(rows, hot_wait_s=hot_wait_s,
                                                           cold_wait_s=cold_wait_s)}

    static_n = max(math.ceil(demand(t) / cap_rps) for t in range(sim_seconds))
    sim = _Sim(2)
    actuator = FleetSimActuator(
        spawn_fn=sim.spawn,
        join_fn=lambda name, role: None,  # joins when warm_lag_s has passed
        drain_fn=lambda name: None,  # a fluid pool: nothing in flight
        reap_fn=sim.reap,
        warm_fn=lambda name, donor: None,  # warm_lag_s is the transfer
    )
    rc = Reconciler(sim.fleet, actuator,
                    config=ControllerConfig(interval_s=2.0, sustain_ticks=2, cooldown_s=10.0,
                                            min_replicas=1, max_replicas=12,
                                            hot_wait_s=hot_wait_s, cold_wait_s=cold_wait_s),
                    now=lambda: sim.t)
    for s in range(sim_seconds):
        if s % 2 == 0:
            rc.tick()
        sim.step()
    static = _Sim(static_n)
    for _ in range(sim_seconds):
        static.step()

    def p99(xs: list) -> float:
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(len(xs) * 0.99))]

    ctrl_minutes = round(sim.replica_seconds / 60.0, 2)
    static_minutes = round(static.replica_seconds / 60.0, 2)
    block = {
        "sim_seconds": sim_seconds,
        "slo_ms": slo_ms,
        "controller": {
            "replica_minutes": ctrl_minutes,
            "ttft_p99_ms": round(p99(sim.ttfts_ms), 1),
            "slo_violations": sim.violations,
            "peak_replicas": sim.peak,
            "scale_ups": rc.scale_ups,
            "scale_downs": rc.scale_downs,
            "role_flips": rc.role_flips,
            "actions": rc.actions_executed,
        },
        "static_peak": {
            "replicas": static_n,
            "replica_minutes": static_minutes,
            "ttft_p99_ms": round(p99(static.ttfts_ms), 1),
            "slo_violations": static.violations,
        },
        "replica_minutes_saved": (round(1.0 - ctrl_minutes / static_minutes, 3)
                                  if static_minutes else None),
    }
    log(f"perf-ledger row: | AUTOSCALE closed-loop controller ({sim_seconds}s diurnal+flash sim) "
        f"| replica-minutes {ctrl_minutes:.1f} vs static-peak {static_minutes:.1f} "
        f"({100.0 * (block['replica_minutes_saved'] or 0.0):.0f}% saved); ttft p99 "
        f"{block['controller']['ttft_p99_ms']:.0f}ms vs {block['static_peak']['ttft_p99_ms']:.0f}ms "
        f"(slo {slo_ms:.0f}ms, violations {sim.violations} vs {static.violations}); "
        f"{rc.actions_executed} actions ({rc.scale_ups} up, {rc.scale_downs} down) | - | "
        "`benchmark.py --model serving` | update on bench round |")
    return block


def _tp_phase_engine(cfg, params: Optional[dict], paged, slots: int, mesh=None, device=None):
    """The tensor-parallel phase's engine, one rank of it (every rank builds
    it from the same arguments; ``params`` None: ``init_params(cfg, 0)``)."""
    from ..utils.metrics import MetricsRegistry
    from .engine import ServingEngine
    from .engine_types import EngineMetrics

    return ServingEngine(cfg, init_params(cfg, 0) if params is None else params, paged,
                         max_slots=slots, metrics=EngineMetrics(MetricsRegistry()), mesh=mesh,
                         kv_retain=True, kv_host_cache_mb=64, device=device)


def run_tp_phase(args, cfg, params: Optional[dict], paged, jobs, done, overlap_tps: float, *,
                 tp: Optional[int] = None, backend: Optional[str] = None) -> Optional[dict]:
    """The reference's tensor-parallel phase: the same jobs through a tp=N
    engine built the CLI way (``engine_tp.launch`` and the sharded
    constructor), warmed on both admission shapes, timed against the tp=1
    overlapped number ``overlap_tps``; ``done`` is that run's requests.
    ``tp`` defaults to the visible cards; None (the block prints null)
    unless it is above 1 and divides both head counts.  ``params`` None:
    every rank builds ``init_params(cfg, 0)``; ``backend``: the launcher's
    (gloo puts the ranks on one card, or on the CPU)."""
    from .engine_tp import launch

    device = resolve_device(args.device)
    if tp is None:
        tp = torch.cuda.device_count() if device.type == "cuda" else 1
    if tp <= 1 or cfg.kv_heads % tp or cfg.num_heads % tp:
        return None
    factory = functools.partial(_tp_phase_engine, cfg, params, paged, args.slots)
    with launch(tp, backend=backend, device=device) as group:
        tp_eng = group.build(factory)
        # The warm-up covers the sharded engine's own shapes: the single
        # prefill and the slots-wide burst, as the tp=1 warm-up.
        tp_eng.run([(jobs[0][0], 2)])
        tp_eng.run([(p, 2) for p, _ in jobs[: args.slots]])
        discards0 = tp_eng.overlap_discards
        t0 = time.perf_counter()
        tp_done = tp_eng.run(jobs)
        tp_dt = time.perf_counter() - t0
        discards = tp_eng.overlap_discards - discards0
    tp_tps = sum(len(r.tokens) for r in tp_done) / tp_dt if tp_dt else 0.0
    tp_match = [r.tokens for r in tp_done] == [r.tokens for r in done]
    speedup = tp_tps / overlap_tps if overlap_tps else 0.0
    block = {
        "size": tp,
        "tokens_per_sec": round(tp_tps, 2),
        "tp1_tokens_per_sec": round(overlap_tps, 2),
        "speedup": round(speedup, 3),
        "scaling_efficiency": round(speedup / tp, 3),
        "discards": discards,
        "tokens_match": tp_match,
    }
    log(f"perf-ledger row: | MULTICHIP tensor-parallel serving (tp={tp}, b{args.slots}) | tp=1 "
        f"{overlap_tps:.2f} -> tp={tp} {tp_tps:.2f} tokens/sec ({speedup:.3f}x, efficiency "
        f"{speedup / tp:.3f}; discards {discards}; tokens "
        f"{'bit-identical' if tp_match else 'DIVERGED'}) | - | `benchmark.py --model serving` | "
        "update on bench round |")
    return block


def run_serving(args, params: Optional[dict] = None) -> ServingRun:
    """Continuous-batching serving benchmark, the reference's
    ``run_serving`` on one card: TTFT/ITL quantiles read back from the
    engine's metric histograms; the same jobs timed synchronous (overlap
    off), then overlapped (the serving default); the step-phase profile;
    the KV tiers (a serial repeated prefix with retain off, then on, and
    preemption churn over parked free pages); tracing off against on; then
    the tensor-parallel phase (``run_tp_phase``: null on one card, as the
    reference's on one device), the kernels, overload, restart, elastic
    and disagg phases, then the router-side phases (router, fabric, canary,
    postmortem: tiny replicas on the same device behind the port's router,
    null below 2 ``--router-replicas``) between the SLO phase and the
    controller's autoscale simulation.  ``extras["device_steps"]`` holds
    each phase's dispatched steps (the tiny replicas' summed a phase), and
    ``extras["paged_launches"]`` the paged kernel's launches, by pool
    format, that each router-side phase made.
    ``params`` (a state dict) stands in for ``init_params(cfg, 0)``.  On the card the engine replays each decode
    dispatch as a CUDA graph; the warm-up runs every shape the timed runs
    dispatch."""
    from ..ops import paged_attention as pa
    from ..utils.metrics import MetricsRegistry
    from ..utils.spans import SpanRecorder
    from .engine import ServingEngine
    from .engine_types import EngineMetrics
    from .transformer import PagedConfig

    device = resolve_device(args.device)
    fp32_reference_precision()
    page_size = 16
    mpp = -(-(args.prompt_len + args.decode_tokens) // page_size)
    paged = PagedConfig(page_size, num_pages=args.slots * mpp + 1, max_pages_per_seq=mpp)
    cfg = dataclasses.replace(gpt_config(args), max_seq=paged.max_len)
    given = params  # the tp phase's ranks build init_params(cfg, 0) themselves
    params = init_params(cfg, 0) if params is None else params
    spans = SpanRecorder()
    eng = ServingEngine(cfg, params, paged, max_slots=args.slots,
                        metrics=EngineMetrics(MetricsRegistry()), spans=spans, kv_retain=True,
                        kv_host_cache_mb=64, device=device)
    jobs = [([(11 * i + j) % cfg.vocab_size for j in range(args.prompt_len)], args.decode_tokens)
            for i in range(args.requests)]
    # Both admission-burst prefill shapes (one request, then slots-wide)
    # and the decode dispatch the timed runs replay (its graph on the card).
    eng.run([(jobs[0][0], 2)])
    eng.run([(p, 2) for p, _ in jobs[: args.slots]])
    extras = {"device_steps": {}, "paged_launches": {},
              "graphs": {"warmup": sorted(map(str, eng._graphs))}}

    # Synchronous first: any warm-cache bias then works against overlap.
    eng._overlap_steps = 0
    t0 = time.perf_counter()
    sync_done = eng.run(jobs)
    sync_tps = sum(len(r.tokens) for r in sync_done) / (time.perf_counter() - t0)
    ttft_h, itl_h = eng.metrics.ttft_seconds, eng.metrics.itl_seconds
    ttft_snap, itl_snap = ttft_h.snapshot(), itl_h.snapshot()
    eng._overlap_steps = 1
    hits0, discards0 = eng.overlap_hits, eng.overlap_discards
    t0 = time.perf_counter()
    done = eng.run(jobs)
    dt = time.perf_counter() - t0
    extras["graphs"]["timed"] = sorted(map(str, eng._graphs))
    tokens = sum(len(r.tokens) for r in done)
    overlap_tps = tokens / dt
    log(f"perf-ledger row: | Overlapped decode pipeline (b{args.slots}) | sync {sync_tps:.2f} -> "
        f"overlapped {overlap_tps:.2f} tokens/sec ({overlap_tps / sync_tps:.3f}x; hits "
        f"{eng.overlap_hits - hits0}, discards {eng.overlap_discards - discards0}) | - | "
        "`benchmark.py --model serving` | update on bench round |")
    extras["sync_tokens"] = [list(r.tokens) for r in sync_done]
    prof = eng.profiler.snapshot()
    phase_p50 = {phase: stats["window_p50_ms"] for phase, stats in prof["phases"].items()
                 if stats["window_steps"]}
    log(f"perf-ledger row: | Serving step phase breakdown (b{args.slots}) | step p50 "
        f"{prof['step_ms']['p50']:.3f} ms ("
        + ", ".join(f"{k} {v:.3f}" for k, v in phase_p50.items())
        + ") | - | `benchmark.py --model serving` = GET /debug/profile | update on bench round |")

    # KV tiers 1: one hot prompt with serial lifetimes, retain off then on.
    prefix_job = (jobs[0][0], args.decode_tokens)
    n_rep = min(args.requests, 6)

    def _repeat() -> tuple:
        t0 = time.perf_counter()
        n = sum(len(r.tokens) for _ in range(n_rep) for r in eng.run([prefix_job]))
        return n, time.perf_counter() - t0

    eng._kv_retain = False
    eng.kvcache_clear()
    rec_tokens, dt_recompute = _repeat()
    eng._kv_retain = True
    eng.kvcache_clear()
    kv_hits0 = eng.kv_retained_hits + eng.kv_host_hits
    res_tokens, dt_restore = _repeat()
    kv_hits = eng.kv_retained_hits + eng.kv_host_hits - kv_hits0
    rec_tps = rec_tokens / dt_recompute if dt_recompute else 0.0
    res_tps = res_tokens / dt_restore if dt_restore else 0.0
    kv_speedup = res_tps / rec_tps if rec_tps else 0.0
    # KV tiers 2: optimistic admission over a pool tightened by parking
    # free pages, so growing slots preempt their juniors and resume.
    eng.kvcache_clear()
    pre0, resumes0 = eng.preemptions, eng.kv_resumes_restored
    recomputes0 = eng.kv_resumes_recompute
    eng._optimistic = True
    prompt_pages = -(-(args.prompt_len + 1) // page_size)
    keep = mpp + 2 * prompt_pages  # the oldest can finish; juniors must churn
    with eng._lock:
        parked = [eng.free_pages.pop() for _ in range(max(0, len(eng.free_pages) - keep))]
    churn_done = eng.run(jobs[: max(2, args.slots)])
    churn_tokens = sum(len(r.tokens) for r in churn_done)
    with eng._lock:
        eng.kvcache_clear()
        eng.free_pages.extend(parked)
    eng._optimistic = False
    churn_preempts = eng.preemptions - pre0
    churn_restored = eng.kv_resumes_restored - resumes0
    churn_recomputed = eng.kv_resumes_recompute - recomputes0
    log(f"perf-ledger row: | KV cache tiering (b{args.slots}) | repeated-prefix recompute "
        f"{rec_tps:.2f} -> restore {res_tps:.2f} tokens/sec ({kv_speedup:.3f}x; tier hits "
        f"{kv_hits}) | preemption churn: {churn_preempts} preempts, {churn_restored} restored / "
        f"{churn_recomputed} recomputed resumes | `benchmark.py --model serving` | update on "
        "bench round |")

    # Tracing: the same jobs with the span recorder detached, then attached.
    trace_spans0 = len(spans.snapshot()) + spans.dropped
    eng.spans = None
    t0 = time.perf_counter()
    off_done = eng.run(jobs)
    trace_off_dt = time.perf_counter() - t0
    extras["trace_off_tokens"] = [list(r.tokens) for r in off_done]
    off_tokens = sum(len(r.tokens) for r in off_done)
    eng.spans = spans
    t0 = time.perf_counter()
    on_done = eng.run(jobs)
    trace_on_dt = time.perf_counter() - t0
    extras["trace_on_tokens"] = [list(r.tokens) for r in on_done]
    on_tokens = sum(len(r.tokens) for r in on_done)
    trace_off_tps = off_tokens / trace_off_dt if trace_off_dt else 0.0
    trace_on_tps = on_tokens / trace_on_dt if trace_on_dt else 0.0
    trace_overhead = (trace_off_tps / trace_on_tps) - 1.0 if trace_on_tps else 0.0
    trace_spans_recorded = len(spans.snapshot()) + spans.dropped - trace_spans0
    eng.profiler.note_trace_overhead(trace_overhead)
    trace_block = {
        "overhead": round(trace_overhead, 4),
        "off_tokens_per_sec": round(trace_off_tps, 2),
        "on_tokens_per_sec": round(trace_on_tps, 2),
        "spans_recorded": trace_spans_recorded,
    }
    log(f"perf-ledger row: | Tracing overhead (b{args.slots}) | spans off {trace_off_tps:.2f} -> "
        f"on {trace_on_tps:.2f} tokens/sec (overhead {trace_overhead * 100.0:+.2f}%; "
        f"{trace_spans_recorded} spans) | - | `benchmark.py --model serving` | update on bench "
        "round |")
    tp_block = run_tp_phase(args, cfg, given, paged, jobs, done, overlap_tps)
    kernels_block, extras["kernels"] = _run_kernels_phase(args)
    overload_block = _run_overload_phase(eng, args, overlap_tps)
    restart_block = _run_restart_phase(eng, args)
    elastic_block = _run_elastic_phase(eng, args)
    disagg_block, extras["device_steps"]["disagg_decode"] = _run_disagg_phase(eng, args, params)
    steps, counted = extras["device_steps"], extras["paged_launches"]

    def routed(name: str, phase: Callable) -> Optional[dict]:
        # The main engine is idle while a router-side phase runs, so the
        # count's change over the phase is its tiny replicas' launches.
        before = dict(pa.paged_attention.launches_by_format)
        block, steps[name] = phase(args)
        counted[name] = {fmt: n - before[fmt]
                         for fmt, n in pa.paged_attention.launches_by_format.items()}
        return block

    router_block = routed("router", _run_router_phase)
    fabric_block = routed("fabric", _run_fabric_phase)
    slo_block = _run_slo_phase(eng, args)
    canary_block = routed("canary", _run_canary_phase)
    autoscale_block = _run_autoscale_phase(args)
    postmortem_block = routed("postmortem", _run_postmortem_phase)
    extras["device_steps"]["main"] = eng.device_steps
    record = {
        "model": "serving",
        "chips": 1,
        "slots": args.slots,
        "requests": len(done),
        "prompt_len": args.prompt_len,
        "new_tokens": args.decode_tokens,
        "throughput": round(tokens / dt, 2),
        "unit": "tokens/sec (continuous batching, warm, overlapped pipeline; kernels "
        "*_ms: min wall ms of a synced call)",
        "overlap": {
            "tokens_per_sec": round(overlap_tps, 2),
            "sync_tokens_per_sec": round(sync_tps, 2),
            "speedup": round(overlap_tps / sync_tps, 3) if sync_tps else None,
            "hits": eng.overlap_hits - hits0,
            "discards": eng.overlap_discards - discards0,
        },
        "ttft_p50_ms": _ms(ttft_h.quantile(0.5, since=ttft_snap)),
        "ttft_p99_ms": _ms(ttft_h.quantile(0.99, since=ttft_snap)),
        "itl_p50_ms": _ms(itl_h.quantile(0.5, since=itl_snap)),
        "itl_p99_ms": _ms(itl_h.quantile(0.99, since=itl_snap)),
        "kvcache": {
            "prefix_recompute_tokens_per_sec": round(rec_tps, 2),
            "prefix_restore_tokens_per_sec": round(res_tps, 2),
            "restore_speedup": round(kv_speedup, 3),
            "hits": kv_hits,
            "retained_hits": eng.kv_retained_hits,
            "host_hits": eng.kv_host_hits,
            "restores": eng.kv_restores,
            "reclaims": eng.kv_reclaims,
            "offloads": eng.kv_offloads,
            "churn_tokens": churn_tokens,
            "preemptions": churn_preempts,
            "resumes_restored": churn_restored,
            "resumes_recomputed": churn_recomputed,
        },
        "tp": tp_block,
        "kernels": kernels_block,
        "overload": overload_block,
        "restart": restart_block,
        "elastic": elastic_block,
        "disagg": disagg_block,
        "router": router_block,
        "fabric": fabric_block,
        "slo": slo_block,
        "canary": canary_block,
        "autoscale": autoscale_block,
        "postmortem": postmortem_block,
        "trace": trace_block,
        "spans_recorded": len(spans.snapshot()) + spans.dropped,
        "profile": {
            "steps": prof["steps"],
            "step_ms_p50": prof["step_ms"]["p50"],
            "step_ms_p99": prof["step_ms"]["p99"],
            "phase_ms_p50": phase_p50,
            "occupancy": prof["occupancy"],
            "trace_overhead": trace_block["overhead"],
            "incidents": eng.anomaly.snapshot()["incidents_total"],
        },
    }
    return ServingRun(record, done, extras)



def main(argv=None) -> None:
    args = parse_args(argv)
    # Flags the run takes, as the reference does, and does not act on.
    if args.compilation_cache_dir:
        print(f"--compilation-cache-dir {args.compilation_cache_dir}: XLA's cache; the PyTorch "
              "port does not use it", file=sys.stderr)
    if args.pp > 1 and args.checkpoint_dir:
        print(f"--checkpoint-dir {args.checkpoint_dir}: the pipelined path (--pp) saves no "
              "checkpoint, as in the reference", file=sys.stderr)
    if args.model == "gpt-decode":
        record = run_decode(args)[0]
    elif args.model == "serving":
        record = run_serving(args).record
    else:
        record = launch(args).record
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
