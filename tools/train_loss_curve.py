"""Print a training benchmark's loss at every step, once per compute type.

Builds the run that ``k8s_device_plugin_tpu_torch/models/benchmark.py``
builds for the benchmark flags given after ``--`` (one process, no ranks)
and trains it as the CLI does (``timed_steps``: ``4 * warmup + steps``
steps), on the card unless the flags say ``--device=cpu``, once for each
entry of ``--dtypes``; prints one JSON line a run: the flags, the compute
type, every step's loss and the first steps whose loss is not finite.
TF32 stays off, so a float32 run computes in float32.

    python tools/train_loss_curve.py --dtypes bfloat16,float32 -- \\
        --model=alexnet --batch-size=256 --steps=30

``--reference`` (AlexNet only, on the CPU, needs jax) trains the JAX
package's AlexNet instead, from the reference CLI's own start (flax's init
and the synthetic batch, both from ``PRNGKey(0)``), for the same number of
steps, then the port's AlexNet from that same start (its weights through
``convert.load_flax_train_state``, the same batch): one JSON line for each
side and compute type, ``"side": "reference"`` or ``"port"``.

    python tools/train_loss_curve.py --reference --dtypes float32 -- \\
        --model=alexnet --batch-size=256 --steps=30
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def curve_line(flags, dtype, losses, device, **extra) -> str:
    return json.dumps({
        "flags": flags, "dtype": dtype, **extra, "losses": losses,
        "not_finite_from": [i for i, x in enumerate(losses) if not math.isfinite(x)][:1],
        "device": device,
    })


def reference_curves(flags, dtype: str) -> None:
    """The JAX package's AlexNet from the reference CLI's start, then the
    port's from the same start, both on the CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import optax
    import torch

    from k8s_device_plugin_tpu.models import alexnet as jalex
    from k8s_device_plugin_tpu.models import data as jdata
    from k8s_device_plugin_tpu.models import train as jtrain
    from k8s_device_plugin_tpu_torch import convert
    from k8s_device_plugin_tpu_torch.models import alexnet as talex
    from k8s_device_plugin_tpu_torch.models import benchmark as bench
    from k8s_device_plugin_tpu_torch.models import train as ttrain

    run = bench.parse_args([*flags, "--device=cpu", f"--dtype={dtype}"])
    if run.model != "alexnet":
        raise SystemExit("--reference trains AlexNet only")
    n = 4 * run.warmup + run.steps
    # The reference CLI's build(): one PRNGKey(0) for the batch and the init.
    rng = jax.random.PRNGKey(0)
    batch = jdata.synthetic_image_batch(rng, run.batch_size, run.image_size)
    jm = jalex.AlexNet(num_classes=1000, dtype={"bfloat16": jnp.bfloat16,
                                                 "float32": jnp.float32}[dtype])
    tx = optax.sgd(0.1, momentum=0.9)
    state = jtrain.create_train_state(rng, jm, batch, tx)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    step = jax.jit(jtrain.make_train_step(jm, tx), donate_argnums=0)
    losses = []
    for _ in range(n):
        state, loss = step(state, batch)
        losses.append(float(loss))
    print(curve_line(flags, dtype, losses, "cpu", side="reference"), flush=True)

    model = talex.AlexNet(1000, bench.DTYPES[dtype], image_size=run.image_size, device="cpu")
    tstate = convert.load_flax_train_state(ttrain.state_for(model, 0.1, 0.9), params)
    tstep = ttrain.make_train_step(input_key="images")
    tbatch = {"images": torch.from_numpy(np.array(batch["images"])),
              "labels": torch.from_numpy(np.array(batch["labels"])).long()}
    losses = []
    for _ in range(n):
        tstate, loss = tstep(tstate, tbatch)
        losses.append(loss.item())
    print(curve_line(flags, dtype, losses, "cpu", side="port"), flush=True)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    split = argv.index("--") if "--" in argv else len(argv)
    p = argparse.ArgumentParser(prog="train_loss_curve")
    p.add_argument("--dtypes", default="bfloat16,float32",
                   help="comma-separated compute types, one run each")
    p.add_argument("--reference", action="store_true",
                   help="AlexNet on the CPU: the JAX package's run, then the port's from its start")
    args = p.parse_args(argv[:split])
    flags = argv[split + 1:]
    if args.reference:
        for dtype in args.dtypes.split(","):
            reference_curves(flags, dtype)
        return
    import torch

    from k8s_device_plugin_tpu_torch.models import benchmark as bench
    from k8s_device_plugin_tpu_torch.utils.device import fp32_reference_precision

    fp32_reference_precision()
    for dtype in args.dtypes.split(","):
        run = bench.parse_args([*flags, f"--dtype={dtype}"])
        built = bench.build(run, device=bench.resolve_device(run.device))
        _, losses, _ = bench.timed_steps(built.step, built.state, built.batch, run.warmup,
                                         run.steps)
        losses = [loss.item() for loss in losses]
        device = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                  and run.device != "cpu" else "cpu")
        print(curve_line(flags, dtype, losses, device), flush=True)


if __name__ == "__main__":
    main()
