"""The port's image models (ResNet, AlexNet) against the JAX package's.

Both sides start from flax's own init (seeded), moved to the port through
``convert.load_flax_train_state``; images and labels come from numpy with a
seed.  Everything runs in float32 (``dtype``/``norm_dtype=float32`` on both
sides).  The models are cut to CPU size: ``ResNet18Thin`` (width 8) at 32
px, AlexNet at ``width=0.125`` on 128 px (so its last feature map is 3 x
3 and the (H, W, C) flatten order matters).

Tolerances (float32 throughout, stated per check):

- forward logits 2e-5 absolute: the two frameworks sum each conv's k*k*C
  terms and each BatchNorm's statistics in different orders, ~1e-7
  relative per op, through 6 (AlexNet 8) layers;
- BatchNorm statistics 2e-6: means and variances of such outputs;
- two SGD-momentum steps (lr 0.1): the loss 1e-5 relative, every
  parameter and statistic 1e-5 absolute.  ResNet runs at batch 8: at
  batch 4 its last stage normalizes over 4 values a channel, and the
  reference disagrees with itself (jit against op by op) by 2e-6 in the
  second step's loss and 7e-5 in the weights after three;
- the space-to-depth stem against conv7 with the kernel mapped: 1e-5.

AlexNet's dropout masks are compared exactly: the port draws them with
jax's threefry from flax's per-module keys.
"""

from tests import torch_threads  # noqa: F401  (first: one torch CPU thread)

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax

from k8s_device_plugin_tpu.models import alexnet as jalex
from k8s_device_plugin_tpu.models import resnet as jres
from k8s_device_plugin_tpu.models import train as jtrain
from k8s_device_plugin_tpu_torch import convert
from k8s_device_plugin_tpu_torch.models import alexnet as talex
from k8s_device_plugin_tpu_torch.models import layers
from k8s_device_plugin_tpu_torch.models import resnet as tres
from k8s_device_plugin_tpu_torch.models import train as ttrain
from k8s_device_plugin_tpu_torch.utils import prng

LOGIT_ATOL = 2e-5
STATS_ATOL = 2e-6
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
S2D_ATOL = 1e-5
CLASSES = 10


def _images(n, size, seed):
    rs = np.random.RandomState(seed)
    return {"images": rs.randn(n, size, size, 3).astype(np.float32),
            "labels": rs.randint(0, CLASSES, size=n).astype(np.int32)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_state(model, variables, tx):
    params = variables["params"]
    return jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             opt_state=tx.init(params),
                             batch_stats=variables.get("batch_stats", {}))


def _port_state(model, variables):
    state = ttrain.state_for(model, 0.1, 0.9)
    return convert.load_flax_train_state(state, _np_tree(variables["params"]),
                                         _np_tree(variables.get("batch_stats", {})))


def _torch_batch(batch):
    return {"images": torch.from_numpy(batch["images"]),
            "labels": torch.from_numpy(batch["labels"]).long()}


def _assert_tree_close(got, want, atol, what):
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(jax.tree_util.tree_leaves(got)), what
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, np.asarray(leaf), rtol=0, atol=atol,
                                   err_msg=f"{what}: {'/'.join(k.key for k in path)}")


def _train_both(jmodel, tmodel, variables, batch, *, steps=2, grad_accum=1, lr=0.1):
    """``steps`` steps of SGD(lr, 0.9) on each side from ``variables``;
    returns (JAX losses, JAX state, port losses, port state)."""
    tx = optax.sgd(lr, momentum=0.9)
    jstate = _jax_state(jmodel, variables, tx)
    jstep = jax.jit(jtrain.make_train_step(jmodel, tx, grad_accum=grad_accum))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tstate = _port_state(tmodel, variables)
    tstate.optimizer.param_groups[0]["lr"] = lr
    tstep = ttrain.make_train_step(grad_accum=grad_accum, input_key="images")
    tb = _torch_batch(batch)
    jl, tl = [], []
    for _ in range(steps):
        jstate, loss = jstep(jstate, jb)
        jl.append(float(loss))
        tstate, loss = tstep(tstate, tb)
        tl.append(loss.item())
    return jl, jstate, tl, tstate


def _assert_same_state(jl, jstate, tl, tstate):
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    got = convert.train_state_to_flax(tstate)
    assert got["step"] == int(jstate.step)
    _assert_tree_close(got["params"], jstate.params, PARAM_ATOL, "params")
    _assert_tree_close(got["batch_stats"], jstate.batch_stats, PARAM_ATOL, "batch_stats")


# ----------------------------------------------------------------- ResNet


def _resnets(stem="conv7", **kw):
    jm = jres.ResNet18Thin(num_classes=CLASSES, dtype=jnp.float32, norm_dtype=jnp.float32,
                           stem=stem, **kw)
    tm = tres.ResNet18Thin(num_classes=CLASSES, dtype=torch.float32, norm_dtype=torch.float32,
                           stem=stem, device="cpu", **kw)
    return jm, tm


@pytest.fixture(scope="module")
def resnet_start():
    batch = _images(8, 32, seed=0)
    out = {}
    for stem in ("conv7", "space_to_depth"):
        jm, _ = _resnets(stem)
        out[stem] = _np_tree(jm.init(jax.random.PRNGKey(1), jnp.asarray(batch["images"])))
    return out, batch


def test_resnet_names_are_flax_paths(resnet_start):
    variables, _ = resnet_start
    _, tm = _resnets()
    want = {".".join(k.key for k in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(variables["conv7"]["params"])}
    assert {n for n, _ in tm.named_parameters()} == want
    want_stats = {".".join(k.key for k in path) for path, _ in
                  jax.tree_util.tree_leaves_with_path(variables["conv7"]["batch_stats"])}
    assert set(ttrain.state_for(tm).batch_stats) == want_stats
    # Conv kernels cross transposed: flax [kh, kw, in, out], torch [out, in, kh, kw].
    assert tuple(tm.Conv_stem.kernel.shape) == (8, 3, 7, 7)
    assert variables["conv7"]["params"]["Conv_stem"]["kernel"].shape == (7, 7, 3, 8)


@pytest.mark.parametrize("stem", ["conv7", "space_to_depth"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet_forward_matches_the_reference(resnet_start, stem, train):
    variables, batch = resnet_start
    jm, tm = _resnets(stem)
    want = jm.apply(variables[stem], jnp.asarray(batch["images"]), train=train,
                    mutable=["batch_stats"] if train else False)
    want_logits, want_stats = (want if train else (want, {"batch_stats": variables[stem][
        "batch_stats"]}))
    state = _port_state(tm, variables[stem])
    with torch.no_grad():
        got = tm(torch.from_numpy(batch["images"]), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_logits), rtol=0, atol=LOGIT_ATOL)
    # Training updates the running statistics (the reference's mutated
    # batch_stats); eval leaves them as they were.
    _assert_tree_close(convert.state_dict_to_flax(state.batch_stats),
                       want_stats["batch_stats"], STATS_ATOL, "batch_stats")


@pytest.mark.parametrize("stem", ["conv7", "space_to_depth"])
def test_resnet_two_train_steps_match_the_reference(resnet_start, stem):
    variables, batch = resnet_start
    jm, tm = _resnets(stem)
    _assert_same_state(*_train_both(jm, tm, variables[stem], batch))


def test_resnet_grad_accum_2_matches_the_reference(resnet_start):
    """Batch 16 in two microbatches of 8 (see the module note on batch 4)."""
    variables, _ = resnet_start
    jm, tm = _resnets()
    batch = _images(16, 32, seed=2)
    _assert_same_state(*_train_both(jm, tm, variables["conv7"], batch, grad_accum=2))


def test_resnet_grad_accum_carries_batch_stats_microbatch_to_microbatch(resnet_start):
    """As the reference's scan: two microbatches in one step leave the
    statistics that two single steps over them leave (lr 0: only the
    statistics move)."""
    variables, batch = resnet_start
    _, tm = _resnets()
    accum = _port_state(tm, variables["conv7"])
    accum.optimizer.param_groups[0]["lr"] = 0.0
    ttrain.make_train_step(grad_accum=2, input_key="images")(accum, _torch_batch(batch))
    _, tm2 = _resnets()
    single = _port_state(tm2, variables["conv7"])
    single.optimizer.param_groups[0]["lr"] = 0.0
    step = ttrain.make_train_step(input_key="images")
    tb = _torch_batch(batch)
    for half in (slice(0, 4), slice(4, 8)):
        step(single, {k: v[half] for k, v in tb.items()})
    for name, buf in accum.batch_stats.items():
        torch.testing.assert_close(buf, single.batch_stats[name], rtol=0, atol=0)


def test_eval_step_reads_the_running_stats_and_leaves_them(resnet_start):
    variables, batch = resnet_start
    jm, tm = _resnets()
    state = _port_state(tm, variables["conv7"])
    before = {k: v.clone() for k, v in state.batch_stats.items()}
    logits = ttrain.make_eval_step("images")(state, _torch_batch(batch))
    want = jm.apply(variables["conv7"], jnp.asarray(batch["images"]), train=False)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=0, atol=LOGIT_ATOL)
    assert not logits.requires_grad
    assert all(torch.equal(before[k], v) for k, v in state.batch_stats.items())


def test_space_to_depth_stem_equals_conv7_with_the_kernel_mapped():
    """The port's space-to-depth stem gives conv7's stem output when its
    4x4x12 kernel is the 7x7 kernel zero-padded to 8x8 and repacked in the
    (block_row, block_col, channel) order (tests/test_models.py for the
    reference), SAME padding included ((2, 3) on 224-style input, (1, 2)
    packed)."""
    x = torch.from_numpy(_images(2, 32, seed=3)["images"])
    conv7, s2d = (tres.ResNet18Thin(num_classes=CLASSES, dtype=torch.float32,
                                    norm_dtype=torch.float32, stem=stem, device="cpu", seed=4)
                  for stem in ("conv7", "space_to_depth"))
    w7 = conv7.Conv_stem.kernel.detach().permute(2, 3, 1, 0).numpy()  # [7, 7, 3, out]
    out_ch = w7.shape[-1]
    w8 = np.zeros((8, 8, 3, out_ch), np.float32)
    w8[:7, :7] = w7
    wp = w8.reshape(4, 2, 4, 2, 3, out_ch).transpose(0, 2, 1, 3, 4, 5).reshape(4, 4, 12, out_ch)
    with torch.no_grad():
        s2d.Conv_stem.kernel.copy_(torch.from_numpy(wp).permute(3, 2, 0, 1))
        want = conv7.Conv_stem(x.permute(0, 3, 1, 2))
        n, h, w, c = x.shape
        packed = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        got = s2d.Conv_stem(packed.reshape(n, h // 2, w // 2, 4 * c).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=S2D_ATOL)


def test_space_to_depth_refuses_odd_sizes():
    _, tm = _resnets("space_to_depth")
    with pytest.raises(ValueError, match="even spatial"):
        tm(torch.zeros(1, 33, 33, 3))
    with pytest.raises(ValueError, match="stem"):
        tres.ResNet18Thin(stem="bogus", device="cpu")


@pytest.mark.parametrize("size, kernel, stride, want", [
    (224, 7, 2, (2, 3)),    # the conv7 stem
    (56, 3, 2, (0, 1)),     # the stride-2 3x3 convs: 56 -> 28, 28 -> 14, 14 -> 7
    (28, 3, 2, (0, 1)),
    (14, 3, 2, (0, 1)),
    (112, 3, 2, (0, 1)),    # the stem max pool
    (112, 4, 1, (1, 2)),    # the space-to-depth stem
    (224, 11, 4, (3, 4)),   # AlexNet's first conv
    (56, 1, 2, (0, 0)),     # the 1x1/s2 projection
    (13, 3, 1, (1, 1)),
])
def test_same_pads_are_xla_s(size, kernel, stride, want):
    assert layers.same_pads(size, kernel, stride) == want
    assert tuple(lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0]) == want


def test_resnet50_structure():
    """50 layers: 1 stem conv, 48 block convs and 4 projections (53 conv
    kernels), as the reference's structure test counts them."""
    model = tres.ResNet50(num_classes=CLASSES, width=8, dtype=torch.float32, device="cpu")
    kernels = [n for n, p in model.named_parameters() if n.endswith("kernel") and p.dim() == 4]
    assert len(kernels) == 53 and model.num_blocks == 16
    zero_scales = [n for n, p in model.named_parameters()
                   if n.endswith("BatchNorm_2.scale") and not p.abs().sum()]
    assert len(zero_scales) == 16  # each block's last norm starts at zero, as the reference's


# ----------------------------------------------------------------- AlexNet

ALEX_SIZE = 128
ALEX_WIDTH = 0.125


def _alexnets():
    jm = jalex.AlexNet(num_classes=CLASSES, dtype=jnp.float32, width=ALEX_WIDTH)
    tm = talex.AlexNet(num_classes=CLASSES, dtype=torch.float32, width=ALEX_WIDTH,
                       image_size=ALEX_SIZE, device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def alexnet_start():
    batch = _images(4, ALEX_SIZE, seed=5)
    jm, _ = _alexnets()
    return _np_tree(jm.init(jax.random.PRNGKey(6), jnp.asarray(batch["images"]))), batch


def test_alexnet_flattens_hwc_into_dense_0(alexnet_start):
    variables, _ = alexnet_start
    # 128 px: 32 after the 11x11/s4 conv, pools to 15, 7, 3: 3 x 3 x 32 rows.
    assert variables["params"]["Dense_0"]["kernel"].shape == (288, 512)
    _, tm = _alexnets()
    assert tuple(tm.Dense_0.kernel.shape) == (288, 512)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train-dropout"])
def test_alexnet_forward_matches_the_reference(alexnet_start, train):
    """In training both sides draw dropout masks from the same root key:
    the logits agree only if every mask does."""
    variables, batch = alexnet_start
    jm, tm = _alexnets()
    root = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    want = jm.apply(variables, jnp.asarray(batch["images"]), train=train,
                    rngs={"dropout": root} if train else None)
    _port_state(tm, variables)
    words = tuple(int(w) for w in np.asarray(jax.random.key_data(root)))
    with torch.no_grad():
        got = tm(torch.from_numpy(batch["images"]), train=train,
                 dropout_rng=words if train else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=LOGIT_ATOL)


def test_dropout_masks_equal_flax_s_bit_for_bit():
    import flax.linen as nn

    class TwoDropouts(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dropout(0.5, deterministic=False)(x), nn.Dropout(0.5, deterministic=False)(x)

    x = np.ones((4, 300), np.float32)
    for step in (0, 1, 7):
        root = jax.random.fold_in(jax.random.PRNGKey(0), step)
        want = TwoDropouts().apply({}, jnp.asarray(x), rngs={"dropout": root})
        words = prng.fold_in_words((0, 0), step)
        assert words == tuple(int(w) for w in np.asarray(jax.random.key_data(root)))
        for i, w in enumerate(want):
            got = layers.dropout(torch.from_numpy(x), 0.5, words, f"Dropout_{i}")
            np.testing.assert_array_equal(got.numpy(), np.asarray(w))
        assert not np.array_equal(np.asarray(want[0]), np.asarray(want[1]))


def test_alexnet_needs_a_dropout_key_in_training():
    _, tm = _alexnets()
    with pytest.raises(ValueError, match="dropout key"):
        tm(torch.zeros(1, ALEX_SIZE, ALEX_SIZE, 3), train=True)


@pytest.mark.parametrize("grad_accum", [1, 2], ids=["full", "grad-accum-2"])
def test_alexnet_two_train_steps_match_the_reference(alexnet_start, grad_accum):
    """Dropout on: each step's masks come from fold_in(PRNGKey(0), step),
    and each microbatch's from fold_in of that and its index, on both
    sides."""
    variables, batch = alexnet_start
    jm, tm = _alexnets()
    _assert_same_state(*_train_both(jm, tm, variables, batch, grad_accum=grad_accum))
