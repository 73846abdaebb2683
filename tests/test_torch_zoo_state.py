"""The zoo's layers and state in the port (layers/conv.py, the conv and
batch_stats legs of common/params.py, the trainer's and checkpoints'
non-parameter state, the record converters) against the JAX package: flax's
Conv, max_pool and BatchNorm, the ResNet-50 and MobileNetV2 blocks, worker
checkpoints of a BatchNorm model across the two packages, and the IDX and
pickle converters' files.

Tolerances, as a share of the largest value compared: float32 forward and
gradients 1e-4 (the same arithmetic summed in another order), running
statistics 1e-5; bfloat16 blocks 2e-2 (outputs rounded to bfloat16, an
8-bit mantissa, on both sides), their gradients 0.12 of the block's largest
gradient (sums of rounded terms that cancel)."""

import functools
import pickle

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.common import save_utils as jax_save_utils
from elasticdl_tpu.common.pytree_utils import flatten_params
from elasticdl_tpu.data.gen import cifar10_pickle as jax_cifar
from elasticdl_tpu.data.gen import mnist_idx as jax_mnist_idx
from elasticdl_tpu.models.mnist import mnist_model as jmnist
from elasticdl_tpu.models.mobilenetv2 import mobilenetv2 as jmobilenet
from elasticdl_tpu.models.resnet50 import resnet50 as jresnet
from elasticdl_tpu.worker.trainer import LocalTrainer as JaxLocalTrainer
from elasticdl_tpu_torch.common import save_utils
from elasticdl_tpu_torch.common.params import (
    flax_leaves,
    load_flax,
    params_from_flax,
    params_to_flax,
    state_to_flax,
)
from elasticdl_tpu_torch.data.example import decode_example
from elasticdl_tpu_torch.data.gen import cifar10_pickle, mnist_idx
from elasticdl_tpu_torch.data.recordfile import RecordFile
from elasticdl_tpu_torch.layers.conv import BatchNorm, Conv, max_pool
from elasticdl_tpu_torch.layers.init import init_flax_defaults
from elasticdl_tpu_torch.models.cifar10 import cifar10_cnn
from elasticdl_tpu_torch.models.mnist import mnist_model
from elasticdl_tpu_torch.models.mobilenetv2 import mobilenetv2
from elasticdl_tpu_torch.models.resnet50 import resnet50
from elasticdl_tpu_torch.models.transformer import transformer_lm as tlm
from elasticdl_tpu_torch.worker.trainer import LocalTrainer

from test_cifar10_pickle import _make_batch
from test_mnist_idx import (
    _make_separable_digits,
    _write_idx_images,
    _write_idx_labels,
)

torch.set_num_threads(1)

RTOL = 1e-4
STATS_RTOL = 1e-5
BF16_RTOL = 2e-2
BF16_GRAD_RTOL = 0.12
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _jit(fn, *args, **static):
    """fn(*args) through XLA with its backend at optimization level 0:
    the same IEEE arithmetic, compiled in a third of the time."""
    return jax.jit(functools.partial(fn, **static)).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)


def _close(got, want, what, rtol=RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: {err} of max {scale}"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _randomized(module, seed):
    """Initializes `module` (flax's default initializers) and moves every
    leaf off its initial value: scales, biases and running statistics too,
    the variances kept positive. Returns its flax params and batch_stats,
    each {wire name: float32 array}, the state's names without the
    collection."""
    init_flax_defaults(module, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    named = {k: (v + rng.normal(scale=0.3, size=v.shape)).astype(np.float32)
             for k, v in params_to_flax(module).items()}
    state = {}
    for k, v in state_to_flax(module).items():
        state[k] = (0.5 + rng.random(v.shape) if k.endswith("var")
                    else rng.normal(scale=0.3, size=v.shape)
                    ).astype(np.float32)
    load_flax(module, named, state)
    return named, {k[len("batch_stats/"):]: v for k, v in state.items()}


def _nest(named):
    tree = {}
    for name, value in named.items():
        *path, leaf = name.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(value)
    return tree


def _flax_train(module, **kwargs):
    """flax in training mode as a function of (params, batch_stats, x,
    cot), compiled at its first call: the output, d(sum(out * cot)) for the
    params and the input, and the new batch_stats."""
    def f(p, stats, xx, cot):
        out, new = module.apply({"params": p, "batch_stats": stats}, xx,
                                mutable=["batch_stats"], **kwargs)
        return jnp.sum(out.astype(jnp.float32) * cot), (out, new)

    grad_fn = jax.jit(jax.value_and_grad(f, argnums=(0, 2), has_aux=True))
    compiled = []

    def run(params, stats, x, cot):
        if not compiled:
            compiled.append(grad_fn.lower(params, stats, x, cot).compile(
                compiler_options=FAST_COMPILE))
        (_, (out, new)), (grads, dx) = compiled[0](params, stats, x, cot)
        return (np.asarray(out, np.float32), flatten_params(grads)[0],
                np.asarray(dx, np.float32),
                flatten_params(new["batch_stats"])[0])

    return run


def _port_train(module, x, cot):
    """The port's module in training mode, NCHW: the same four results,
    NHWC and flax-named."""
    module.train()
    xt = _nchw(x).requires_grad_(True)
    out = module(xt)
    (out.float() * _nchw(cot)).sum().backward()
    grads = {leaf.name: leaf.to_flax(leaf.param.grad).numpy()
             for leaf in flax_leaves(module)}
    state = {k[len("batch_stats/"):]: v
             for k, v in state_to_flax(module).items()}
    return _nhwc(out), grads, _nhwc(xt.grad), state


# ---------- layers ----------


CONV_CASES = [
    # (padding, stride, input size, groups)
    ("SAME", 1, 8, 1), ("SAME", 1, 7, 1), ("SAME", 2, 8, 1),
    ("SAME", 2, 7, 1), ("VALID", 1, 7, 1), ("VALID", 2, 8, 1),
    ("SAME", 2, 8, 6),  # depthwise, as MobileNetV2's strided ones
    (((3, 3), (3, 3)), 2, 8, 1),  # ResNet-50's stem
]


@pytest.mark.parametrize("padding,stride,size,groups", CONV_CASES)
def test_conv_matches_flax(padding, stride, size, groups):
    """SAME pads as XLA does ((0, 1) at stride 2 on an even input),
    depthwise convs included; the kernel crosses the bridge."""
    rng = np.random.default_rng(size * 10 + stride)
    kernel = (7, 7) if isinstance(padding, tuple) else (3, 3)
    x = rng.normal(size=(2, size, size, 6)).astype(np.float32)
    conv = Conv(6, 6, kernel, strides=stride, padding=padding,
                groups=groups)
    named, _ = _randomized(conv, size)
    flax_conv = fnn.Conv(6, kernel, strides=(stride, stride),
                         padding=padding, feature_group_count=groups)
    want = _jit(flax_conv.apply, {"params": _nest(named)}, x)
    _close(_nhwc(conv(_nchw(x))), want, "conv")
    assert named["kernel"].shape == (*kernel, 6 // groups, 6)
    np.testing.assert_array_equal(params_to_flax(conv)["kernel"],
                                  named["kernel"])


@pytest.mark.parametrize("window,stride,padding,size", [
    (3, 2, "SAME", 8), (3, 2, "SAME", 7), (2, 2, "VALID", 8)])
def test_max_pool_matches_flax(window, stride, padding, size):
    x = np.random.default_rng(size).normal(
        size=(2, size, size, 3)).astype(np.float32)
    want = np.asarray(fnn.max_pool(x, (window, window), (stride, stride),
                                   padding=padding))
    got = _nhwc(max_pool(_nchw(x), (window, window), (stride, stride),
                         padding))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("momentum,epsilon", [(0.99, 1e-5), (0.9, 1e-6)])
def test_batchnorm_two_training_steps_then_eval_match_flax(momentum,
                                                           epsilon):
    """Output, gradients and the running statistics after the first and
    the second step; then eval mode reads the statistics and keeps
    them."""
    rng = np.random.default_rng(3)
    flax_bn = fnn.BatchNorm(momentum=momentum, epsilon=epsilon)
    bn = BatchNorm(6, momentum=momentum, epsilon=epsilon)
    named, state = _randomized(bn, 4)
    params, stats = _nest(named), _nest(state)
    train = _flax_train(flax_bn, use_running_average=False)
    for step in range(2):
        x = (1.0 + 3.0 * rng.normal(size=(4, 5, 5, 6))).astype(np.float32)
        cot = rng.normal(size=x.shape).astype(np.float32)
        out, grads, dx, new = train(params, stats, x, cot)
        bn.zero_grad()
        got, tgrads, tdx, tnew = _port_train(bn, x, cot)
        _close(got, out, f"step {step} output")
        _close(tdx, dx, f"step {step} input gradient")
        for name in grads:
            _close(tgrads[name], grads[name], f"step {step} {name}")
        assert sorted(tnew) == ["mean", "var"]
        for name in new:
            _close(tnew[name], new[name], f"step {step} {name}",
                   STATS_RTOL)
        stats = _nest(new)
    kept = {k: v.tolist() for k, v in state_to_flax(bn).items()}
    bn.eval()
    with torch.no_grad():
        got = _nhwc(bn(_nchw(x)))
    want = _jit(flax_bn.apply, {"params": params, "batch_stats": stats}, x,
                use_running_average=True)
    _close(got, want, "eval output")
    assert {k: v.tolist() for k, v in state_to_flax(bn).items()} == kept


# ---------- blocks ----------


def _block_step(family, in_channels, stride, expansion, dtype, seed=0):
    """A ResNet-50 bottleneck or a MobileNetV2 inverted residual with the
    same randomized weights in flax and in the port, one training-mode
    forward and backward of sum(out * cot) each: (flax's, the port's)
    (output, {leaf: gradient, "input": input gradient}, new batch_stats),
    NHWC and flax-named. `seed` 0 gives the tests' inputs."""
    x = np.random.default_rng(5 + 100 * seed).normal(
        size=(2, 8, 8, in_channels)).astype(np.float32)
    if family == "bottleneck":
        flax_block = jresnet.BottleneckBlock(filters=4, strides=stride,
                                             dtype=dtype)
        port_block = resnet50.BottleneckBlock(in_channels, 4, stride, dtype)
    else:
        out_channels = in_channels if stride == 1 else 2 * in_channels
        flax_block = jmobilenet.InvertedResidual(
            out_channels=out_channels, stride=stride, expansion=expansion,
            dtype=dtype)
        port_block = mobilenetv2.InvertedResidual(
            in_channels, out_channels, stride, expansion, dtype)
    named, state = _randomized(port_block, 6 + seed)
    params, stats = _nest(named), _nest(state)
    cot = np.random.default_rng(7 + seed).normal(
        size=_nhwc(port_block.eval()(_nchw(x))).shape).astype(np.float32)
    out, grads, dx, new = _flax_train(flax_block, training=True)(
        params, stats, x, cot)
    got, tgrads, tdx, tnew = _port_train(port_block, x, cot)
    return ((out, dict(grads, input=dx), new),
            (got, dict(tgrads, input=tdx), tnew))


def _grad_gap(got, want):
    """The largest difference of any gradient as a share of the largest
    gradient of `want`."""
    largest = max(float(np.abs(g).max()) for g in want.values())
    return max(float(np.abs(got[k] - want[k]).max())
               for k in want) / largest


@pytest.mark.parametrize("family,in_channels,stride,expansion,dtype", [
    # (family, in channels, stride, expansion, dtype)
    ("bottleneck", 16, 1, None, "float32"),
    ("bottleneck", 8, 2, None, "float32"),  # with proj / proj_bn
    ("inverted", 8, 1, 1, "float32"),
    ("inverted", 8, 1, 6, "float32"),
    ("inverted", 8, 2, 6, "float32"),
    ("bottleneck", 8, 2, None, "bfloat16"),
    ("inverted", 8, 2, 6, "bfloat16"),
])
def test_block_training_step_matches_flax(family, in_channels, stride,
                                          expansion, dtype):
    """Training-mode forward, every gradient and the new batch_stats of a
    ResNet-50 bottleneck and a MobileNetV2 inverted residual in float32;
    in bfloat16 the forward and the batch_stats within 2e-2, the gradients
    (the input's among them) within BF16_GRAD_RTOL of the block's largest
    gradient.

    bfloat16 gradients sum bfloat16-rounded terms that cancel: on these
    inputs the port's lie 2.0e-2 (bottleneck) and 9.5e-2 (inverted
    residual) of the largest from flax's, and flax's own bfloat16 gradients
    1.9e-2 and 9.5e-2 from its float32 ones (`JAX_PLATFORMS=cpu
    PYTHONPATH=. python tests/test_torch_zoo_state.py` prints both over
    six inputs)."""
    (out, grads, new), (got, tgrads, tnew) = _block_step(
        family, in_channels, stride, expansion, dtype)
    assert sorted(tgrads) == sorted(grads) and sorted(tnew) == sorted(new)
    if dtype == "bfloat16":
        _close(got, out, "output", BF16_RTOL)
        for name in new:
            _close(tnew[name], new[name], name, BF16_RTOL)
        assert _grad_gap(tgrads, grads) <= BF16_GRAD_RTOL
        return
    _close(got, out, "output")
    for name in grads:
        _close(tgrads[name], grads[name], name)
    for name in new:
        _close(tnew[name], new[name], name, STATS_RTOL)


# ---------- the bridge ----------


def test_bridge_decides_the_layout_from_the_module():
    """A conv kernel and the LM's 4-D DenseGeneral qkv kernel: the module,
    not the rank, picks the layout; depthwise kernels are [kh, kw, 1, C]."""
    conv = Conv(4, 4, (3, 3), groups=4)
    named = params_to_flax(conv)
    assert named["kernel"].shape == (3, 3, 1, 4)
    np.testing.assert_array_equal(
        named["kernel"], conv.weight.detach().permute(2, 3, 1, 0).numpy())
    back = params_from_flax(named, conv)
    np.testing.assert_array_equal(back["weight"].numpy(),
                                  conv.weight.detach().numpy())
    lm = tlm.custom_model(tlm.LMConfig(vocab=16, d_model=8, n_heads=2,
                                       n_layers=1, max_len=8)).to_empty(
        device="cpu")
    lm.init_weights(torch.Generator().manual_seed(0))
    named = params_to_flax(lm)
    assert named["Block_0/MultiHeadAttention_0/qkv/kernel"].ndim == 4
    back = params_from_flax(named, lm)
    assert sorted(back) == sorted(lm.state_dict())
    for key, value in lm.state_dict().items():
        np.testing.assert_array_equal(back[key].numpy(), value.numpy())


@pytest.mark.parametrize("name,jmodule,module", [
    ("resnet50", jresnet, resnet50), ("mobilenetv2", jmobilenet,
                                      mobilenetv2)])
def test_full_model_names_shapes_and_counts_match_flax(name, jmodule,
                                                       module):
    """Every params and batch_stats leaf of the full-width model: the same
    wire names and flax shapes (abstract shapes on the JAX side, the meta
    device on the port's: nothing is allocated)."""
    x = jax.ShapeDtypeStruct((1, 224, 224, 3), np.float32)
    shapes = jax.eval_shape(jmodule.custom_model().init,
                            jax.random.PRNGKey(0), x)
    model = module.custom_model()
    got = {leaf.name: tuple(leaf.to_flax(leaf.param).shape)
           for leaf in flax_leaves(model)}
    want = {k: tuple(v.shape)
            for k, v in flatten_params(shapes["params"])[0].items()}
    assert got == want
    got_state = {name.replace(".", "/"): tuple(buf.shape)
                 for name, buf in model.named_buffers()}
    want_state = {k: tuple(v.shape) for k, v in
                  flatten_params(shapes["batch_stats"])[0].items()}
    assert got_state == want_state
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(int(np.prod(s)) for s in want.values())
    if name == "resnet50":
        assert 24e6 < n_params < 27e6, n_params
    else:
        assert 3.0e6 < n_params < 4.0e6, n_params


# ---------- worker checkpoints of a BatchNorm model ----------


def _mnist_batch(n, seed):
    images, labels = _make_separable_digits(n, seed=seed)
    return images.astype(np.float32) / 255.0, labels.astype(np.int64)


def test_batchnorm_checkpoints_restore_across_packages(tmp_path):
    """The MNIST CNN (params and batch_stats): a port checkpoint restores in
    the JAX package and a JAX checkpoint in the port; each package's eval
    outputs come back bitwise after a trip through the other, and the two
    packages' eval outputs agree."""
    x, y = _mnist_batch(4, seed=0)
    ours = LocalTrainer(mnist_model.custom_model(), mnist_model.loss,
                        mnist_model.optimizer(), device="cpu")
    ours.train_minibatch(x, y)
    exported = ours.export_variables()
    assert sorted(exported["state"]) == ["batch_stats/BatchNorm_0/mean",
                                         "batch_stats/BatchNorm_0/var"]
    assert np.abs(exported["state"]["batch_stats/BatchNorm_0/mean"]).max() \
        > 0
    want_port = ours.evaluate_minibatch(x)
    save_utils.save_trainer_checkpoint(ours, str(tmp_path / "port"))
    with np.load(tmp_path / "port.npz") as data:
        assert "batch_stats/BatchNorm_0/var" in data.files
        assert "params/Conv_0/kernel" in data.files

    # port -> JAX
    # A JAX trainer holding some variables (restore_variables, not its
    # init, which would cost seconds on the CPU); the checkpoint replaces
    # them.
    jt = JaxLocalTrainer(jmnist.custom_model(), jmnist.loss,
                         jmnist.optimizer())
    jt.restore_variables({"variables": {
        "params": _nest(exported["variables"]),
        "batch_stats": _nest({k[len("batch_stats/"):]: np.zeros_like(v)
                              for k, v in exported["state"].items()})},
        "version": 0})
    jax_save_utils.restore_trainer_checkpoint(jt, str(tmp_path / "port"))
    assert jt.get_model_version() == 1
    # The JAX trainer's eval forward, compiled here at the fast level.
    want_jax = _jit(jmnist.custom_model().apply,
                    jt.export_variables()["variables"], x)
    _close(want_jax, want_port, "eval outputs across packages")

    # JAX -> port: bitwise the port's eval outputs before the trip.
    jax_save_utils.save_trainer_checkpoint(jt, str(tmp_path / "jax"))
    back = LocalTrainer(mnist_model.custom_model(), mnist_model.loss,
                        mnist_model.optimizer(), device="cpu", seed=3)
    back.restore_on_init = str(tmp_path / "jax.npz")
    np.testing.assert_array_equal(back.evaluate_minibatch(x), want_port)
    assert back.get_model_version() == 1
    # ... and the port's file of it gives the JAX trainer its variables
    # back bitwise (so its eval outputs too).
    want_variables = flatten_params(jt.export_variables()["variables"])[0]
    save_utils.save_trainer_checkpoint(back, str(tmp_path / "again"))
    jax_save_utils.restore_trainer_checkpoint(jt, str(tmp_path / "again"))
    got_variables = flatten_params(jt.export_variables()["variables"])[0]
    assert sorted(got_variables) == sorted(want_variables)
    for name, value in want_variables.items():
        np.testing.assert_array_equal(got_variables[name], value)
    # The restored momentum trace trains on as the original does.
    assert back.train_minibatch(x, y)[2].item() == \
        ours.train_minibatch(x, y)[2].item()
    np.testing.assert_array_equal(back.evaluate_minibatch(x),
                                  ours.evaluate_minibatch(x))


def test_eval_forward_leaves_batch_stats_alone():
    x = np.random.default_rng(1).normal(size=(4, 32, 32, 3)).astype(
        np.float32)
    trainer = LocalTrainer(cifar10_cnn.custom_model(), cifar10_cnn.loss,
                           cifar10_cnn.optimizer(), device="cpu")
    first = trainer.evaluate_minibatch(x)
    state = trainer.export_variables()["state"]
    assert len(state) == 12
    assert state["batch_stats/BatchNorm_0/mean"].tolist() == [0.0] * 32
    assert state["batch_stats/BatchNorm_0/var"].tolist() == [1.0] * 32
    np.testing.assert_array_equal(trainer.evaluate_minibatch(x), first)
    assert {k: v.tolist() for k, v in
            trainer.export_variables()["state"].items()} == {
        k: v.tolist() for k, v in state.items()}


# ---------- converters ----------


def _decoded(path):
    """Every record of an .edlr file through the port's decode, as
    lists (uint8 images stay uint8 on the way)."""
    with RecordFile(str(path)) as rf:
        records = [decode_example(r) for r in rf.read(0, rf.num_records)]
    assert all(r["image"].dtype == np.uint8 for r in records)
    return [{k: v.tolist() for k, v in r.items()} for r in records]


def test_mnist_idx_converter_writes_the_jax_package_file(tmp_path):
    images, labels = _make_separable_digits(24)
    ip, lp = str(tmp_path / "i.idx.gz"), str(tmp_path / "l.idx")
    _write_idx_images(ip, images, compress=True)
    _write_idx_labels(lp, labels)
    np.testing.assert_array_equal(mnist_idx.read_idx(ip), images)
    assert mnist_idx.convert(ip, lp, str(tmp_path / "port.edlr"),
                             limit=20) == 20
    jax_mnist_idx.convert(ip, lp, str(tmp_path / "jax.edlr"), limit=20)
    records = _decoded(tmp_path / "port.edlr")
    assert _decoded(tmp_path / "jax.edlr") == records
    assert records == [{"image": images[i].tolist(), "label": int(labels[i])}
                       for i in range(20)]


def test_cifar10_pickle_converter_writes_the_jax_package_file(tmp_path):
    images, labels, batch = _make_batch(12)
    path = str(tmp_path / "data_batch_1")
    with open(path, "wb") as f:
        pickle.dump(batch, f)
    got_images, got_labels = cifar10_pickle.read_batch_file(path)
    np.testing.assert_array_equal(got_images, images)
    np.testing.assert_array_equal(got_labels, labels)
    assert cifar10_pickle.main(["--batches", path, "--output",
                                str(tmp_path / "port.edlr")]) == 0
    jax_cifar.convert(*jax_cifar.read_batch_file(path),
                      str(tmp_path / "jax.edlr"))
    records = _decoded(tmp_path / "port.edlr")
    assert _decoded(tmp_path / "jax.edlr") == records
    assert records == [{"image": images[i].tolist(), "label": int(labels[i])}
                       for i in range(12)]


def main():
    """The bfloat16 blocks' gradient gaps over six inputs (seed 0 is the
    tests'): the port's from flax's, and flax's own bfloat16 from its
    float32, each as a share of the largest gradient (flax's bfloat16)."""
    for family, in_channels, expansion in (("bottleneck", 8, None),
                                           ("inverted", 8, 6)):
        for seed in range(6):
            (_, flax16, _), (_, port16, _) = _block_step(
                family, in_channels, 2, expansion, "bfloat16", seed)
            (_, flax32, _), _ = _block_step(
                family, in_channels, 2, expansion, "float32", seed)
            largest = max(float(np.abs(g).max()) for g in flax16.values())
            flax_gap = max(float(np.abs(flax16[k] - flax32[k]).max())
                           for k in flax16) / largest
            print(f"{family} seed {seed}: port vs flax "
                  f"{_grad_gap(port16, flax16):.3e}, flax bfloat16 vs "
                  f"float32 {flax_gap:.3e}")


if __name__ == "__main__":
    main()
