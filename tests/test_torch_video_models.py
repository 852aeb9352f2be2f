"""Port's video zoo vs the JAX package on the CPU in float32: C3D (with and
without BN), the factorized 3D-ResNet and SlowFast, from the same bridged
weights (`models.import_jax`), in eval and in train mode, and the
reference-naming routes both ways (the port's ``state_dict`` through the
JAX package's ``*_from_reference`` + ``apply_import``; a reference
``c3d_bn`` checkpoint with conv biases through ``state_dict_for_port``).

Tolerance: max|port - jax| / std(jax) <= 1e-4 per output (logits and, in
train mode, every BN running statistic). The pools and the flatten order
hold to 1e-6 of the std (no conv runs before them).

Each trap of the slice is a test here: the downsample the JAX package
decides by shape while tracing (the parameter trees of every factory), the
2+1D stride split, the stems' -inf max-pool padding, pool5's symmetric H /
W padding, the adaptive pool's upsampling at 32 px, C3D's (c, t, h, w)
flatten against the JAX package's (t, h, w, c), the slow input ``x[:, :,
::alpha]``, the laterals concatenated into the slow channels, block-0-only
temporal convs, ``expansion`` forwarded to every block, and the head's
``[fast, slow]`` order.
"""
import copy
import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from fastvision_tpu.models import video as jv
from fastvision_tpu.models.import_torch import (
    apply_import,
    c3d_from_reference,
    resnet3d_from_reference,
    slowfast_from_reference,
)
from fastvision_tpu.models.video.c3d import adaptive_avg_pool3d as jax_adaptive_pool3d
from fastvision_tpu_torch.models import import_jax as bridge
from fastvision_tpu_torch.models import video as tv
from fastvision_tpu_torch.models.import_torch import state_dict_for_port
from test_torch_models import _rel_err

torch.set_num_threads(2)
REL_TOL = 1e-4
# the module names are shadowed by same-named factories in the package
c3d_module, resnet3d_module, slowfast_module = (
    importlib.import_module(f"fastvision_tpu_torch.models.video.{m}")
    for m in ("c3d", "resnet3d", "slowfast"))


def _clip(seed, b, t, s):
    return np.random.default_rng(seed).normal(0, 1, (b, t, s, s, 3)).astype(np.float32)


def _to_numpy(sd):
    return {k: t.numpy() for k, t in sd.items() if not k.endswith("num_batches_tracked")}


def _randomize_bn_(model, seed):
    """BN scale / shift / statistics drawn away from the identity, so a BN
    mapped to the wrong place or left out shows in the outputs."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return model


# (JAX model of a dtype, port model, JAX-to-port bridge, reference importer, clip [T, S])
CASES = {
    "c3d": (lambda d: jv.c3d(num_classes=7, dtype=d), lambda: tv.c3d(num_classes=7),
            bridge.c3d_state_dict_from_jax, c3d_from_reference, (16, 32)),
    "c3d_bn": (lambda d: jv.c3d_bn(num_classes=7, dtype=d), lambda: tv.c3d_bn(num_classes=7),
               bridge.c3d_state_dict_from_jax, c3d_from_reference, (16, 32)),
    "resnet18_3d": (lambda d: jv.resnet18_3d(num_classes=7, dtype=d),
                    lambda: tv.resnet18_3d(num_classes=7),
                    bridge.resnet3d_state_dict_from_jax, resnet3d_from_reference, (8, 32)),
    "resnet50_3d": (lambda d: jv.resnet50_3d(num_classes=7, dtype=d),
                    lambda: tv.resnet50_3d(num_classes=7),
                    bridge.resnet3d_state_dict_from_jax, resnet3d_from_reference, (8, 32)),
    "slowfast_resnet18_alpha4": (
        lambda d: jv.slowfast_resnet18(num_classes=7, alpha=4, dtype=d),
        lambda: tv.slowfast_resnet18(num_classes=7, alpha=4),
        bridge.slowfast_state_dict_from_jax, slowfast_from_reference, (8, 32)),
    "slowfast_small_expansion1": (
        lambda d: jv.SlowFast((1, 1, 1, 1), num_classes=7, alpha=4, beta_inv=4, expansion=1,
                              dtype=d),
        lambda: tv.SlowFast((1, 1, 1, 1), num_classes=7, alpha=4, beta_inv=4, expansion=1),
        bridge.slowfast_state_dict_from_jax, slowfast_from_reference, (8, 32)),
}


@pytest.fixture(scope="module")
def built():
    """name -> (its jitted JAX eval apply, the JAX variables, the port
    model, the clip): the port model's seeded weights (BN drawn away from
    the identity) carried into the JAX model by the JAX package's reference
    importer, so each model is built and compiled once."""
    cache = {}

    def get(name):
        if name not in cache:
            jm_fn, tm_fn, _, from_ref, (t, s) = CASES[name]
            jm = jm_fn(jnp.float32)
            x = _clip(len(name), 2, t, s)
            tm = _randomize_bn_(tm_fn(), len(name)).eval()
            shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x[:1]),
                                                    train=False))
            zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
            v = apply_import(zeros, from_ref(_to_numpy(tm.state_dict())), verbose=False)
            cache[name] = (jax.jit(lambda v, x: jm.apply(v, x, train=False)), v, tm, x)
        return cache[name]

    return get


@pytest.fixture(scope="module", params=list(CASES))
def case(request, built):
    return (request.param, *built(request.param))


# ---------------------------------------------------------------- pools
@pytest.mark.parametrize("thw", [(1, 2, 2), (2, 3, 5), (1, 4, 4), (3, 7, 6)])
def test_adaptive_avg_pool3d_is_torchs_incl_upsampling(thw):
    x = np.random.default_rng(sum(thw)).normal(0, 1, (2, *thw, 5)).astype(np.float32)
    want = np.asarray(jax_adaptive_pool3d(jnp.asarray(x), (1, 4, 4)))
    got = torch.nn.functional.adaptive_avg_pool3d(
        torch.from_numpy(x).permute(0, 4, 1, 2, 3), (1, 4, 4)).permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == want.shape == (2, 1, 4, 4, 5)
    assert _rel_err(got, want) <= 1e-6


def test_stem_pool_and_pool5_pad_with_minus_inf_on_both_sides():
    x = np.random.default_rng(5).normal(0, 1, (2, 3, 8, 7, 4)).astype(np.float32) - 5.0  # < 0
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (1, 3, 3), (1, 2, 2),
                                   padding=((0, 0), (1, 1), (1, 1))))
    got = resnet3d_module.stem_pool(xt).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_array_equal(got, want)
    want5 = np.asarray(fnn.max_pool(jnp.asarray(x[:, :2, :2, :2]), (2, 2, 2), (2, 2, 2),
                                    padding=((0, 0), (1, 1), (1, 1))))
    widths, window, padding = c3d_module.PLAN[4]  # the pool ending C3D's layer5
    pool5 = torch.nn.MaxPool3d(window, window, padding)
    got5 = pool5(xt[:, :, :2, :2, :2]).permute(0, 2, 3, 4, 1).numpy()
    assert got5.shape == want5.shape == (2, 1, 2, 2, 4)  # 2 x 2 -> 2 x 2, not 1 x 1
    np.testing.assert_array_equal(got5, want5)


# ---------------------------------------------------------------- structure
def _port_tree(factory, monkeypatch):
    """A port model's state_dict shapes, built on the meta device without
    its (seconds-long) weight initialisation."""
    for mod in (c3d_module, resnet3d_module, slowfast_module):
        monkeypatch.setattr(mod, "init_weights_", lambda m, g=None: m)
    with torch.device("meta"):
        return {k: tuple(t.shape) for k, t in factory(num_classes=9).state_dict().items()}


@pytest.mark.parametrize("name", [
    "c3d", "c3d_bn", "resnet18_3d", "resnet34_3d", "resnet50_3d", "slowfast_resnet18",
    "slowfast_resnet34", "slowfast_resnet50",
    # the deep ones differ from the 50s only in stage 3's block count and
    # take 2-5 s each to trace on the JAX side
    *(pytest.param(n, marks=pytest.mark.slow) for n in (
        "resnet101_3d", "resnet152_3d", "slowfast_resnet101", "slowfast_resnet152"))])
def test_parameter_tree_matches_jax_for_every_factory(name, monkeypatch):
    """The port's state_dict, through the JAX package's reference importer,
    names every JAX variable once with its shape: the downsamples the JAX
    package decides by shape while tracing are the ones the port builds."""
    t = 16 if name.startswith("c3d") else 8
    jm = getattr(jv, name)(num_classes=9)
    want = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, t, 32, 32, 3)),
                                          train=False))
    want = {col: {"/".join(k): tuple(a.shape) for k, a in flatten_dict(want[col]).items()}
            for col in want}
    shapes = _port_tree(getattr(tv, name), monkeypatch)
    importer = (c3d_from_reference if name.startswith("c3d") else
                slowfast_from_reference if name.startswith("slowfast") else resnet3d_from_reference)
    zeros = {k: np.zeros(s, np.float32) for k, s in shapes.items()
             if not k.endswith("num_batches_tracked")}
    got = importer(zeros)
    for col in ("params", "batch_stats"):
        got_col = {k: tuple(np.shape(a)) for k, a in got.get(col, {}).items()}
        assert got_col == want.get(col, {}), col


def test_slowfast_widths_laterals_and_expansion():
    m = tv.SlowFast((1, 1, 1, 1), num_classes=3, alpha=4, beta_inv=8, expansion=2)
    sp, fp = m.slow_pathway, m.fast_pathway
    assert sp.res2[0].conv1.conv.in_channels == 64 + 16  # the stem lateral: 2 * 64 / 8
    assert sp.res3[0].conv1.conv.in_channels == 64 * 2 + 8 * 2 * 2
    assert [getattr(sp, f"res{k}")[0].conv3.conv.out_channels for k in range(2, 6)] == \
        [128, 256, 512, 1024]  # expansion 2 on every block, not the default 4
    assert [getattr(sp, f"res{k}")[0].conv1.conv.kernel_size[0] for k in range(2, 6)] == \
        [1, 1, 3, 3]
    assert [getattr(fp, f"res{k}")[0].conv1.conv.kernel_size[0] for k in range(2, 6)] == \
        [3, 3, 3, 3]
    assert fp.lateral_res4.conv.stride == (4, 1, 1) and fp.lateral_res4.conv.padding == (2, 0, 0)
    assert fp.lateral_pool1.conv.bias is None
    assert m.fc.in_features == 512 // 8 * 2 + 512 * 2  # [fast, slow]


# ---------------------------------------------------------------- forwards
def _dropout_recorder(keeps, seed=0, rate=0.5):
    """An interceptor giving flax's Dropout masks drawn here, recorded in
    ``keeps`` for the port."""
    rng = np.random.default_rng(seed)

    def intercept(next_fun, args, kwargs, context):
        if not isinstance(context.module, fnn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        x = args[0]
        keep = rng.uniform(size=x.shape) < 1.0 - rate
        keeps.append(keep)
        return jnp.where(keep, x / (1.0 - rate), 0.0)

    return intercept


def test_eval_forward_matches_jax_both_bridges(case):
    """The port's keys are the reference's: the JAX package's importer and
    ``apply_import`` carry every weight into the JAX model (its tree
    started at zeros), both give the same logits, and the bridge from the
    JAX package's variables (`models.import_jax`) gives the port's weights
    back exactly."""
    name, apply, v, tm, x = case
    want = np.asarray(apply(v, x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 7)
    assert _rel_err(got, want) <= REL_TOL, name
    back = CASES[name][2](jax.device_get(v))
    sd = tm.state_dict()
    assert back.keys() == sd.keys()
    for k, t in back.items():
        assert torch.equal(t, sd[k]) or k.endswith("num_batches_tracked"), k
    routed = state_dict_for_port(sd, task="video")  # the port's own checkpoint: as it is
    assert routed.keys() == sd.keys()
    assert all(torch.equal(routed[k], t) for k, t in sd.items())


@pytest.mark.parametrize("name", list(CASES))
def test_train_forward_and_bn_statistics_match_jax(name, built):
    """Train mode, in float64 on both sides, on 4 clips: batch statistics in
    the forward, the running statistics moved as flax moves them, and
    C3D's dropout with the JAX package's masks. In float32 flax's one-pass
    variance E[x^2] - E[x]^2 alone puts the JAX package's train-mode
    logits ~1.6e-4 of their std from a two-pass result. With 2 clips the
    3D-ResNets' last stage (1 x 1 x 1 at 32 px) normalizes 2 values per
    channel: nearly equal pairs make that BN ill-conditioned, and even the
    two packages' float64 results then sit up to ~2.5e-4 of the std apart
    (seed-dependent; 4 clips: ~1e-10)."""
    _, v, tm, _ = built(name)
    x = _clip(len(name) + 1, 4, *CASES[name][4])
    keeps: list = []
    with jax.enable_x64(True):
        jm = CASES[name][0](jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        with fnn.intercept_methods(_dropout_recorder(keeps)):
            want, new = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
                v64, x.astype(np.float64))
        want, new = np.asarray(want), jax.device_get(new)
    port = copy.deepcopy(tm).double().train()
    kw = {"keep_masks": [torch.from_numpy(k) for k in keeps]} if keeps else {}
    with torch.no_grad():
        got = port(torch.from_numpy(x).double(), **kw).numpy()
    assert len(keeps) == (2 if name.startswith("c3d") else 0)
    assert _rel_err(got, want) <= REL_TOL, name
    if "batch_stats" in new:
        moved = CASES[name][2]({"params": v["params"], "batch_stats": new["batch_stats"]})
        sd = port.state_dict()
        stats = [k for k in moved if k.endswith(("running_mean", "running_var"))]
        assert stats
        for k in stats:
            assert _rel_err(sd[k].numpy(), moved[k].numpy()) <= REL_TOL, k


def test_c3d_bn_reference_checkpoint_with_conv_biases(built):
    """A reference ``c3d_bn`` checkpoint has conv biases before its BNs:
    the port folds each into the BN's running mean, as the JAX importer
    does, and both give the model's logits."""
    apply, v, tm, x = built("c3d_bn")
    with torch.no_grad():
        want = tm.eval()(torch.from_numpy(x)).numpy()
    rng = np.random.default_rng(4)
    ref = {k: t.clone() for k, t in tm.state_dict().items()}
    for k in [k for k in ref if k.endswith(".conv.weight")]:
        b = torch.from_numpy(rng.normal(0, 0.2, ref[k].shape[0]).astype(np.float32))
        ref[k.replace(".weight", ".bias")] = b
        li, n = k.split(".")[:2]
        ref[f"{li}.{int(n) + 1}.running_mean"] += b  # BN(conv(x) + b) is the same function
    other = copy.deepcopy(tm)
    other.load_state_dict(state_dict_for_port(ref, task="video"))
    with torch.no_grad():
        assert _rel_err(other.eval()(torch.from_numpy(x)).numpy(), want) <= REL_TOL
    loaded = apply_import(jax.tree_util.tree_map(np.zeros_like, v),
                          c3d_from_reference(_to_numpy(ref)), verbose=False)
    assert _rel_err(np.asarray(apply(loaded, x)), want) <= REL_TOL
    with pytest.raises(ValueError, match="video checkpoint naming"):
        state_dict_for_port({"conv1.weight": torch.zeros(4, 3, 3, 3)}, task="video")


def test_c3d_train_dropout_needs_a_generator(built):
    _, _, tm, x = built("c3d")
    tm, x = copy.deepcopy(tm).train(), torch.from_numpy(x)
    with pytest.raises(ValueError, match="generator"):
        tm(x)
    with torch.no_grad():
        got = tm(x, generator=torch.Generator().manual_seed(7))
        g = torch.Generator().manual_seed(7)  # the same draws: fc6's mask, then fc7's
        masks = [torch.rand((2, 4096), generator=g) < 0.5 for _ in range(2)]
        assert torch.equal(got, tm(x, keep_masks=masks))
