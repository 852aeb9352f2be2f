"""Port's classification zoo vs the JAX package on the CPU in float32: the
pools of nn/layers.py, ResNet and a grouped (ResNeXt) bottleneck, the VGG
top, the Darknet-53 top and ViT, from the same bridged weights
(`models.import_jax`), and the torch-naming routes both ways.

Tolerance: max|port - jax| / std(jax) <= 1e-4 per output (different conv
and matmul algorithms sum float32 in different orders; scaling by the
output's std keeps a layout bug from hiding under a bare atol). Pools and
the flatten-order checks hold to 1e-6 of the std (no conv runs before them).

Each trap of the port is a test here: ``k // 2`` padding at stride 2, the
stem's -inf max-pool padding, ResNeXt's groups, the non-divisible
``adaptive_avg_pool`` fallback, VGG's (h, w, c) flatten against a torch
checkpoint's (c, h, w), LayerNorm's epsilon 1e-6, the tanh GELU, flax's
attention kernel layouts, and ViT's float32 head under bf16.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvision_tpu.models import classification as jz
from fastvision_tpu.models.import_torch import (
    apply_import,
    resnet_from_reference,
    resnet_from_torchvision,
    vgg_from_torchvision,
)
from fastvision_tpu.nn import layers as jl
from fastvision_tpu_torch.models import classification as tz
from fastvision_tpu_torch.models import import_jax as bridge
from fastvision_tpu_torch.models.import_torch import state_dict_for_port
from fastvision_tpu_torch.nn import layers as tl
from test_torch_models import _randomize_bn, _rel_err

torch.set_num_threads(2)
REL_TOL = 1e-4
SMALL_VGG = (8, "M", 16, "M")  # a 2-stage trunk: 28 px -> 7 x 7, 32 px -> 8 x 8 before the pool


def _nhwc(seed, b, h, w=None):
    return np.random.default_rng(seed).normal(0, 1, (b, h, w or h, 3)).astype(np.float32)


def _jax_apply(jm):
    return jax.jit(lambda v, x: jm.apply(v, x, train=False))


def _jax_forward(jm, x, seed=0, randomize_bn=True):
    """(JAX variables with BN drawn away from identity, JAX eval logits, the
    jitted apply)."""
    v = jax.device_get(jax.jit(lambda k, x: jm.init(k, x, train=False))(
        jax.random.key(seed), jnp.asarray(x[:1])))
    if randomize_bn and "batch_stats" in v:
        v = _randomize_bn(v, seed + 1)
    apply = _jax_apply(jm)
    return v, np.asarray(apply(v, jnp.asarray(x))), apply


def _port_forward(tm, x):
    tm.eval()
    with torch.no_grad():
        return tm(torch.from_numpy(x)).numpy()


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("hw", [(7, 7), (14, 21), (8, 8), (10, 13), (9, 7)])
def test_adaptive_avg_pool_matches_jax_incl_fallback(hw):
    x = np.random.default_rng(hw[0] * 31 + hw[1]).normal(0, 1, (2, *hw, 5)).astype(np.float32)
    want = np.asarray(jl.adaptive_avg_pool(jnp.asarray(x), (7, 7)))
    got = tl.adaptive_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), (7, 7))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert _rel_err(got, want) <= 1e-6
    if hw in ((10, 13), (9, 7)):  # the trap: torch's adaptive pool averages other windows
        ref = torch.nn.functional.adaptive_avg_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                                                      (7, 7)).permute(0, 2, 3, 1).numpy()
        assert _rel_err(ref, want) > 1e-3


def test_max_pool_padding_global_pool_and_dense():
    x = np.random.default_rng(3).normal(0, 1, (2, 9, 8, 4)).astype(np.float32) - 5.0  # all < 0
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), (2, 2), ((1, 1), (1, 1))))
    got = tl.max_pool(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, padding=1)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)  # -inf, not 0, pads
    np.testing.assert_allclose(tl.global_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2)),
                               np.asarray(jl.global_avg_pool(jnp.asarray(x))), rtol=1e-6)
    d = tl.Dense(300, 200, generator=torch.Generator().manual_seed(0))
    assert float(d.weight.detach().std()) == pytest.approx(np.sqrt(2 / 300), rel=0.05)
    assert float(d.bias.detach().abs().max()) == 0.0
    tl.init_weights_(d, torch.Generator().manual_seed(1))  # stays he-normal, not lecun
    assert float(d.weight.detach().std()) == pytest.approx(np.sqrt(2 / 300), rel=0.05)


# ---------------------------------------------------------------- ResNet / ResNeXt
@pytest.mark.parametrize("name", ["resnet18", "resnext_small"])
def test_resnet_matches_jax(name):
    if name == "resnet18":
        jm, tm = jz.resnet18(num_classes=10), tz.resnet18(num_classes=10)
    else:  # a grouped bottleneck: width int(64 * 4 / 64) * 4 = 16 at stage 1
        jm = jz.ResNet(jz.resnet.Bottleneck, (1, 1, 1, 1), num_classes=10, groups=4,
                       base_width=4)
        tm = tz.ResNet(tz.Bottleneck, (1, 1, 1, 1), num_classes=10, groups=4, base_width=4)
        assert tm.layer1[0].conv2.groups == 4 and tm.layer1[0].conv2.out_channels == 16
    x = _nhwc(1, 2, 64)  # even sizes: where XLA's SAME would pad right-biased
    v, want, apply = _jax_forward(jm, x)
    tm.load_state_dict(bridge.resnet_state_dict_from_jax(v))
    assert _rel_err(_port_forward(tm, x), want) <= REL_TOL

    # torchvision names: the port's state_dict loads into the JAX model unchanged
    sd = {k: t.numpy() for k, t in tm.state_dict().items()}
    zeros = jax.tree_util.tree_map(np.zeros_like, v)
    back = np.asarray(apply(apply_import(zeros, resnet_from_torchvision(sd), verbose=False), x))
    assert _rel_err(back, want) <= REL_TOL

    # the trunk contract: [C5, C4, C3] from NCHW
    trunk = tz.ResNet(tz.Bottleneck if name != "resnet18" else tz.BasicBlock,
                      (1, 1, 1, 1), including_top=False)
    feats = trunk(torch.zeros(1, 3, 64, 64))
    assert [f.shape[1] for f in feats] == trunk.channels_per_level
    assert [64 // f.shape[2] for f in feats] == trunk.strides_per_level


def test_resnet_reference_and_torchvision_routes():
    tm = tz.ResNet(tz.BasicBlock, (1, 1, 1, 1), num_classes=5,
                   generator=torch.Generator().manual_seed(2))
    sd = tm.state_dict()
    # the reference's own names: stem Sequential conv1.{0,1}, stages res2..res5
    ref = {}
    for k, v in sd.items():
        if k.startswith("conv1."):
            k = "conv1.0." + k[6:]
        elif k.startswith("bn1."):
            k = "conv1.1." + k[4:]
        elif k.startswith("layer"):
            k = f"res{int(k[5]) + 1}." + k.split(".", 1)[1]
        ref[k] = v
    routed = state_dict_for_port(ref, task="cls")
    assert routed.keys() == sd.keys()
    assert all(torch.equal(routed[k], sd[k]) for k in sd)
    jax_ref = resnet_from_reference({k: v.numpy() for k, v in ref.items()})
    assert jax_ref["params"].keys() == resnet_from_torchvision(
        {k: v.numpy() for k, v in sd.items()})["params"].keys()
    assert state_dict_for_port(sd, task="cls").keys() == sd.keys()  # torchvision: as it is


# ---------------------------------------------------------------- VGG top
@pytest.mark.parametrize("size", [28, 32])  # 7 x 7 (divisible) and 8 x 8 (the fallback)
def test_vgg_top_matches_jax_both_flatten_orders(size):
    jm = jz.VGG(SMALL_VGG, batch_norm=True, num_classes=6)
    tm = tz.VGG(SMALL_VGG, batch_norm=True, num_classes=6)
    x = _nhwc(size, 2, size)
    v, want, apply = _jax_forward(jm, x)
    tm.load_state_dict(bridge.vgg_state_dict_from_jax(v))
    got = _port_forward(tm, x)
    assert _rel_err(got, want) <= REL_TOL

    # a torch checkpoint flattens (c, 7, 7) before fc1: torchvision names, fc1's
    # columns in that order, and a plain torch forward as the reference
    w1 = tm.fc1.weight.detach().reshape(4096, 7, 7, 16).permute(0, 3, 1, 2).reshape(4096, -1)
    tv = {"features.0.weight": tm.conv0.conv.weight, "features.0.bias": torch.zeros(8),
          "features.3.weight": tm.conv1.conv.weight, "features.3.bias": torch.zeros(16),
          "classifier.0.weight": w1, "classifier.0.bias": tm.fc1.bias,
          "classifier.3.weight": tm.fc2.weight, "classifier.3.bias": tm.fc2.bias,
          "classifier.6.weight": tm.fc3.weight, "classifier.6.bias": tm.fc3.bias}
    for i, n in ((0, 1), (1, 4)):
        for name in ("weight", "bias", "running_mean", "running_var"):
            tv[f"features.{n}.{name}"] = getattr(getattr(tm, f"conv{i}").bn, name)
    tv = {k: v.detach().clone() for k, v in tv.items()}
    with torch.no_grad():
        t = tm.trunk(torch.from_numpy(x).permute(0, 3, 1, 2))
        flat_chw = tl.adaptive_avg_pool(t, (7, 7)).flatten(1)  # torch's own flatten
        h = torch.relu(flat_chw @ tv["classifier.0.weight"].T + tv["classifier.0.bias"])
        h = torch.relu(tm.fc2(h))
        torch_ref = tm.fc3(h).numpy()
    assert _rel_err(torch_ref, want) <= REL_TOL
    other = tz.VGG(SMALL_VGG, batch_norm=True, num_classes=6)
    other.load_state_dict(state_dict_for_port(tv, task="cls"), strict=False)
    assert _rel_err(_port_forward(other, x), want) <= REL_TOL
    # ... and the JAX package's importer reads the same checkpoint the same way
    # (its fc1 re-interleave assumes VGG's 512 channels: this one's 16 go by hand)
    imported = vgg_from_torchvision({k: v.numpy() for k, v in tv.items()
                                     if k != "classifier.0.weight"}, batch_norm=True)
    w = tv["classifier.0.weight"].numpy().reshape(4096, 16, 7, 7).transpose(0, 2, 3, 1)
    imported["params"]["fc1/kernel"] = w.reshape(4096, -1).T
    v3 = apply_import(jax.tree_util.tree_map(np.zeros_like, v), imported, verbose=False)
    assert _rel_err(np.asarray(apply(v3, x)), want) <= REL_TOL


def test_vgg_train_dropout_needs_a_generator_and_matches_given_masks():
    tm = tz.VGG(SMALL_VGG, num_classes=4, generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(_nhwc(4, 2, 28))
    with pytest.raises(ValueError, match="generator"):
        tm(x)
    with torch.no_grad():
        got = tm(x, generator=torch.Generator().manual_seed(7))
        g = torch.Generator().manual_seed(7)  # the same draws: fc1's mask, then fc2's
        masks = [torch.rand((2, 4096), generator=g) < 0.5 for _ in range(2)]
        assert torch.equal(got, tm(x, keep_masks=masks))
        assert not torch.equal(got, tm.eval()(x))


# ---------------------------------------------------------------- Darknet-53 top
class _ShallowJaxDarknet(jz.Darknet53):
    stage_sizes = (1, 1, 1, 1, 1)


def test_darknet53_top_matches_jax():
    jm = _ShallowJaxDarknet(num_classes=7)
    tm = tz.Darknet53(stage_sizes=(1, 1, 1, 1, 1), including_top=True, num_classes=7)
    x = _nhwc(6, 2, 64)
    v, want, _ = _jax_forward(jm, x)
    tm.load_state_dict(bridge.darknet53_classifier_state_dict_from_jax(v))
    assert _rel_err(_port_forward(tm, x), want) <= REL_TOL
    assert tz.darknet53(num_classes=3).including_top
    # the reference's classifier names are the port's: they pass as they are
    assert state_dict_for_port(tm.state_dict(), task="cls").keys() == tm.state_dict().keys()


# ---------------------------------------------------------------- ViT
def _vit_pair():
    jm = jz.ViT(num_classes=5, patch=8, dim=32, depth=2, heads=2)
    tm = tz.ViT(num_classes=5, patch=8, dim=32, depth=2, heads=2, image_size=32)
    return jm, tm


def test_vit_matches_jax():
    jm, tm = _vit_pair()
    x = _nhwc(8, 2, 32)
    v, _, apply = _jax_forward(jm, x, randomize_bn=False)
    # non-trivial norms, biases and embeddings, so a misplaced one shows
    rng = np.random.default_rng(9)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape)
                               .astype(np.float32), v)
    want = np.asarray(apply(v, x))
    tm.load_state_dict(bridge.vit_state_dict_from_jax(v))
    assert _rel_err(_port_forward(tm, x), want) <= REL_TOL
    assert tm.pos_embed.shape == (1, 17, 32)


@pytest.mark.parametrize("scale", [1.0, 1e-3])  # 1e-3: variance ~1e-6, where eps matters
def test_vit_block_traps_eps_gelu_attention_layout(scale):
    jb = jz.vit.EncoderBlock(32, heads=4)
    x = (np.random.default_rng(10).normal(0, 1, (2, 9, 32)) * scale).astype(np.float32)
    v = jax.device_get(jb.init(jax.random.key(3), jnp.asarray(x)))
    rng = np.random.default_rng(11)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a) * 2 + rng.normal(0, 0.1, a.shape)
                               .astype(np.float32), v)
    want = np.asarray(jb.apply(v, jnp.asarray(x)))
    tb = tz.EncoderBlock(32, heads=4)
    sd = bridge.vit_state_dict_from_jax({"params": {"block0": v["params"], "norm": {
        "scale": np.ones(32), "bias": np.zeros(32)}, "patch_embed": {
        "kernel": np.zeros((1, 1, 3, 32)), "bias": np.zeros(32)},
        "cls_token": np.zeros((1, 1, 32)), "pos_embed": np.zeros((1, 1, 32))}})
    tb.load_state_dict({k[len("blocks.0."):]: t for k, t in sd.items() if k.startswith("blocks.0.")})
    with torch.no_grad():
        got = tb(torch.from_numpy(x)).numpy()
    assert _rel_err(got - x, want - x) <= REL_TOL  # the block's update, not the residual
    assert tb.norm1.eps == 1e-6


def test_vit_head_runs_in_float32_under_bf16():
    _, tm = _vit_pair()
    tm.eval()
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        out = tm(torch.from_numpy(_nhwc(12, 2, 32)))
    assert out.dtype == torch.float32
