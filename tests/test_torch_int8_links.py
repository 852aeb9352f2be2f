"""The int8 link plan (`infer.quantize.link_int8`) and the fused epilogue's
plain version, on the CPU.

A linked int8 conv writes its consumer's int8 input from its own epilogue
(and adds Darknet's residual there), so the consumer runs no quantize pass.
Held here:

- `int8_conv_plain` with a residual, an ``out_scale`` and ``keep_float``
  byte-equal to the composed route (`epilogue_plain`, PyTorch's add,
  `quantize_activation`) in bfloat16 and float32 at k 1 / 3, stride 1 / 2;
  the card wrapper refuses what its kernel does not take, before any build;
- the plan of a small YOLOv3 lists exactly the edges its modules declare,
  and only between convs the implicit GEMM takes; on the full-depth
  YOLOv3-416 structure (built on the ``meta`` device) it leaves 5 quantize
  passes of 71 (38 producers write int8 only, 28 int8 and float: stages 1
  and 2 hand their last output on in int8 only, no one reads its float);
  a Darknet-53 alone, as a backbone or a classifier, returns float levels
  and drops only the floats it never reads;
- the linked forward is bit-equal to the unlinked one (float32 and bf16
  autocast), runs one quantize pass per unlinked consumer and no residual
  add, and stays within test_torch_quantize.py's 1e-3 of the JAX package's
  quantized YOLOv3; a JAX-path ``skip`` list leaves the same convs float in
  both packages and unlinks every edge into or out of them;
- the kernels' quantize rule (a product with the correctly rounded
  reciprocal, the IEEE division within 2^-14 of a half-integer), emulated
  in float32 numpy, gives `quantize_activation`'s integers where the two
  roundings meet and on random values, where the product alone does not;
- the stems' patches (3x3 stride 1 and 7x7 stride 2, C = 3), the line
  kernel's plain version, equal a numpy im2col.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvision_tpu.infer.quantize as jq
import fastvision_tpu_torch.infer.quantize as tq
from fastvision_tpu_torch.models import YOLOv3, quant_state_from_jax
from fastvision_tpu_torch.models.classification.darknet53 import Darknet53
from fastvision_tpu_torch.nn.layers import Carried, ConvBN, Int8Conv, conv_bn_pairs, init_weights_
from fastvision_tpu_torch.ops import int8 as ti
from fastvision_tpu_torch.testing import quantize_tie_cases
from test_torch_quantize import SIZE, _random_variables, _rel, _yolo_pair

torch.set_num_threads(2)


def _case(seed, b, c, h, w, n, k, stride, dtype):
    g = torch.Generator().manual_seed(seed)
    xq = torch.randint(-127, 128, (b, h, w, c), generator=g, dtype=torch.int8)
    w_q = torch.randint(-127, 128, (n, c, k, k), generator=g, dtype=torch.int8)
    scale = torch.rand(n, generator=g) * 2e-5 + 1e-6
    bias = torch.randn(n, generator=g)
    ho, wo = ti.out_hw(h, w, k, stride, k // 2)
    res = (torch.randn(b * ho * wo, n, generator=g) * 2).to(dtype)
    return xq, ti.gemm_weight(w_q), scale, bias, res


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("with_residual", [False, True], ids=["no_residual", "residual"])
@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_plain_fused_conv_equals_the_composed_route(dtype, with_residual, k, stride):
    n = 40
    xq, mat, scale, bias, res = _case(k * 10 + stride, 2, 32, 9, 7, n, k, stride, dtype)
    residual = res if with_residual else None
    out_scale = torch.tensor(0.0173)
    acc, none = ti.int8_conv_plain(xq, mat, n, k, stride)
    assert none is None and acc.dtype == torch.int32
    y = ti.epilogue_plain(acc, n, scale, bias, "silu", dtype)
    s = y if residual is None else residual + y
    q_want = ti.quantize_activation(s, out_scale)
    assert q_want.abs().max() == 127 and (q_want != 0).float().mean() > 0.5  # clips; not all 0
    for keep in (True, False):
        got, q = ti.int8_conv_plain(xq, mat, n, k, stride, scale, bias, "silu", dtype,
                                    residual, out_scale, keep)
        assert torch.equal(q, q_want) and q.dtype == torch.int8
        assert (got is None) if not keep else (got.dtype == dtype and torch.equal(got, s))
    only_float, no_q = ti.int8_conv_plain(xq, mat, n, k, stride, scale, bias, "silu", dtype,
                                          residual)
    assert no_q is None and torch.equal(only_float, s)


@pytest.fixture
def no_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(ti.cuda_build, "load", refuse)
    ti._conv_lib.cache_clear()
    ti._lib.cache_clear()


def test_fused_wrapper_refuses_before_any_build(no_build):
    xq, mat, scale, bias, res = _case(1, 1, 64, 8, 8, 32, 3, 1, torch.bfloat16)
    one = torch.tensor(0.5)
    with pytest.raises(ValueError, match="mode \\(a\\)"):
        ti.int8_conv_cuda(xq, mat, 32, 3, 1, residual=res)
    with pytest.raises(ValueError, match="mode \\(a\\)"):
        ti.int8_conv_cuda(xq, mat, 32, 3, 1, out_scale=one)
    with pytest.raises(ValueError, match="residual"):
        ti.int8_conv_cuda(xq, mat, 32, 3, 1, scale, bias, "silu", torch.float32, res)
    with pytest.raises(ValueError, match="residual"):
        ti.int8_conv_cuda(xq, mat, 32, 3, 1, scale, bias, "silu", torch.bfloat16, res[1:])
    with pytest.raises(ValueError, match="out_scale"):
        ti.int8_conv_cuda(xq, mat, 32, 3, 1, scale, bias, "silu", torch.bfloat16,
                          out_scale=torch.ones(2))
    with pytest.raises(ValueError, match="keep_float"):
        ti.int8_conv_cuda(xq, mat, 32, 3, 1, scale, bias, "silu", torch.bfloat16,
                          keep_float=False)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ti.int8_conv_cuda(xq, mat, 32, 3, 1, scale, bias, "silu", torch.bfloat16, res, one,
                          False)
    with pytest.raises(ValueError, match="implicit GEMM"):  # an RGB stem writes no int8
        ti.quantized_conv(torch.zeros(1, 3, 8, 8), one, torch.zeros(32, 3, 3, 3, dtype=torch.int8),
                          torch.zeros(32, 32, dtype=torch.int8), torch.ones(32), torch.ones(32), 1,
                          1, 1, "silu", torch.float32, out_scale=one)


# ---------------------------------------------------------------- the plan
def _quantized(model, x):
    model.eval()
    tq.quantize_model(model, [x])
    return model


def _small_yolo(channels=(256, 128, 64)):
    return YOLOv3(num_classes=4, channels=channels, stage_sizes=(1, 1, 1, 1, 1),
                  generator=torch.Generator().manual_seed(0))


def _stage_edges():
    """The declared edges of Darknet-53 with one block a stage: the float
    goes with the int8 copy where a skip or a returned level reads it."""
    out, prev = [], None
    for i in range(1, 6):
        if prev:
            out.append((prev, f"backbone.conv{i}", i - 1 >= 3))
        out += [(f"backbone.conv{i}", f"backbone.res{i}.0.conv1", True),
                (f"backbone.res{i}.0.conv1", f"backbone.res{i}.0.conv2", False)]
        prev = f"backbone.res{i}.0.conv2"
    return out


NECK_EDGES = [(f"neck.neck_{lvl}.{j}", f"neck.neck_{lvl}.{j + 1}", False)
              for lvl in ("small", "medium", "large") for j in range(4)] + [
    ("neck.neck_small.4", "neck.neck_out_small", True),
    ("neck.neck_medium.4", "neck.neck_out_medium", True),
    ("neck.neck_large.4", "neck.neck_out_large", False),
    ("backbone.res5.0.conv2", "neck.neck_small.0", True)]


def _implicit(model):
    return {n[:-len(".conv")] for n, conv, _ in conv_bn_pairs(model)
            if "quant" in conv._modules and conv.quant.on_implicit_gemm}


@torch.no_grad()
def test_small_yolov3_plan_lists_exactly_the_declared_edges():
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    model = _quantized(_small_yolo(), x)
    plan = tq.link_int8(model)
    assert sorted(plan) == sorted(_stage_edges() + NECK_EDGES)
    implicit = _implicit(model)
    assert len(implicit) == 35 and len(implicit) - len(plan) == 5  # all but the stem
    # reinstalling rebuilds the same plan, and the plan is what the forward reads
    tq.install_quant(model, tq.quant_state(model))
    assert sorted(tq.link_int8(model)) == sorted(plan)
    links = {n: conv.quant.link for n, conv, _ in conv_bn_pairs(model) if conv.quant.link}
    assert len(links) == len(plan)
    # a neck too narrow for the implicit GEMM at P3 (C = 16): no edge touches those convs
    narrow = _quantized(_small_yolo((128, 64, 32)), x)
    narrow_plan = tq.link_int8(narrow)
    ok = _implicit(narrow)
    assert sorted(narrow_plan) == sorted(e for e in _stage_edges() + NECK_EDGES
                                         if e[0] in ok and e[1] in ok)
    assert len(narrow_plan) < len(plan)
    assert tq.link_int8(narrow, enabled=False) == [] and not any(
        conv.quant.link for _, conv, _ in conv_bn_pairs(narrow))


def test_full_depth_plan_leaves_five_quantize_passes_of_71():
    """YOLOv3-416 as served (Darknet-53 (1, 2, 8, 8, 4), 80 classes), built
    and quantized on the meta device: no values, the structure alone."""
    with torch.device("meta"):
        model = YOLOv3(num_classes=80)
        state = {name: {"w_q": torch.empty(conv.weight.shape, dtype=torch.int8),
                        "w_scale": torch.empty(conv.out_channels),
                        "in_scale": torch.empty(()), "bias": torch.empty(conv.out_channels)}
                 for name, conv, _ in conv_bn_pairs(model)}
    assert tq.install_quant(model, state) == 72
    plan = tq.link_int8(model)
    implicit = _implicit(model)
    assert len(implicit) == 71 and len(plan) == 66
    consumers = {c for _, c, _ in plan}
    assert sorted(implicit - consumers) == [
        "backbone.conv1", "neck.neck_large.0", "neck.neck_medium.0",
        "neck.up_sampling_medium.0", "neck.up_sampling_small.0"]
    keep = [k for _, _, k in plan]
    assert keep.count(False) == 38 and keep.count(True) == 28
    assert [(p, k) for p, c, k in plan if c in ("backbone.conv2", "backbone.conv3")] == [
        ("backbone.res1.0.conv2", False), ("backbone.res2.1.conv2", False)]
    producers = {p for p, _, _ in plan}
    assert sum(p.startswith("backbone.res") and p.endswith(".conv2") for p in producers) == 23
    assert all(isinstance(q.link[0], Int8Conv) for q in model.modules()
               if isinstance(q, Int8Conv) and q.link)


@torch.no_grad()
@pytest.mark.parametrize("including_top", [False, True], ids=["backbone", "classifier"])
def test_darknet_alone_returns_floats_and_drops_only_unread_floats(including_top):
    """A quantized Darknet-53 on its own: its outputs are float tensors
    (nothing outside it reads an int8 copy), bit-equal to the unlinked
    forward, and only the stage outputs no one reads as floats (stages 1
    and 2; every stage but the last in the classifier) go on in int8 only."""
    model = Darknet53(stage_sizes=(1, 1, 1, 1, 1), including_top=including_top,
                      num_classes=10)
    init_weights_(model, torch.Generator().manual_seed(3))
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(4))
    run = (lambda: model(x)) if including_top else (lambda: model(x.permute(0, 3, 1, 2)))
    model.eval()
    tq.quantize_model(model, [x if including_top else x.permute(0, 3, 1, 2)])
    plan = tq.link_int8(model)
    float_dropped = sorted(c for _, c, k in plan if not k and c.startswith("conv"))
    assert float_dropped == (["conv2", "conv3", "conv4", "conv5"] if including_top
                             else ["conv2", "conv3"])
    linked = run()
    tq.link_int8(model, enabled=False)
    unlinked = run()
    outs = [linked] if including_top else linked
    assert all(torch.is_tensor(t) for t in outs)
    assert all(torch.equal(a, b) for a, b in zip(outs, [unlinked] if including_top else unlinked))


@pytest.fixture(scope="module")
def pair():
    """The shallow JAX YOLOv3 and the port's with the same random weights
    (test_torch_quantize.py's), the NHWC input, and JAX's calibration."""
    jm, tm, bridge = _yolo_pair()
    x = np.random.default_rng(40).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    v = _random_variables(jm, 41, jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    tm.load_state_dict(bridge(v), strict=True)
    tm.eval()
    return jm, v, tm, bridge, x, jq.calibrate(jm, v, [jnp.asarray(x)])


def _heads(model, x, dtype=None):
    with torch.no_grad(), torch.autocast("cpu", dtype=dtype or torch.bfloat16,
                                         enabled=dtype is not None):
        return model(torch.from_numpy(x))


def _counted_forward(model, x, monkeypatch):
    """The heads, the standalone quantize passes the forward ran (the
    activation quantized at its consumer's input, 4-D; a linked producer's
    int8 output is 2-D inside `int8_conv_plain`) and the residual adds that
    ran outside an epilogue."""
    passes = []
    real = ti.quantize_activation
    monkeypatch.setattr(ti, "quantize_activation",
                        lambda t, s: passes.append(t.ndim) or real(t, s))
    before = ti.add_residual.runs
    heads = _heads(model, x)
    monkeypatch.setattr(ti, "quantize_activation", real)
    return heads, passes.count(4), ti.add_residual.runs - before


@pytest.mark.parametrize("skip", [(), ("neck/out", "stage3")], ids=["all", "skip"])
def test_linked_forward_bit_equal_to_unlinked_and_close_to_jax(pair, skip, monkeypatch):
    jm, v, tm, bridge, x, calib = pair
    qv = jq.quantize_variables(v, calib, skip=skip)
    model = copy.deepcopy(tm)
    port_calib = quant_state_from_jax({**v, "quant_calib": calib}, bridge, "quant_calib")
    tq.quantize_variables(model, port_calib, skip=skip)
    assert sorted(tq.quant_state(model)) == sorted(quant_state_from_jax(qv, bridge))
    plan = tq.link_int8(model)
    floats = {n[:-len(".conv")] for n, conv, _ in conv_bn_pairs(model)
              if "quant" not in conv._modules}
    if skip:
        assert floats == {"neck.neck_out_small", "neck.neck_out_medium", "neck.neck_out_large",
                          "backbone.res3.0.conv1", "backbone.res3.0.conv2"}
        want = [e for e in _stage_edges() + NECK_EDGES if not {e[0], e[1]} & floats]
        assert sorted(plan) == sorted(want) and len(plan) == 24
    else:
        assert not floats and len(plan) == 30
    linked, passes, adds = _counted_forward(model, x, monkeypatch)
    # one pass for each conv the plan leaves unlinked (the stem's included); the
    # skip adds conv3 -> res3.0 ... as float convs: their residual add runs in torch
    assert passes == len(tq.quant_state(model)) - len(plan)
    assert adds == (1 if skip else 0)
    want = jm.apply(qv, jnp.asarray(x), train=False)
    for g, w in zip(linked, want):
        assert _rel(g.numpy(), np.asarray(w).reshape(g.shape)) <= 1e-3
    for dtype in (None, torch.bfloat16):
        tq.link_int8(model)
        a = _heads(model, x, dtype)
        tq.link_int8(model, enabled=False)
        b = _heads(model, x, dtype)
        assert all(torch.equal(h, u) for h, u in zip(a, b))
    _, unlinked_passes, _ = _counted_forward(model, x, monkeypatch)
    assert unlinked_passes == len(tq.quant_state(model))


@torch.no_grad()
def test_link_only_to_a_consumer_in_eval_mode_and_residual_of_the_output_type():
    """A link hands on int8 only to a consumer in eval mode (a consumer in
    train mode gets the float output); a residual of another float type
    than the conv's output is refused, not promoted behind the caller."""
    g = torch.Generator().manual_seed(2)
    stack = torch.nn.Sequential(ConvBN(32, 64, 3), ConvBN(64, 32, 1))
    stack.int8_edges = lambda: [("0", "1", False)]
    x = torch.randn(2, 32, 8, 8, generator=g)
    _quantized(stack, x)
    assert tq.link_int8(stack) == [("0", "1", False)]
    want = stack(x)
    handed = stack[0](x)
    assert isinstance(handed, Carried) and handed.value is None and handed.to is stack[1].conv.quant
    stack[1].train()
    assert torch.is_tensor(stack[0](x))
    stack.eval()
    assert torch.equal(stack(x), want)
    with pytest.raises(ValueError, match="residual is torch.float64"):
        stack[0](x, residual=torch.zeros(2, 64, 8, 8, dtype=torch.float64))


def _reciprocal_rule(v: np.ndarray, s: np.float32) -> tuple[np.ndarray, np.ndarray]:
    """csrc/int8_common.cuh's quantize in float32 numpy: t = v * rn(1 / s),
    rint(t) unless |t| < 128 lies within 2^-14 of a half-integer, where the
    division decides. -> (the integers, where the division decided)."""
    inv = np.float32(1) / s
    t = v * inv
    q = np.rint(t)
    near = (np.abs(t) < 128) & (np.abs(t - q) > np.float32(0.5 - 2.0 ** -14))
    q = np.where(near, np.rint(v / s), q)
    return np.clip(q, -127, 127).astype(np.int8), near


def test_reciprocal_quantize_rule_equals_the_division():
    """The kernels' quantize (a product with the correctly rounded
    reciprocal, the IEEE division near a half-integer) gives the integer
    of clip(rint(v / s)) on the values where the two roundings meet (at
    and around half-integer multiples of 24 scales) and on 2^21 random
    values and scales."""
    values, scales = quantize_tie_cases()
    rng = np.random.default_rng(5)
    rand_s = (10.0 ** rng.uniform(-4, 2, 64)).astype(np.float32)
    rand_v = (rng.standard_normal((64, 2 ** 15)) * rand_s[:, None]
              * rng.uniform(1, 150, (64, 1))).astype(np.float32)
    n_near = 0
    for vals, sc in [*zip(values, scales), *zip(rand_v, rand_s)]:
        got, near = _reciprocal_rule(vals, sc)
        want = ti.quantize_activation(torch.from_numpy(vals), torch.tensor(sc)).numpy()
        np.testing.assert_array_equal(got, want)
        n_near += int(near.sum())
    ties = values / scales[:, None]
    assert n_near > 0 and ((ties - np.floor(ties)) == 0.5).sum() > 1000
    t = values * (np.float32(1) / scales[:, None])
    assert (np.clip(np.rint(t), -127, 127) != np.clip(np.rint(ties), -127, 127)).any()


# ---------------------------------------------------------------- the stems' patches
def _im2col(xq: np.ndarray, k: int, stride: int, pad: int, k_pad: int) -> np.ndarray:
    b, h, w, c = xq.shape
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    xp = np.pad(xq, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    out = np.zeros((b, ho, wo, k_pad), np.int8)
    for oh in range(ho):
        for ow in range(wo):
            win = xp[:, oh * stride:oh * stride + k, ow * stride:ow * stride + k, :]
            out[:, oh, ow, :k * k * c] = win.reshape(b, -1)
    return out.reshape(b * ho * wo, k_pad)


@pytest.mark.parametrize("name,hw,k,stride,k_pad", [
    ("yolov3_vgg16_3x3", (13, 11), 3, 1, 32), ("resnet50_7x7_s2", (17, 14), 7, 2, 152)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_stem_patches_plain_equals_im2col(name, hw, k, stride, k_pad, dtype):
    g = torch.Generator().manual_seed(k)
    x = (torch.randn(2, *hw, 3, generator=g) * 2).to(dtype)
    s = torch.tensor(0.021)
    got = ti.quantize_patches_plain(x, s, k, stride, k // 2, k_pad)
    want = _im2col(ti.quantize_activation(x, s).numpy(), k, stride, k // 2, k_pad)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, :k * k * 3] != 0).any() and not want[:, k * k * 3:].any()
