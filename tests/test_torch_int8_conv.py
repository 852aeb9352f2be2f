"""The implicit-GEMM int8 conv's host side, on the CPU.

- `implicit_gemm_eligible`, the dispatch by shape, on the conv + BN pairs of
  the zoo: YOLOv3 (71 of 72: not the RGB stem), ResNet-50 (all but the
  stem), ResNeXt-50 32x4d (not the stem, not the 16 grouped convs) and
  Faster R-CNN-VGG16 (all but the first conv).
- `int8_conv_cuda` and `quantize_activation_cuda` refuse a CPU tensor, a
  wrong dtype, a non-contiguous input and a shape the kernel does not take,
  before anything is built.
- On eligible shapes the CPU route of `quantized_conv` (the plain version
  of the kernel's route) still matches the JAX package's
  ``_quantized_forward`` within test_torch_quantize.py's tolerance, and the
  kernel's plain version `int8_conv_plain` equals the JAX package's int32
  conv bit for bit.
"""
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import fastvision_tpu_torch.infer.quantize as tq
from fastvision_tpu.nn.layers import ConvBN as JaxConvBN
from fastvision_tpu_torch.models import FasterRCNN, YOLOv3
from fastvision_tpu_torch.models.classification.resnet import resnet50, resnext50_32x4d
from fastvision_tpu_torch.nn.layers import ConvBN, conv_bn_pairs
from fastvision_tpu_torch.ops import int8 as ti
from fastvision_tpu_torch.testing import INT8_IMPLICIT_CASES, int8_conv_case

tfr = importlib.import_module("fastvision_tpu_torch.models.detection.faster_rcnn")
torch.set_num_threads(2)


def _eligible(model) -> list[bool]:
    return [ti.implicit_gemm_eligible(c.in_channels, c.out_channels, c.kernel_size[0],
                                      c.stride[0], c.padding[0], c.groups)
            for _, c, _ in conv_bn_pairs(model)]


def _frcnn_vgg16():
    with pytest.MonkeyPatch.context() as mp:  # the 4096-wide head takes seconds to initialise
        mp.setattr(tfr, "FastHead", functools.partial(tfr.FastHead, hidden=64))
        return FasterRCNN(num_classes=20)


@pytest.mark.parametrize("name,make,pairs,not_eligible", [
    ("yolov3", lambda: YOLOv3(num_classes=80), 72, ["backbone.conv0.conv"]),
    ("resnet50", lambda: resnet50(num_classes=10), 53, ["conv1"]),
    ("resnext50_32x4d", lambda: resnext50_32x4d(num_classes=10), 53, 17),
    ("faster_rcnn_vgg16", _frcnn_vgg16, 13, ["backbone.conv0.conv"]),
], ids=lambda v: v if isinstance(v, str) else "")
def test_implicit_gemm_takes_all_but_the_stems_and_the_grouped_convs(name, make, pairs,
                                                                     not_eligible):
    model = make()
    names = [n for n, _, _ in conv_bn_pairs(model)]
    eligible = _eligible(model)
    assert len(eligible) == pairs
    left = [n for n, ok in zip(names, eligible) if not ok]
    if isinstance(not_eligible, int):  # ResNeXt: the stem and a grouped 3x3 in each block
        grouped = [n for n, c, _ in conv_bn_pairs(model) if c.groups > 1]
        assert len(left) == not_eligible and sorted(left) == sorted(["conv1", *grouped])
        assert len(grouped) == 16
    else:
        assert left == not_eligible


def test_eligibility_rules():
    ok = ti.implicit_gemm_eligible
    assert ok(32, 8, 3, 1, 1, 1) and ok(1024, 1024, 1, 2, 0, 1)
    assert not ok(3, 32, 3, 1, 1, 1)  # an RGB stem
    assert not ok(48, 32, 3, 1, 1, 1)  # C not a multiple of 32
    assert not ok(64, 12, 3, 1, 1, 1)  # N not a multiple of 8
    assert not ok(64, 64, 7, 2, 3, 1)  # ResNet's 7x7
    assert not ok(64, 64, 3, 1, 0, 1)  # padding other than k // 2
    assert not ok(64, 64, 3, 3, 1, 1)  # stride 3
    assert not ok(128, 128, 3, 1, 1, 32)  # grouped


@pytest.fixture
def no_build(monkeypatch):
    """Any build of a kernel library fails the test (with an AssertionError,
    which no ``pytest.raises`` below expects)."""
    def refuse(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(ti.cuda_build, "load", refuse)
    ti._conv_lib.cache_clear()
    ti._lib.cache_clear()


def test_int8_conv_cuda_refuses_before_any_build(no_build):
    xq = torch.zeros(1, 8, 8, 64, dtype=torch.int8)
    mat = torch.zeros(32, 9 * 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ti.int8_conv_cuda(xq, mat, 32, 3, 1)
    with pytest.raises(TypeError, match="int8"):
        ti.int8_conv_cuda(xq.float(), mat, 32, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ti.int8_conv_cuda(xq.permute(0, 2, 1, 3), mat, 32, 3, 1)
    with pytest.raises(ValueError, match="does not take"):
        ti.int8_conv_cuda(torch.zeros(1, 8, 8, 3, dtype=torch.int8), mat[:, :27].contiguous(), 32,
                          3, 1)
    with pytest.raises(ValueError, match="does not take"):
        ti.int8_conv_cuda(xq, mat, 32, 3, 3)
    with pytest.raises(ValueError, match="w_mat"):
        ti.int8_conv_cuda(xq, mat[:, :64].contiguous(), 32, 3, 1)
    one = torch.ones(32)
    with pytest.raises(ValueError, match="together"):
        ti.int8_conv_cuda(xq, mat, 32, 3, 1, scale=one)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ti.int8_conv_cuda(xq, mat, 32, 3, 1, one, one, "relu", torch.float16)
    with pytest.raises(ValueError, match="activation"):
        ti.int8_conv_cuda(xq, mat, 32, 3, 1, one, one, "gelu", torch.float32)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ti.quantize_activation_cuda(torch.zeros(1, 4, 4, 8), torch.tensor(1.0))


@pytest.mark.parametrize("case", INT8_IMPLICIT_CASES, ids=[c[0] for c in INT8_IMPLICIT_CASES])
def test_int8_conv_plain_equals_jax_int32_conv(case):
    """The kernel's plain version, from the kernel's own inputs (NHWC int8,
    `gemm_weight`'s matrix), bit-equal to the JAX package's int32 conv."""
    _, _, _, _, _, n, k, stride, _ = case
    x, w = int8_conv_case(case)
    got, q = ti.int8_conv_plain(torch.from_numpy(x.transpose(0, 2, 3, 1).copy()),
                                ti.gemm_weight(torch.from_numpy(w)), n, k, stride)
    assert q is None
    want = lax.conv_general_dilated(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w.transpose(2, 3, 1, 0)),
        (stride, stride), ((k // 2, k // 2),) * 2, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(-1, n))


@pytest.mark.parametrize("cin,features,k,stride,act", [
    (32, 64, 3, 1, "silu"), (64, 32, 1, 1, "leaky_relu"), (32, 64, 3, 2, "relu"),
    (64, 128, 1, 2, "none")])
@torch.no_grad()
def test_quantized_conv_cpu_route_matches_jax_on_eligible_shapes(cin, features, k, stride, act):
    g = torch.Generator().manual_seed(cin + features + k + stride)
    m = ConvBN(cin, features, k, strides=stride, act=act)
    m.bn.weight.copy_(torch.rand(features, generator=g) * 1.5 + 0.5)
    m.bn.bias.copy_(torch.randn(features, generator=g) * 0.3)
    m.bn.running_mean.copy_(torch.randn(features, generator=g) * 0.2)
    m.bn.running_var.copy_(torch.rand(features, generator=g) * 1.2 + 0.3)
    x = torch.randn(2, cin, 16, 16, generator=g)
    m.eval()
    assert ti.implicit_gemm_eligible(cin, features, k, stride, k // 2, 1)
    tq.quantize_model(m, [x])
    out = m(x)
    jm = JaxConvBN(features, kernel_size=k, strides=stride, act=act)
    sd = {k_: v.numpy() for k_, v in m.state_dict().items()}
    q = tq.quant_state(m)["conv"]
    jv = {"params": {"conv": {"kernel": sd["conv.weight"].transpose(2, 3, 1, 0)},
                     "bn": {"bn": {"scale": sd["bn.weight"], "bias": sd["bn.bias"]}}},
          "batch_stats": {"bn": {"bn": {"mean": sd["bn.running_mean"],
                                        "var": sd["bn.running_var"]}}},
          "quant": {"w_q": q["w_q"].numpy().transpose(2, 3, 1, 0),
                    "w_scale": q["w_scale"].numpy(), "in_scale": q["in_scale"].numpy(),
                    "bias": q["bias"].numpy()}}
    want = np.asarray(jm.apply(jv, jnp.asarray(x.permute(0, 2, 3, 1).numpy()), train=False))
    assert out.shape == (2, features, 16 // stride, 16 // stride)
    assert np.abs(out.permute(0, 2, 3, 1).numpy() - want).max() <= 1e-5 * np.abs(want).max()
