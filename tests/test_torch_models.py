"""Port models vs the JAX package: ConvBN, Darknet-53 and YOLOv3 with the same
(bridged) weights give the same outputs in float32 on the CPU.

Tolerance: max|port - jax| / std(jax) <= 1e-4 per output. The two
frameworks run different conv algorithms (oneDNN vs XLA), whose float32
sums differ in order; scaling by the output's std keeps a layout bug (a
wrong transpose, a shifted pad) from hiding under a bare atol.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvision_tpu.models.classification.darknet53 import Darknet53 as JaxDarknet53
from fastvision_tpu.models.detection import YOLOv3 as JaxYOLOv3
from fastvision_tpu.models.import_torch import apply_import, yolov3_from_torch
from fastvision_tpu.nn.layers import ConvBN as JaxConvBN
from fastvision_tpu_torch.models import Darknet53, YOLOv3, yolov3_state_dict_from_jax
from fastvision_tpu_torch.models.import_jax import _convbn, darknet53_state_dict_from_jax
from fastvision_tpu_torch.nn import ConvBN

torch.set_num_threads(2)
REL_TOL = 1e-4


class _ShallowJaxDarknet(JaxDarknet53):
    stage_sizes = (1, 1, 1, 1, 1)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / want.std())


def _randomize_bn(variables, seed):
    """BN scale/shift/statistics drawn away from the identity, so a BN
    mapped to the wrong place or left out shows in the outputs."""
    rng = np.random.default_rng(seed)
    draw = {
        "scale": lambda s: rng.uniform(0.5, 1.5, s),
        "bias": lambda s: rng.normal(0, 0.1, s),
        "mean": lambda s: rng.normal(0, 0.1, s),
        "var": lambda s: rng.uniform(0.5, 1.5, s),
    }

    def leaf(path, x):
        names = [getattr(p, "key", None) for p in path]
        if "bn" in names and names[-1] in draw:
            return np.asarray(draw[names[-1]](x.shape), np.float32)
        return np.asarray(x)

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def _jax_yolov3(num_classes, shallow):
    if shallow:
        return JaxYOLOv3(num_classes=num_classes,
                         backbone_fn=lambda **kw: _ShallowJaxDarknet(including_top=False, **kw))
    return JaxYOLOv3(num_classes=num_classes)


@pytest.mark.parametrize("act", ["silu", "relu", "leaky_relu", "none"])
@pytest.mark.parametrize("kernel_size,strides", [(1, 1), (3, 1), (3, 2)])
def test_convbn_matches_jax(kernel_size, strides, act):
    rng = np.random.default_rng(kernel_size * 10 + strides)
    x = rng.normal(0, 1, (2, 9, 11, 5)).astype(np.float32)
    jm = JaxConvBN(7, kernel_size, strides, act=act)
    variables = _randomize_bn(jm.init(jax.random.key(0), jnp.asarray(x)), 1)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))

    tm = ConvBN(5, 7, kernel_size, strides, act=act)
    sd = {}
    _convbn(sd, "m", variables["params"], variables["batch_stats"])
    tm.load_state_dict({k[2:]: v for k, v in sd.items()})
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert _rel_err(got, want) <= REL_TOL


def test_shallow_darknet53_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jm = _ShallowJaxDarknet(including_top=False)
    variables = _randomize_bn(jm.init(jax.random.key(1), jnp.asarray(x)), 2)
    want = jm.apply(variables, jnp.asarray(x), train=False)
    tm = Darknet53(stage_sizes=(1, 1, 1, 1, 1))
    tm.load_state_dict(darknet53_state_dict_from_jax(variables))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 3
    for g, w in zip(got, want):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape
        assert _rel_err(g, w) <= REL_TOL


@pytest.mark.parametrize("shallow", [True, False], ids=["shallow", "full_depth"])
def test_yolov3_heads_match_jax(shallow):
    """Per-level heads [B, H, W, A, 5+C] at 64x64, bs 2, 4 classes; the full
    depth case is Darknet-53's full (1, 2, 8, 8, 4) at full widths."""
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jm = _jax_yolov3(4, shallow)
    variables = _randomize_bn(jm.init(jax.random.key(2), jnp.asarray(x)), 5)
    want = jm.apply(variables, jnp.asarray(x), train=False)

    tm = YOLOv3(num_classes=4, stage_sizes=(1, 1, 1, 1, 1) if shallow else (1, 2, 8, 8, 4))
    tm.load_state_dict(yolov3_state_dict_from_jax(variables))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert _rel_err(g.numpy(), w) <= REL_TOL

    if not shallow:
        # the bridge is the exact inverse of the JAX package's torch importer
        torch_sd = {k: v.numpy() for k, v in tm.state_dict().items()}
        want_vars = {c: variables[c] for c in ("params", "batch_stats")}
        zeros = jax.tree_util.tree_map(np.zeros_like, want_vars)
        back = apply_import(zeros, yolov3_from_torch(torch_sd), verbose=False)
        flat_back = jax.tree_util.tree_leaves_with_path(back)
        flat_want = dict(jax.tree_util.tree_leaves_with_path(want_vars))
        assert len(flat_back) == len(flat_want)
        for path, leaf in flat_back:
            np.testing.assert_array_equal(np.asarray(leaf), flat_want[path],
                                          err_msg=jax.tree_util.keystr(path))


def test_channels_last_forward_matches_contiguous():
    """The Detector runs the model in channels_last memory; outputs must not
    depend on the memory format."""
    g = torch.Generator().manual_seed(0)
    tm = YOLOv3(num_classes=3, stage_sizes=(1, 1, 1, 1, 1), generator=g).eval()
    x = torch.rand(1, 64, 64, 3, generator=g)
    with torch.no_grad():
        want = tm(x)
        got = tm.to(memory_format=torch.channels_last)(x)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_seeded_init_is_reproducible():
    a = YOLOv3(num_classes=3, stage_sizes=(1, 1, 1, 1, 1),
               generator=torch.Generator().manual_seed(11)).state_dict()
    b = YOLOv3(num_classes=3, stage_sizes=(1, 1, 1, 1, 1),
               generator=torch.Generator().manual_seed(11)).state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
