"""The port's program export (fastvision_tpu_torch/infer/export.py and the
CLI's ``export``) against the JAX package's (``export_stablehlo`` /
``load_stablehlo``, ``cli.py::cmd_export``), on the CPU.

- A tiny ConvBN model, float and int8 (the JAX package's ``Tiny`` of
  tests/test_export.py, weights and int8 state carried across): the port's
  ``export_program`` -> ``load_program`` in a fresh process against JAX's
  ``export_stablehlo`` -> ``load_stablehlo``, within 1e-5 of the output's
  std, and bit-equal to the port's eager forward.
- A small YOLOv3 Detector (4 classes, 64 px), float and int8 (JAX's int8
  state carried across): the loaded program bit-equal to the port's eager
  ``Detector.infer`` and, as the parity tests hold detections
  (`test_torch_quantize.same_results`: classes equal, boxes within 1e-2
  px, scores 1e-4), equal to the JAX detector program exported with
  ``export_stablehlo``. On the CPU the program runs the plain NMS, traced,
  and holds no ``fastvision::*`` op.
- ``export`` through ``cli.main``: the detector (``--stablehlo``, and
  ``--int8`` with an ``--out`` ending in ``.pt2``), ``--task cls``
  (resnet18, 4 classes, 32 px, as tests/test_export.py's CLI case, its
  probabilities against the JAX program's) and ``--task video`` (a small
  SlowFast), each loaded in a fresh process and bit-equal to the eager
  model; the formats the port has no route to exit naming why.
- Each custom op's fake (``fastvision::nms_suppression_mask``,
  ``int8_patches``, ``int8_epilogue``, ``int8_conv`` in every mode) gives,
  under ``FakeTensorMode`` on CUDA fake tensors, the shapes and types the
  plain versions return.
"""
import argparse
import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode

import fastvision_tpu.infer.quantize as jq
import fastvision_tpu_torch.cli as cli
from fastvision_tpu.data import normalize_images as jax_normalize_images
from fastvision_tpu.infer import Detector as JaxDetector
from fastvision_tpu.infer.export import export_stablehlo, load_stablehlo
from fastvision_tpu.models import classification as jz
from fastvision_tpu.nn.layers import ConvBN as JaxConvBN
from fastvision_tpu_torch.data import DetectionDataset
from fastvision_tpu_torch.infer import (
    Detector,
    detector_program,
    export_program,
    load_exported,
    op_counts,
)
from fastvision_tpu_torch.infer.quantize import install_quant
from fastvision_tpu_torch.models import import_jax, quant_state_from_jax
from fastvision_tpu_torch.models import classification as tz
from fastvision_tpu_torch.models.video import SlowFast
from fastvision_tpu_torch.nn.layers import ConvBN
from fastvision_tpu_torch.ops import int8 as ti
from fastvision_tpu_torch.ops import nms_kernel
from fastvision_tpu_torch.ops.nms import suppression_mask
from fastvision_tpu_torch.testing import write_detection_dataset
from test_torch_quantize import ANCHORS, SIZE, _random_variables, _yolo_pair, same_results

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASSES = 4


def run_fresh(path: str, inputs: list[np.ndarray], tmp_path) -> dict[str, np.ndarray]:
    """`load_program(path)` in a new Python process, called on ``inputs``
    -> its outputs as numpy ({"out": ...} for a single tensor)."""
    src, dst = str(tmp_path / "inputs.npz"), str(tmp_path / "outputs.npz")
    np.savez(src, *inputs)
    code = (
        "import sys, numpy as np, torch\n"
        "from fastvision_tpu_torch.infer import load_program\n"
        "a = np.load(sys.argv[2])\n"
        "with torch.no_grad():\n"
        "    out = load_program(sys.argv[1])(*(torch.from_numpy(a[f'arr_{i}'])"
        " for i in range(len(a.files))))\n"
        "out = out if isinstance(out, dict) else {'out': out}\n"
        "np.savez(sys.argv[3], **{k: v.numpy() for k, v in out.items()})\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    subprocess.run([sys.executable, "-c", code, path, src, dst], check=True, env=env,
                   timeout=600)
    with np.load(dst) as f:
        return {k: f[k] for k in f.files}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / b.std())


# ---------------------------------------------------------------- a tiny ConvBN model
class JaxTiny(fnn.Module):
    """tests/test_export.py's ``Tiny``."""

    @fnn.compact
    def __call__(self, x, train=False):
        x = JaxConvBN(8, 3, act="silu", dtype=jnp.float32)(x, train)
        x = JaxConvBN(16, 3, strides=2, act="silu", dtype=jnp.float32)(x, train)
        return x.mean(axis=(1, 2))


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.body = nn.Sequential(ConvBN(3, 8, 3, act="silu"),
                                  ConvBN(8, 16, 3, strides=2, act="silu"))

    def forward(self, x):  # NHWC in, as the JAX model takes it
        return self.body(x.permute(0, 3, 1, 2)).mean(dim=(2, 3))


def tiny_state_dict_from_jax(variables):
    out = {}
    for i in range(2):
        name = f"ConvBN_{i}"
        import_jax._convbn(out, f"body.{i}", variables["params"][name],
                           variables.get("batch_stats", {}).get(name, {}))
    return out


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_tiny_program_matches_jax_stablehlo(tmp_path, quantized):
    rng = np.random.default_rng(5)
    example = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    x = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)  # not the example
    jm = JaxTiny()
    v = _random_variables(jm, 7, jnp.zeros((1, 16, 16, 3)), train=False)
    tm = Tiny()
    tm.load_state_dict(tiny_state_dict_from_jax(v), strict=True)
    tm.eval()
    if quantized:
        v = jq.quantize_model(jm, v, [jnp.asarray(example)])
        assert install_quant(tm, quant_state_from_jax(v, tiny_state_dict_from_jax)) == 2

    def infer(variables, images):
        return jm.apply(variables, images, train=False)

    want = np.asarray(load_stablehlo(export_stablehlo(
        infer, v, [example], str(tmp_path / "tiny.stablehlo")))(x))
    path = export_program(tm, [torch.from_numpy(example)], str(tmp_path / "tiny.pt2"))
    got = run_fresh(path, [x], tmp_path)["out"]
    with torch.no_grad():
        eager = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, eager)
    assert got.shape == want.shape == (2, 16)
    assert _rel(got, want) <= 1e-5
    if quantized:  # the int8 path ran, in the program too
        with torch.no_grad():
            flt = copy.deepcopy(tm)
            for m in flt.modules():
                m._modules.pop("quant", None)
            assert _rel(got, flt(torch.from_numpy(x)).numpy()) > 1e-5


# ---------------------------------------------------------------- the detector program
@pytest.fixture(scope="module")
def yolo():
    """(JAX YOLOv3, variables, the port's YOLOv3 with the same weights,
    bridge, JAX's calibration tree): test_torch_quantize's small pair."""
    jm, tm, bridge = _yolo_pair()
    v = _random_variables(jm, 20, jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    tm.load_state_dict(bridge(v), strict=True)
    tm.eval()
    x = np.random.default_rng(10).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    return jm, v, tm, bridge, jq.calibrate(jm, v, [jnp.asarray(x)])


def _results(det: dict) -> list[dict]:
    """A program's padded outputs -> per-image {boxes, scores, classes} of
    the valid entries."""
    det = {k: np.asarray(v) for k, v in det.items()}
    return [{k: det[k][i][det["valid"][i]] for k in ("boxes", "scores", "classes")}
            for i in range(len(det["valid"]))]


def _images(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_detector_program_matches_eager_and_jax(yolo, tmp_path, quantized):
    jm, v, tm, bridge, calib = yolo
    model = copy.deepcopy(tm)
    if quantized:
        v = jq.quantize_variables(v, calib)
        install_quant(model, quant_state_from_jax(v, bridge))
    kw = dict(input_size=SIZE, batch_size=2, conf_thres=0.05, max_det=20)
    det = Detector(model, ANCHORS, device="cpu", dtype=torch.float32, **kw)
    example = torch.zeros((2, SIZE, SIZE, 3), dtype=torch.uint8)
    path = export_program(detector_program(det), [example], str(tmp_path / "det.pt2"))
    counts = op_counts(load_exported(path))
    assert not [op for op in counts if op.startswith("fastvision.")]  # the CPU: plain versions
    images = _images(2, 11)
    got = run_fresh(path, [images], tmp_path)
    want = det.infer(torch.from_numpy(images))._asdict()
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        assert got[k].dtype == t.numpy().dtype
        np.testing.assert_array_equal(got[k], t.numpy(), err_msg=k)

    jdet = JaxDetector(jm, v, ANCHORS, dtype=jnp.float32, **kw)

    def jax_infer(variables, images_u8):  # the JAX CLI's export program
        d = jdet._infer(variables, jnp.asarray(images_u8))
        return {"boxes": d.boxes, "scores": d.scores, "classes": d.classes, "valid": d.valid}

    jpath = export_stablehlo(jax_infer, jdet.variables, [np.zeros((2, SIZE, SIZE, 3), np.uint8)],
                             str(tmp_path / "det.stablehlo"))
    same_results(_results(got), _results(load_stablehlo(jpath)(images)))


# ---------------------------------------------------------------- the CLI
def _cli_yolo(cfg):
    """`cli._build_yolo` at a small size (4 classes, shallow Darknet)."""
    return tz_yolo(cfg.model.num_classes, cfg.train.seed)


def tz_yolo(num_classes: int, seed: int):
    from fastvision_tpu_torch.models import YOLOv3

    return YOLOv3(num_classes=num_classes, channels=(128, 64, 32), stage_sizes=(1, 1, 1, 1, 1),
                  generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_detection_dataset(str(tmp_path_factory.mktemp("export")), 8,
                                   sizes=((64, 64), (48, 64), (64, 40)), seed=3,
                                   num_classes=NUM_CLASSES)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_cli_export_detector_loads_in_a_fresh_process(root, tmp_path, monkeypatch, capsys, int8):
    monkeypatch.setattr(cli, "_build_yolo", _cli_yolo)
    overrides = [f"data.data_root={root}", f"model.num_classes={NUM_CLASSES}",
                 f"data.input_size={SIZE}", "train.bf16=false", "nms.max_det=20",
                 "nms.conf_thres=0.05"]
    # the format from --stablehlo, or from the .pt2 suffix alone
    argv = ["--int8", "--out", str(tmp_path / "det.pt2")] if int8 else \
        ["--stablehlo", "--out", str(tmp_path / "det.program")]
    path = cli.main(["export", "--batch", "2", "--device", "cpu", *argv, *overrides])
    assert path == argv[-1] and "torch.export program (batch 2, 64px" in capsys.readouterr().out
    det = cli._detector_from_cfg(cli._load_config(argparse.Namespace(config=""), overrides), "",
                                 "cpu")
    if int8:
        cli._quantize_detector(det, DetectionDataset(root, "val"))
    images = _images(2, 12)
    got = run_fresh(path, [images], tmp_path)
    want = det.infer(torch.from_numpy(images))._asdict()
    for k, t in want.items():
        np.testing.assert_array_equal(got[k], t.numpy(), err_msg=k)
    assert want["valid"].any()


def test_cli_export_task_cls_matches_jax(tmp_path, monkeypatch):
    """tests/test_export.py's ``test_cli_export_task_cls_roundtrip`` in the
    port: resnet18, 4 classes, 32 px, float32, batch 2; the probabilities of
    the program loaded in a fresh process against the JAX program with the
    same weights."""
    jm = jz.resnet18(num_classes=NUM_CLASSES, dtype=jnp.float32)
    v = _random_variables(jm, 3, jnp.zeros((1, 32, 32, 3)), train=False)
    tm = tz.resnet18(num_classes=NUM_CLASSES)
    tm.load_state_dict(import_jax.resnet_state_dict_from_jax(v), strict=True)
    monkeypatch.setattr(cli, "_build_zoo_model", lambda cfg, task="cls": copy.deepcopy(tm))
    out = str(tmp_path / "cls.pt2")
    cli.main(["export", "--task", "cls", "--out", out, "--batch", "2", "--device", "cpu",
              "model.backbone=resnet18", f"model.num_classes={NUM_CLASSES}",
              "data.input_size=32", "train.bf16=false"])
    x = np.random.default_rng(13).integers(0, 255, (2, 32, 32, 3)).astype(np.uint8)
    got = run_fresh(out, [x], tmp_path)["probs"]
    assert got.shape == (2, NUM_CLASSES) and got.dtype == np.float32
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    from fastvision_tpu_torch.infer import classifier_program

    eager = tm.to(memory_format=torch.channels_last).eval()  # as the CLI places it
    want_port = classifier_program(eager, torch.float32)(torch.from_numpy(x))["probs"]
    np.testing.assert_array_equal(got, want_port.numpy())
    logits = jm.apply(v, jax_normalize_images(jnp.asarray(x), jnp.float32, imagenet=True),
                      train=False)
    want = np.asarray(jax.nn.softmax(logits.astype(jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_cli_export_task_video_loads_in_a_fresh_process(tmp_path, monkeypatch):
    def small(cfg, task="video"):
        assert task == "video"
        return SlowFast((1, 1, 1, 1), num_classes=cfg.model.num_classes, alpha=4, beta_inv=4,
                        expansion=1, generator=torch.Generator().manual_seed(cfg.train.seed))

    monkeypatch.setattr(cli, "_build_zoo_model", small)
    out = str(tmp_path / "video.pt2")
    cli.main(["export", "--task", "video", "--out", out, "--batch", "2", "--device", "cpu",
              "model.backbone=slowfast_resnet18", f"model.num_classes={NUM_CLASSES}",
              "data.input_size=32", "data.num_frames=8", "train.bf16=false"])
    clips = np.random.default_rng(14).integers(0, 255, (2, 8, 32, 32, 3)).astype(np.uint8)
    got = run_fresh(out, [clips], tmp_path)["probs"]
    from fastvision_tpu_torch.infer import classifier_program
    from fastvision_tpu_torch.nn.layers import memory_format_for

    model = small(cli._load_config(argparse.Namespace(config=""), [
        f"model.num_classes={NUM_CLASSES}"]))
    model = model.to(memory_format=memory_format_for(model)).eval()
    want = classifier_program(model, torch.float32)(torch.from_numpy(clips))["probs"]
    assert got.shape == (2, NUM_CLASSES)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("argv,why", [
    (["--out", "sm/"], "SavedModel through jax2tf"),
    (["--tflite", "--out", "m.tflite"], "TFLite through jax2tf"),
    (["--out", "m.tflite"], "TFLite through jax2tf"),
    (["--tflite", "--stablehlo", "--out", "m"], "mutually exclusive"),
    (["--out", "m.tflite", "--stablehlo"], "mutually exclusive"),
    (["--int8", "--task", "cls", "--out", "m.pt2"], "detector-only"),
    (["--int8", "--task", "video", "--out", "m.pt2"], "detector-only"),
], ids=["savedmodel", "tflite", "tflite_suffix", "conflict", "conflict_suffix", "int8_cls",
        "int8_video"])
def test_cli_export_refuses_with_its_reason(argv, why):
    with pytest.raises(SystemExit, match=why):
        cli.main(["export", "--device", "cpu", *argv])


# ---------------------------------------------------------------- the custom ops' fakes
def _int8_conv_modes():
    """(mode, int8_conv_plain keyword arguments) for every mode of the kernel."""
    g = torch.Generator().manual_seed(0)
    n = 32
    scale, bias = torch.rand(n, generator=g) * 1e-3, torch.randn(n, generator=g)
    res = torch.randn(2 * 8 * 8, n, generator=g).to(torch.bfloat16)
    half = torch.tensor(0.05)
    a = dict(scale=scale, bias=bias, act="silu", dtype=torch.bfloat16)
    return [("b_accumulators", {}), ("a_float", a), ("a_float32", {**a, "dtype": torch.float32}),
            ("a_residual", {**a, "residual": res}), ("a_float_and_int8", {**a, "out_scale": half}),
            ("a_int8_only", {**a, "out_scale": half, "keep_float": False}),
            ("a_residual_int8_only", {**a, "residual": res, "out_scale": half,
                                      "keep_float": False})]


def _fake_cuda(t):
    """A fake CUDA tensor of ``t``'s shape, strides and type (inside a
    ``FakeTensorMode``)."""
    return None if t is None else torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                                      device="cuda")


def _same_meta(fake, real):
    if real is None:
        assert fake is None
    else:
        assert fake.device.type == "cuda" and tuple(fake.shape) == tuple(real.shape)
        assert fake.dtype == real.dtype


@pytest.mark.parametrize("mode,kw", _int8_conv_modes(), ids=[m for m, _ in _int8_conv_modes()])
def test_int8_conv_fake_matches_plain(mode, kw):
    g = torch.Generator().manual_seed(1)
    xq = torch.randint(-127, 128, (2, 8, 8, 64), generator=g, dtype=torch.int8)
    mat = torch.randint(-127, 128, (32, 9 * 64), generator=g, dtype=torch.int8)
    want = ti.int8_conv_plain(xq, mat, 32, 3, 1, **kw)
    with FakeTensorMode():
        fkw = {k: _fake_cuda(v) if isinstance(v, torch.Tensor) else v
               for k, v in kw.items()}
        got = ti.int8_conv_cuda(_fake_cuda(xq), _fake_cuda(mat), 32, 3, 1, **fkw)
        raw = torch.ops.fastvision.int8_conv(
            _fake_cuda(xq), _fake_cuda(mat), 32, 3, 1, fkw.get("scale"),
            fkw.get("bias"), kw.get("act", "none"), kw.get("dtype", torch.bfloat16),
            fkw.get("residual"), fkw.get("out_scale"), kw.get("keep_float", True))
    for f, w, r in zip(got, want, raw):
        _same_meta(f, w)
        assert r.numel() == (0 if w is None else w.numel())  # a missing output: empty


@pytest.mark.parametrize("case", ["quantize_pass_f32", "quantize_pass_bf16", "patches_3x3_float",
                                  "patches_stem", "patches_int8"])
def test_int8_patches_and_epilogue_fakes_match_plain(case):
    g = torch.Generator().manual_seed(2)
    s = torch.tensor(0.02)
    x = torch.randn(2, 9, 7, 3 if case == "patches_stem" else 16, generator=g) * 3
    if case.startswith("quantize_pass"):
        x = x.to(torch.bfloat16) if case.endswith("bf16") else x
        want = ti.quantize_activation(x, s)
    else:
        k, stride, k_pad = (3, 2, 32) if case == "patches_stem" else (3, 1, 144)
        x, s = (ti.quantize_activation(x, s), None) if case == "patches_int8" else (x, s)
        want = ti.quantize_patches_plain(x, s, k, stride, 1, k_pad)
    acc = torch.randint(-2 ** 20, 2 ** 20, (126, 24), generator=g, dtype=torch.int32)
    sc, bias = torch.rand(20, generator=g) * 1e-4, torch.randn(20, generator=g)
    epilogues = {dtype: ti.epilogue_plain(acc, 20, sc, bias, "leaky_relu", dtype)
                 for dtype in (torch.float32, torch.bfloat16)}
    with FakeTensorMode():
        if case.startswith("quantize_pass"):
            got = ti.quantize_activation_cuda(_fake_cuda(x), _fake_cuda(s))
        else:
            got = ti.quantize_patches_cuda(_fake_cuda(x), _fake_cuda(s), k, stride, 1, k_pad)
        _same_meta(got, want)
        for dtype, w in epilogues.items():
            _same_meta(ti.epilogue_cuda(_fake_cuda(acc), 20, _fake_cuda(sc), _fake_cuda(bias),
                                        "leaky_relu", dtype), w)


@pytest.mark.parametrize("b,k", [(1, 37), (8, 1024)])
def test_nms_fake_matches_plain(b, k):
    g = torch.Generator().manual_seed(3)
    xy = torch.rand(b, k, 2, generator=g) * 400
    boxes = torch.cat([xy, xy + 1 + torch.rand(b, k, 2, generator=g) * 60], dim=-1)
    scores = torch.sort(torch.rand(b, k, generator=g), descending=True)[0]
    want = nms_kernel.suppression_mask_plain(boxes, scores, 0.45)
    with FakeTensorMode():
        fb, fs = _fake_cuda(boxes), _fake_cuda(scores)
        _same_meta(torch.ops.fastvision.nms_suppression_mask(fb, fs, 0.45), want)
        _same_meta(suppression_mask(fb, fs, 0.45), want)  # the dispatcher takes the op
