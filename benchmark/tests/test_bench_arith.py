"""The benchmark's arithmetic: FLOP counts, the device trace's intervals
and attribution, the weights and inputs from the seed, the comparison."""
import math

import numpy as np
import pytest
import torch

from harness.compare import judge, train_readings
from harness.flops import peak, step_flops
from harness.trace import WINDOW, Trace
from harness.traffic import train_pool
from harness.weights import make_weights
from reference import build

YOLO = {"model": "yolov3", "num_classes": 80, "input_size": 416, "stage_sizes": [1, 2, 8, 8, 4],
        "channels": [1024, 512, 256], "act": "silu", "anchors": [[[1, 1]] * 3] * 3}
RESNET = {"model": "resnet50", "num_classes": 1000, "input_size": 224,
          "stage_sizes": [3, 4, 6, 3]}


def conv_linear_flops(cfg, batch):
    """2 x multiply-adds of every conv and linear layer of one forward, from
    the layer shapes (forward hooks), independently of FlopCounterMode."""
    total = 0
    model = build(cfg).eval()

    def conv(m, _, out):
        nonlocal total
        total += 2 * math.prod(m.kernel_size) * m.in_channels // m.groups * out.numel()

    def linear(m, _, out):
        nonlocal total
        total += 2 * m.in_features * out.numel()

    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(conv)
        elif isinstance(m, torch.nn.Linear):
            m.register_forward_hook(linear)
    with torch.device("meta"):
        model = model.to("meta")
        with torch.no_grad():
            model(torch.zeros(batch, cfg["input_size"], cfg["input_size"], 3, dtype=torch.uint8))
    return total


@pytest.mark.parametrize("cfg,fwd_gflop", [(YOLO, 65.9), (RESNET, 8.2)])
def test_step_flops(cfg, fwd_gflop):
    fwd = step_flops(cfg, 2, train=False)
    assert fwd["conv"] == pytest.approx(conv_linear_flops(cfg, 2)
                                        - (2 * 2048 * 1000 * 2 if cfg is RESNET else 0))
    assert fwd["total"] / 2 / 1e9 == pytest.approx(fwd_gflop, rel=0.03)
    train = step_flops(cfg, 2, train=True)
    # backward: input and weight gradients of every conv but the stem's input
    assert 2.9 * fwd["conv"] < train["conv"] < 3.0 * fwd["conv"]


def test_peak_table():
    assert peak("bfloat16", "NVIDIA H100 80GB HBM3") == 989e12
    assert peak("bfloat16", "cpu") is None


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_trace_union_idle_and_attribution():
    ev = [
        _x(WINDOW, "user_annotation", 0, 100),
        _x("aten::convolution", "cpu_op", 6, 9),
        _x("aten::cudnn_convolution", "cpu_op", 6.5, 8),
        _x("cudaLaunchKernel", "cuda_runtime", 7, 1, correlation=1),
        _x("Optimizer.step#SGD.step", "user_annotation", 40, 20),
        _x("cudaLaunchKernel", "cuda_runtime", 45, 1, correlation=2),
        _x("aten::relu", "cpu_op", 70, 5, tid=2),
        _x("cudaLaunchKernel", "cuda_runtime", 71, 1, tid=2, correlation=3),
        _x("conv_kernel", "kernel", 10, 20, tid=7, correlation=1),
        _x("sgd_kernel", "kernel", 25, 10, tid=7, correlation=2),
        _x("relu_kernel", "kernel", 80, 30, tid=7, correlation=3),  # runs past the window
        {"ph": "X", "name": "gpu range", "cat": "gpu_user_annotation", "ts": 0, "dur": 100},
    ]
    t = Trace(ev)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((25 + 20) * 1e-6)  # [10, 35) and [80, 100)
    conv = t.under(["aten::convolution"], (), ())
    assert [o.name for o in conv] == ["conv_kernel"]
    assert [o.name for o in t.under((), ("Optimizer.step#",), ())] == ["sgd_kernel"]
    assert [o.name for o in t.under((), (), ["^relu"])] == ["relu_kernel"]
    gaps = dict(t.idle_gaps())
    # gaps [0, 10), [35, 80): by what the main thread was in at their middles
    assert gaps == pytest.approx({"(python)": 10e-6, "Optimizer.step#SGD.step": 45e-6})
    assert t.top_ops(1) == [["relu_kernel", pytest.approx(30e-6)]]


def test_trace_of_the_card_alone_spans_its_work():
    ev = [_x("cudaLaunchKernel", "cuda_runtime", 2, 1, correlation=1),
          _x("k1", "kernel", 10, 20, tid=7, correlation=1),
          _x("k2", "kernel", 25, 10, tid=7),
          _x("k3", "kernel", 50, 10, tid=7)]
    t = Trace(ev)
    assert t.window_s == pytest.approx(50e-6)  # [10, 60): no host range to bound it
    assert t.busy_s == pytest.approx(35e-6)  # [10, 35) and [50, 60)
    with pytest.raises(RuntimeError):
        Trace([_x("cudaLaunchKernel", "cuda_runtime", 2, 1, correlation=1)])


def test_weights_and_pool_follow_the_seed():
    cfg = {**RESNET, "input_size": 32, "stage_sizes": [1, 1, 1, 1]}
    with torch.device("meta"):
        shapes = build(cfg)
    a = make_weights(shapes, 2**31 + 7, torch.device("cpu"))
    b = make_weights(shapes, 2**31 + 7, torch.device("cpu"))
    c = make_weights(shapes, 2**31 + 8, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
    assert torch.equal(a["bn1.weight"], torch.ones(64)) and torch.equal(a["bn1.running_var"],
                                                                         torch.ones(64))
    w = a["layer1.0.conv2.weight"]  # kaiming fan_out: std sqrt(2 / (64 * 9))
    assert float(w.std()) == pytest.approx(math.sqrt(2 / 576), rel=0.1)
    traffic = {"labels": "classes", "batch": 2, "pool": 2, "rects": 3, "side": {"min": 0.1, "max": 0.5}}
    p, q = (train_pool(cfg, traffic, 5, torch.device("cpu")) for _ in range(2))
    assert all(np.array_equal(x["images"], y["images"]) for x, y in zip(p, q))
    ycfg = {**YOLO, "input_size": 64, "max_boxes": 120}
    boxes = {"count": {"median": 5.3, "sigma": 0.9, "max": 120}, "side": {"min": 0.02, "max": 0.8}}
    pool = train_pool(ycfg, {"labels": "boxes", "batch": 4, "pool": 2, "boxes": boxes}, 9, torch.device("cpu"))
    labels = pool[0]["labels"]
    assert labels.shape == (4, 120, 5)
    real = labels[labels[..., 0] >= 0]
    assert np.all((real[:, 1:3] - real[:, 3:5] / 2 >= 0) & (real[:, 1:3] + real[:, 3:5] / 2 <= 1))


def _steps(loss, grad, delta):
    return {"loss": loss, "out": [torch.ones(4)], "grad": grad, "grad_raw": grad,
            "delta": delta}


def test_readings_and_judge():
    ref = _steps([2.0, 1.0], {"a": 1.0, "b": 2.0, "c": 4.0, "z": 1e-6},
                 {"a": 1.0, "b": 2.0, "c": 4.0, "z": 1e-6})
    prog = _steps([2.2, 1.0], {"a": 1.1, "b": 2.0, "c": 4.0, "z": 5.0},
                  {"a": 1.0, "b": 1.0, "c": 4.0, "z": 0.0})
    r = train_readings(prog, ref)
    # 'z' moves by round-off alone (under a thousandth of the median leaf's gradient)
    assert r["leaves"] == 3 and r["leaves_left_out"] == 1
    assert r["loss_gap"] == pytest.approx(0.1) and r["loss1_gap"] == pytest.approx(0.1)
    assert r["grad_gap"] == pytest.approx(0.05)  # 0.1 over the median leaf's 2.0
    assert r["delta_gap"] == pytest.approx(0.5) and r["delta_leaf"] == "b"
    assert r["grad_median_gap"] == 0.0 and r["out_gap"] == 0.0
    ok, check = judge(r, {"loss_gap": 0.2, "delta_median_gap": 0.1})
    assert ok and check["loss_gap"] == {"value": r["loss_gap"], "limit": 0.2}
    assert not judge({**r, "loss_gap": math.nan}, {"loss_gap": 0.2})[0]
    half = {**prog, "out": [torch.ones(2)]}
    assert train_readings(half, ref)["out_gap"] == math.inf
