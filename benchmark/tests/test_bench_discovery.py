"""A cell, a traffic mix, a metric or a kernel-name file is found by its
name: adding one is adding files, with no edit to the harness."""
import json
import os
import shutil

import pytest

from harness.cells import BENCH_DIR, ROOT, by_model, kernel_group, load_cell, read_metric
from harness.readers import RunInfo


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    return root


def test_throwaway_cell_found_by_name(tmp_path):
    root = _copy(tmp_path)
    bench = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    traffic = json.loads((bench / "traffic" / "boxes-b256.json").read_text())
    (bench / "traffic" / "probe-b8.json").write_text(json.dumps({**traffic, "batch": 8}))
    (bench / "limits" / "yolov3-416.probe-b8.json").write_text(
        (bench / "limits" / "yolov3-416.train-b256.json").read_text())
    (bench / "metrics" / "probe_ms.train.py").write_text("def read(run):\n    return 1.5\n")
    spec["workloads"].append({"name": "yolov3-416.probe-b8", "config": "yolov3-416",
                              "traffic": "probe-b8", "chips": 1, "why": "probe"})
    spec["end_to_end"][0]["workloads"].append("yolov3-416.probe-b8")
    spec["per_layer"].append({"name": "probe_ms.train", "unit": "ms", "better": "lower",
                              "source": "device_trace", "layer": "probe",
                              "moves": "train_img_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = load_cell("yolov3-416.probe-b8", str(root))
    assert cell.traffic["batch"] == 8 and cell.config["model"] == "yolov3"
    assert [m["name"] for m in cell.end_to_end] == ["train_img_s", "setup_s"]
    # a metric without a workloads key goes to every cell reporting what it moves
    assert "probe_ms.train" in [m["name"] for m in cell.per_layer]
    assert "probe_ms.train" in [m["name"] for m in load_cell("resnet50-224.train-b256",
                                                            str(root)).per_layer]
    run = RunInfo(cell=cell, device_name="cpu", step_flops={}, window_s=1.0, window_steps=1)
    probe = next(m for m in cell.per_layer if m["name"] == "probe_ms.train")
    assert read_metric(cell, probe, run) == 1.5


def test_kernel_group_is_the_union_of_its_files(tmp_path):
    root = _copy(tmp_path)
    (root / "benchmark" / "kernels" / "conv" / "probe.json").write_text(
        json.dumps({"ops": [], "kernels": ["^probe_conv_kernel$"]}))
    cell = load_cell("yolov3-416.train-b256", str(root))
    group = kernel_group(cell, "conv")
    assert "aten::convolution" in group["ops"]
    assert "^probe_conv_kernel$" in group["kernels"]


@pytest.mark.parametrize("package", ["reference", "programs"])
def test_model_files_found_by_the_configuration_model(package):
    for name in ("yolov3-416.train-b256", "resnet50-224.train-b256"):
        cfg = load_cell(name).config
        assert by_model(package, cfg).__file__ == os.path.join(BENCH_DIR, package,
                                                               cfg["model"] + ".py")
    with pytest.raises(ValueError, match="no benchmark/%s/vgg16.py" % package):
        by_model(package, {"model": "vgg16"})
