"""The whole run, on the CPU at a small size, with the timed path broken
underneath: ``correct`` comes out false for each fault a training cell can
have, against the cells' own limits; a sound float32 program passes them.
The control, one precision below the configuration's, fails them on the
card at the cell's own size."""
import copy
import gc
import json
import time

import pytest
import torch

from harness.cells import load_cell
from harness.runner import execute

CELLS = ["yolov3-416.train-b256", "resnet50-224.train-b256"]


def small(name: str):
    cell = copy.deepcopy(load_cell(name))
    depth = [1] * len(cell.config["stage_sizes"])
    cell.config.update(input_size=64, stage_sizes=depth)
    cell.traffic.update(batch=4, pool=6, warmup_steps=1, trace_steps=1)
    return cell


def run(cell, fault=None):
    line, lines = execute(cell, 2**31 + 11, 0.2, False, torch.device("cpu"), time.time(), fault)
    assert lines[-1] == f"correct: {json.loads(line)['correct']}"
    return json.loads(line)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_fault_is_not_correct(name, fault):
    out = run(small(name), fault)
    assert out["correct"] is False
    assert out["attempted"] > 0 and list(out)[-1] == "check"


@pytest.mark.parametrize("name", CELLS)
def test_sound_float32_program_is_correct(name):
    cell = small(name)
    cell.config["dtype"] = "float32"
    out = run(cell)
    assert out["correct"] is True, out["check"]
    assert set(out["metrics"]) == {"train_img_s", "setup_s"}


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size on a CUDA card")
    from control import reference_readings
    from harness.compare import judge

    gc.collect()
    torch.cuda.empty_cache()  # hand back what an earlier cell's reference left cached
    cell = load_cell(name)
    reading = reference_readings(cell, 2**31 + 101, [cell.limits["control"]],
                                 torch.device("cuda", 0))[0]
    assert not judge(reading, cell.limits["limits"])[0], reading
