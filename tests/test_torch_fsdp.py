"""The port's FSDP (`parallel.fsdp`) on the CPU: two ranks over gloo
(tests/torch_dist_worker.py, scenario ``fsdp``, started once for the module).

  - `fsdp_spec` picks the dimension the JAX package's rule picks for the
    same parameter, on tests/test_fsdp.py's shapes in the port's layouts;
  - two SGD + momentum steps of a small ResNeXt (float64) under
    ``Fit(fsdp=True)`` equal the same steps under DDP: losses, gradient
    norms, parameters, BN statistics and momentum buffers to 1e-5 of each
    tensor's std (JAX's own FSDP test holds 1e-5 absolute);
  - each rank holds half the bytes of the parameters the rule shards;
  - a YOLOv3 sharded in many units (each its own all-gather) steps as DDP,
    and so do two steps of 2 microbatches each (the first backward of each
    skipping the reduction);
  - a checkpoint written under 2-rank FSDP loads into one process bit-equal
    to the gathered state, and a one-process checkpoint resumes under 2-rank
    FSDP and DDP bit-equal to the file;
  - ``train-cls ... mesh_data=2 fsdp=true multihost=true`` on two ranks:
    rank 0 alone writes the log, every epoch validated.
"""
import json
import os
import tempfile

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from fastvision_tpu.parallel import fsdp_spec as jax_fsdp_spec
from fastvision_tpu_torch.core import CheckpointManager
from fastvision_tpu_torch.models import YOLOv3
from fastvision_tpu_torch.parallel import fsdp_spec
from fastvision_tpu_torch.testing import write_classification_dataset
from fastvision_tpu_torch.train import Fit, build_optimizer, cross_entropy, make_train_step
from torch_dist_worker import _resnet, spawn_ranks

torch.set_num_threads(2)
# JAX layout -> the port's, by rank: conv HWIO -> OIHW, dense [in, out] -> [out, in]
TO_PORT = {4: (3, 2, 0, 1), 2: (1, 0)}


@pytest.mark.parametrize("shape", [(3, 3, 64, 64), (3, 3, 256, 64), (128, 256), (64,), (4096,),
                                   (33, 65), (), (3, 3, 3, 32), (1, 1, 512, 512), (2048, 10)])
@pytest.mark.parametrize("axis", [2, 8])
def test_fsdp_spec_matches_jax_rule(shape, axis):
    want = jax_fsdp_spec(np.zeros(shape), axis)
    perm = TO_PORT.get(len(shape), tuple(range(len(shape))))
    port_shape = tuple(shape[i] for i in perm)
    got = fsdp_spec(port_shape, axis)
    if want == P():
        assert got is None
    else:
        jax_dim = [i for i, a in enumerate(want) if a is not None][0]
        assert got == perm.index(jax_dim)


def _plain_checkpoint(workdir, inputs):
    """A one-process run's checkpoint after one SGD + momentum step."""
    model = _resnet(inputs["state"])
    fit = Fit(model, None, build_optimizer("sgd", model, momentum=0.9), None,
              step_fn=make_train_step(lambda lg, b: (cross_entropy(lg, b["labels"]), {}),
                                      torch.float64),
              ckpt_dir=os.path.join(workdir, "plain_ckpt"), device="cpu")
    batch = {k: torch.from_numpy(v[0]) for k, v in inputs["batches"].items()}
    fit.state, _ = fit.step_fn(fit.state, batch, 1e-2)
    fit._save(0, {"epoch": 0, "global_step": 1})
    fit.ckpt.wait()


@pytest.fixture(scope="module")
def ranks():
    with tempfile.TemporaryDirectory() as workdir:  # removed at the end
        yield _run_ranks(workdir)


def _run_ranks(workdir):
    rng = np.random.default_rng(0)
    inputs = {"state": _resnet().state_dict(),
              "batches": {"images": rng.integers(0, 256, (2, 4, 32, 32, 3), dtype=np.uint8),
                          "labels": rng.integers(0, 10, (2, 4)).astype(np.int32)}}
    torch.save(inputs, os.path.join(workdir, "fsdp_inputs.pt"))
    yolo = YOLOv3(num_classes=3, stage_sizes=(1, 1, 1, 1, 1),
                  generator=torch.Generator().manual_seed(0))
    torch.save(yolo.state_dict(), os.path.join(workdir, "yolo_init.pt"))
    lab = np.full((1, 4, 6, 5), -1, np.float32)
    lab[..., :3, 0] = rng.integers(0, 3, (1, 4, 3))
    lab[..., :3, 1:5] = rng.uniform(0.2, 0.6, (1, 4, 3, 4))
    torch.save({"batches": {"images": rng.integers(0, 256, (1, 4, 64, 64, 3), dtype=np.uint8),
                            "labels": lab},
                "anchors": np.full((3, 3, 2), 16, np.float32), "num_classes": 3},
               os.path.join(workdir, "yolo_inputs.pt"))
    write_classification_dataset(os.path.join(workdir, "data", "cls"), 8, num_classes=4,
                                 sizes=((40, 48), (32, 32)))
    _plain_checkpoint(workdir, inputs)
    out = spawn_ranks("fsdp", workdir)()
    return {"ranks": out, "workdir": workdir}


def _close(got, want, rel=1e-5):
    for k, w in want.items():
        if not torch.is_tensor(w) or w.numel() <= 1:
            continue
        d = float((got[k].double() - w.double()).abs().max())
        assert d <= rel * max(float(w.double().std()), 1e-12), (k, d)


def test_fsdp_steps_match_ddp_momentum_included(ranks):
    res = ranks["ranks"][0]["fsdp"]
    ddp, fsdp = res["ddp"], res["fsdp"]
    for a, b in zip(ddp["metrics"], fsdp["metrics"]):
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-5)
        assert b["grad_norm"] == pytest.approx(a["grad_norm"], rel=1e-5)
    _close(fsdp["state"], ddp["state"])
    ms = {i: s["momentum_buffer"] for i, s in ddp["optimizer"]["state"].items()}
    assert len(ms) == len(fsdp["optimizer"]["state"]) > 20
    _close({i: s["momentum_buffer"] for i, s in fsdp["optimizer"]["state"].items()}, ms)
    assert fsdp["optimizer"]["param_groups"] == ddp["optimizer"]["param_groups"]


def test_each_rank_holds_half_the_sharded_bytes(ranks):
    for out in ranks["ranks"]:
        b = out["fsdp"]["bytes"]
        assert b["sharded"] > 0.9 * b["full"]
        assert abs(b["local"] - b["sharded"] / 2) <= 0.01 * b["sharded"]
        # a 1x1 conv [Cout, Cin] with Cin > Cout shards Cin, as the JAX rule
        assert "S(1)" in b["placements"].values()


def test_many_units_step_as_ddp(ranks):
    got = ranks["ranks"][0]["fsdp"]["units"]
    assert got["n_units"] > 5
    assert got["units"]["loss"] == pytest.approx(got["ddp"]["loss"], rel=1e-9)
    assert got["max_rel_to_std"] <= 1e-5


def test_microbatches_under_fsdp_match_ddp(ranks):
    got = ranks["ranks"][0]["fsdp"]["microbatch"]
    for k in ("loss", "grad_norm"):
        assert got["fsdp"][k] == pytest.approx(got["ddp"][k], rel=1e-9)
    _close(got["fsdp"]["state"], got["ddp"]["state"])


def test_fsdp_checkpoint_round_trips_across_process_counts(ranks):
    res = ranks["ranks"][0]["fsdp"]
    # written by 2-rank FSDP, read by one process
    restored = CheckpointManager(os.path.join(ranks["workdir"], "ckpt_fsdp")).restore(0)
    model = _resnet()
    model.load_state_dict(restored["state"]["model"])
    opt = build_optimizer("sgd", model, momentum=0.9)
    opt.load_state_dict(restored["state"]["optimizer"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, res["fsdp"]["state"][k]), k
    for i, s in res["fsdp"]["optimizer"]["state"].items():
        assert torch.equal(opt.state_dict()["state"][i]["momentum_buffer"], s["momentum_buffer"])
    # written by one process, resumed by 2-rank FSDP and DDP (compared by rank 0)
    for kind in ("fsdp", "ddp"):
        assert res[f"{kind}_resumed"] == {"epoch": 1, "equal_to_file": True}, kind


def test_cli_train_cls_fsdp_on_two_ranks(ranks):
    r0, r1 = (out["cli"] for out in ranks["ranks"])
    assert r0["kind"].startswith("FSDP") and r1["kind"].startswith("FSDP")
    assert r0["steps"] == r1["steps"] == 2  # 2 epochs of 4 // (2 ranks x 2) batches
    with open(os.path.join(ranks["workdir"], "cli_ckpt", "train.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert recs == r0["records"]
    epochs = [r for r in recs if "train_loss" in r]
    assert [r["epoch"] for r in epochs] == [0, 1]  # one writer: no record twice
    assert all(0.0 <= r["accuracy"] <= 1.0 and np.isfinite(r["train_loss"]) for r in epochs)
