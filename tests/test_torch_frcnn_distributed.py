"""The port's Faster R-CNN over several ranks on the CPU: two gloo ranks on
the data axis (tests/torch_dist_worker.py scenario ``frcnn2``, started once
for the module), float64.

  - one SGD step (momentum 0.9, global-norm clip 10: the recipe of
    ``cli.py::_train_faster_rcnn``) of tests/test_torch_frcnn_model.py's
    small configuration, each rank on its half of a global batch of 2 and
    fed the JAX package's samples and dropout masks of the whole batch
    (each rank keeps its rows), equals the JAX package's single-device step
    on the global batch (losses rtol 1e-6; each tensor within 1e-6 of its
    std, or 1e-5 of the update for tensors that start constant); the ranks
    end bit-equal; so does the step with the model under FSDP, and under
    tensor parallel on a 1 x 2 x 1 mesh. The RoI-align output is 2 x 2 here
    (7 x 7 in the model test) so that the float64 head fits the CPU's
    memory three times over;
  - the same step with the step's own draws (its generator, seeded from
    (seed, step) on every rank: the global batch's draws, the rank's rows)
    equals this process's one-process step on the global batch, to the
    same bounds (the losses are float32 on both sides);
  - ``train model.name=faster_rcnn mesh_data=2 multihost=true
    data.host_shard=auto`` (the small configuration at 64 px) runs end to
    end under DDP with the sharded validation, and its checkpoint loads
    into one process.
"""
import os
import tempfile
import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvision_tpu.train as jt
import fastvision_tpu_torch.train as tt
from fastvision_tpu_torch.core import CheckpointManager
from fastvision_tpu_torch.models import FasterRCNN, faster_rcnn_state_dict_from_jax
from fastvision_tpu_torch.testing import write_detection_dataset
from test_torch_distributed import _check_state
from test_torch_frcnn_model import CFG, Recorder, _train_batch, jfr
from torch_dist_worker import same, spawn_ranks

torch.set_num_threads(2)
CFG2 = {**CFG, "roi_size": 2}
B, HIDDEN = 2, 4096


class Feeder(Recorder):
    """`Recorder` whose draws are made before the JAX step runs (so the
    ranks can start first): U(0, 1) per sampler call, in the JAX forward's
    order (RPN positive / negative over K anchors, RoI positive / negative
    over P proposals), then the head's two keep masks."""

    def __init__(self, seed, k, p, n):
        super().__init__(seed)
        self.uniforms = [self.rng.uniform(size=(m,)).astype(np.float32) for m in (k, k, p, p)]
        self.keeps = [self.rng.uniform(size=(B, n, HIDDEN)) < 0.5 for _ in range(2)]
        self._u, self._k = iter(self.uniforms), iter(self.keeps)

    def sampler(self, rng, mask, k):
        u = next(self._u)
        assert u.shape == mask.shape
        _, idx = jax.lax.top_k(mask.astype(jnp.float32) + u, k)
        return idx, mask[idx].astype(jnp.float32)

    def dropout(self, next_fun, args, kwargs, context):
        if not isinstance(context.module, fnn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        keep = next(self._k)
        assert keep.shape == args[0].shape
        return jnp.where(keep, args[0] / 0.5, 0.0)


def _jax_step(variables, batch, feeder):
    with jax.enable_x64(True):
        model = jfr.FasterRCNN(**CFG2, dtype=jnp.float64)
        tx = jt.build_optimizer("sgd", variables["params"], momentum=0.9, grad_clip_norm=10.0)
        saved = jfr.random_sample_mask
        jfr.random_sample_mask = feeder.sampler
        try:
            with fnn.intercept_methods(feeder.dropout):
                jstate, m = jt.make_frcnn_train_step(model, tx, seed=0)(
                    jt.TrainState.create(variables, tx), batch, 1e-2)
        finally:
            jfr.random_sample_mask = saved
        return {"want": faster_rcnn_state_dict_from_jax(jax.device_get({"params": jstate.params})),
                "metrics": {k: float(v) for k, v in m.items()}}


def _port_model(state):
    model = FasterRCNN(**CFG2).double()
    model.load_state_dict(state)
    return model


@pytest.fixture(scope="module")
def runs():
    init = jax.jit(lambda key: jfr.FasterRCNN(**CFG2).init(
        {"params": key, "sampling": jax.random.key(1), "dropout": jax.random.key(2)},
        jnp.zeros((B, CFG2["image_size"], CFG2["image_size"], 3)),
        jnp.zeros((B, 3, 5)) - 1, train=True))
    variables = jax.device_get(init(jax.random.key(0)))
    state = faster_rcnn_state_dict_from_jax(variables)
    batch = _train_batch(20)
    k = (CFG2["image_size"] // 16) ** 2 * 9
    feeder = Feeder(19, k, CFG2["rpn_post_nms_train"], CFG2["roi_pos"] + CFG2["roi_neg"])
    draws = [np.broadcast_to(u, (B,) + u.shape).copy() for u in feeder.uniforms] + feeder.keeps
    with tempfile.TemporaryDirectory() as workdir:
        torch.save({"cfg": CFG2, "state": state, "batch": batch, "draws": draws},
                   os.path.join(workdir, "frcnn_inputs.pt"))
        write_detection_dataset(os.path.join(workdir, "data", "det"), 4,
                                sizes=((96, 128), (128, 112)), num_classes=CFG2["num_classes"],
                                max_objects=3)
        collect = spawn_ranks("frcnn2", workdir)
        out = {}
        side = threading.Thread(target=lambda: out.update(jax=_jax_step(variables, batch,
                                                                         feeder)))
        side.start()  # while the ranks run
        # this process's one-process step with the step's own draws
        model = _port_model(state)
        st = tt.TrainState.create(model, tt.build_optimizer(
            "sgd", model, momentum=0.9, grad_clip_norm=10.0), "cpu")
        st, m = tt.make_frcnn_train_step(seed=0, dtype=torch.float64)(
            st, {k: torch.from_numpy(v) for k, v in batch.items()}, 1e-2)
        out["one"] = {"state": {k: v.clone() for k, v in model.state_dict().items()},
                      "metrics": {k: float(v) for k, v in m.items()}}
        ranks = collect()
        side.join()
        assert "jax" in out, "the JAX side failed (its traceback is above)"
        yield {"ranks": ranks, "start": state, "workdir": workdir, **out}


def test_two_rank_step_matches_jax_global_batch(runs):
    want = runs["jax"]
    r0, r1 = (o["frcnn"] for o in runs["ranks"])
    assert r0["local_batch"] == r1["local_batch"] == 1
    for k in ("rpn_cls", "rpn_reg", "cls", "reg", "loss"):
        assert r0["metrics"][k] == pytest.approx(want["metrics"][k], rel=1e-6), k
    assert r0["metrics"] == r1["metrics"]
    _check_state(r0["state"], want["want"], runs["start"])
    for k, v in r0["state"].items():
        assert same(v, r1["state"][k]), k


@pytest.mark.parametrize("placement", ["fsdp", "tp"])
def test_two_rank_step_under_fsdp_and_tensor_parallel_matches_jax(runs, placement):
    """The same step with the model sharded: FSDP over the data axis (each
    rank its half of the batch), tensor parallel over a 1 x 2 x 1 mesh
    (every rank the global batch)."""
    want = runs["jax"]
    r0, r1 = (o["frcnn"][placement] for o in runs["ranks"])
    assert r0["kind"] == ("fsdp" if placement == "fsdp" else None)
    for k in ("rpn_cls", "rpn_reg", "cls", "reg", "loss"):
        assert r0["metrics"][k] == pytest.approx(want["metrics"][k], rel=1e-6), k
    assert r0["metrics"] == r1["metrics"]
    _check_state(r0["state"], want["want"], runs["start"])


def test_two_rank_step_draws_the_global_batch(runs):
    one = runs["one"]
    r0, r1 = (o["frcnn"]["generator"] for o in runs["ranks"])
    for k, v in one["metrics"].items():  # the losses are float32 in both
        assert r0["metrics"][k] == pytest.approx(v, rel=1e-6), k
    _check_state(r0["state"], one["state"], runs["start"])
    for k, v in r0["state"].items():
        assert same(v, r1["state"][k]), k


def test_cli_train_faster_rcnn_over_two_ranks(runs):
    clis = [o["cli"] for o in runs["ranks"]]
    for r, c in enumerate(clis):
        assert c["kind"] == "ddp" and c["host"] == (r, 2) and c["steps"] == clis[0]["steps"] > 0
    recs = [r for r in clis[0]["records"] if "train_loss" in r]
    assert len(recs) == 1 and np.isfinite(recs[0]["train_loss"]) and 0 <= recs[0]["map50"] <= 1
    restored = CheckpointManager(os.path.join(runs["workdir"], "cli_frcnn_ckpt")).restore()
    model = FasterRCNN(**{**CFG2, "image_size": 64})
    model.load_state_dict(restored["state"]["model"])  # strict: the one-process format
