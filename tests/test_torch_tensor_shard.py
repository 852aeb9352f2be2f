"""The port's tensor parallelism and three-axis mesh on the CPU: gloo ranks
(tests/torch_dist_worker.py, each scenario started once for the module)
against the JAX package's single-device steps on the global batch, float64
on both sides.

  - `tp_spec` equals the JAX rule on tests/test_tensor_shard.py's cases
    mapped through the weight bridge's layout (output channels: the JAX
    layout's last dimension, the port's first);
  - the rank order is JAX's ``reshape(data, model, time)``; `create_mesh`
    and the CLI's mesh take the JAX test_mesh_config.py cases;
  - ``tp2`` (a 1 x 2 x 1 mesh): one SGD step (momentum 0.9, clip 10) of a
    shallow YOLOv3 with its channels sharded over the model axis equals
    the JAX step (loss rtol 1e-6; each tensor within 1e-6 of its std, or
    1e-5 of the update for tensors that start constant); an eval forward
    equals the unsharded model's to 1e-10 of each head's std; ``fsdp=True`` on a model axis
    places tensor parallel (the JAX package's precedence); a checkpoint
    saved at mesh_model=2 is the one-process format (it loads into one
    process bit-equal to the gathered state, the EMA and momentum too) and
    a one-process checkpoint resumes at mesh_model=2;
  - ``tp4`` (2 x 2 x 1): ``host_shard='auto'`` gives ranks 0 and 1 (one
    data index) the same files and ranks 0 and 2 disjoint ones; one step of
    ResNet-18 (tests/test_tensor_shard.py's model) equals the JAX step on
    the global batch of 8, the ranks bit-equal; ``train-cls mesh_data=2
    mesh_model=2`` runs end to end (with ``fsdp=true``: tensor parallel
    wins) and ``eval --task cls`` of its checkpoint at mesh_model=2 gives
    the accuracy this process gets from the same checkpoint alone.
"""
import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvision_tpu.train as jt
from fastvision_tpu.cli import _mesh_from_cfg as jax_mesh_from_cfg
from fastvision_tpu.core.config import Config as JaxConfig
from fastvision_tpu.core.config import apply_overrides as jax_overrides
from fastvision_tpu.core.mesh import create_mesh as jax_create_mesh
from fastvision_tpu.data import normalize_images as jax_normalize
from fastvision_tpu.models import classification as jz
from fastvision_tpu.models.classification.darknet53 import Darknet53 as JaxDarknet53
from fastvision_tpu.models.detection import YOLOv3 as JaxYOLOv3
from fastvision_tpu.parallel import tp_spec as jax_tp_spec
from fastvision_tpu_torch import cli
from fastvision_tpu_torch.core import CheckpointManager, Mesh
from fastvision_tpu_torch.core.config import Config, apply_overrides
from fastvision_tpu_torch.models import (YOLOv3, resnet_state_dict_from_jax,
                                         yolov3_state_dict_from_jax)
from fastvision_tpu_torch.parallel import tp_spec
from fastvision_tpu_torch.testing import write_classification_dataset
from test_torch_distributed import _check_state
from torch_dist_worker import same, spawn_ranks

torch.set_num_threads(2)
C, S, K = 3, 64, 8
ANCHORS = np.array([[[116, 90], [156, 198], [373, 326]],
                    [[30, 61], [62, 45], [59, 119]],
                    [[10, 13], [16, 30], [33, 23]]], np.float32) / 4


class _ShallowJaxDarknet(JaxDarknet53):
    stage_sizes = (1, 1, 1, 1, 1)


@pytest.mark.parametrize("jax_shape,port_shape,n", [
    ((3, 3, 16, 64), (64, 16, 3, 3), 8), ((128, 256), (256, 128), 8), ((64,), (64,), 8),
    ((3, 3, 3, 12), (12, 3, 3, 3), 8), ((), (), 8), ((3, 3, 16, 64), (64, 16, 3, 3), 3)])
def test_tp_spec_matches_jax(jax_shape, port_shape, n):
    want = jax_tp_spec(np.zeros(jax_shape), n)
    got = tp_spec(np.zeros(port_shape), n)
    assert (got is None) == (want == jax.sharding.PartitionSpec())
    if got is not None:  # the JAX layout's last dimension is the port's first
        assert want[-1] == "model" and got == 0


def test_rank_order_is_jax_reshape():
    jmesh = jax_create_mesh(2, 2, 2)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    mesh = Mesh(2, 2, 2)
    for r in range(8):
        d, m, t = (int(i[0]) for i in np.nonzero(ids == r))
        assert mesh.coords(r) == {"data": d, "model": m, "time": t}
    assert mesh.ranks_along(("data", "time")) == [[0, 1, 4, 5], [2, 3, 6, 7]]


@pytest.mark.parametrize("overrides", [[], ["mesh_model=4", "mesh_time=2"], ["mesh_model=2"],
                                       ["mesh_data=2", "mesh_model=4"], ["mesh_data=3"]])
def test_mesh_from_cfg_matches_jax_at_8_ranks(overrides, monkeypatch):
    import fastvision_tpu_torch.core.mesh as tmesh

    monkeypatch.setattr(tmesh, "world_size", lambda: 8)  # eight ranks, no group to build
    try:
        want = jax_mesh_from_cfg(jax_overrides(JaxConfig(), overrides)).shape
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" devices")[0]):
            cli._mesh_from_cfg(apply_overrides(Config(), overrides), "cpu")
        return
    got = cli._mesh_from_cfg(apply_overrides(Config(), overrides), "cpu")
    assert got.shape == dict(want)


def test_mesh_without_a_group():
    from fastvision_tpu_torch.core import create_mesh

    assert Mesh(1, 2, 1).shape == {"data": 1, "model": 2, "time": 1}
    assert Mesh(1, 1, 2).size == 2
    for kw, shape in ((dict(model=2), "0x2x1"), (dict(time=2), "0x1x2"),
                      (dict(data=1, model=2), "1x2x1")):
        with pytest.raises(ValueError, match=f"mesh {shape} != 1 processes"):
            create_mesh(**kw)
    with pytest.raises(ValueError, match=">= 1"):
        Mesh(1, 0)


def test_cli_no_longer_refuses_the_mesh_axes(tmp_path, monkeypatch):
    """The CLI's config load takes the mesh axes, and compile_cache too (it
    sets the native build directory; this process's is put back after)."""
    from types import SimpleNamespace

    from fastvision_tpu_torch import cuda_build

    args = SimpleNamespace(config="")
    cfg = cli._load_config(args, ["mesh_model=2", "mesh_time=2"])
    assert (cfg.mesh_model, cfg.mesh_time) == (2, 2)
    for name in ("_BUILDS", "_LIBS"):
        monkeypatch.setattr(cuda_build, name, {})
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    cfg = cli._load_config(args, [f"compile_cache={tmp_path / 'x'}"])
    assert cuda_build.build_dir() == str(tmp_path / "x") == cfg.compile_cache


def _labels(rng, counts):
    lab = np.full((len(counts), 6, 5), -1, np.float32)
    for i, n in enumerate(counts):
        lab[i, :n, 0] = rng.integers(0, C, n)
        lab[i, :n, 1:3] = rng.uniform(0.2, 0.8, (n, 2))
        lab[i, :n, 3:5] = rng.uniform(0.1, 0.5, (n, 2))
    return lab


def _yolo_jax(workdir):
    """One SGD step (momentum 0.9, clip 10) of the shallow JAX YOLOv3 on a
    batch of 4: writes the ranks' inputs (and a one-process checkpoint of
    the start), yields, then steps."""
    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 256, (4, S, S, 3), dtype=np.uint8),
             "labels": _labels(rng, (3, 1, 2, 1))}
    with jax.enable_x64(True):
        jm = JaxYOLOv3(num_classes=C, dtype=jnp.float64,
                       backbone_fn=lambda **kw: _ShallowJaxDarknet(including_top=False, **kw))
        variables = jax.device_get(jax.jit(lambda k, x: jm.init(k, x, train=True))(
            jax.random.key(0), jnp.zeros((1, S, S, 3))))
    start = yolov3_state_dict_from_jax(variables)
    torch.save({"state": start, "batch": batch, "anchors": ANCHORS, "num_classes": C,
                "lr": 1e-2}, os.path.join(workdir, "tp_yolo_inputs.pt"))
    # a one-process checkpoint (weights and momentum) for the ranks to resume
    from fastvision_tpu_torch.train import build_optimizer

    model = YOLOv3(num_classes=C, stage_sizes=(1, 1, 1, 1, 1))
    model.load_state_dict(start)
    model.double()
    opt = build_optimizer("sgd", model, momentum=0.9)
    for i, p in enumerate(p for g in opt.param_groups for p in g["params"]):
        opt.state[p]["momentum_buffer"] = torch.full_like(p, 0.01 * i)
    ckpt = CheckpointManager(os.path.join(workdir, "plain_tp_ckpt"))
    ckpt.save(0, model.state_dict(), opt.state_dict(), extra={"epoch": 0, "global_step": 1})
    ckpt.wait()
    yield
    with jax.enable_x64(True):
        loss_obj = jt.YOLOv3Loss(ANCHORS, num_classes=C)

        def loss_fn(heads, b):
            o = loss_obj(heads, b["labels"])
            return o.total, {"box": o.box, "obj": o.obj, "cls": o.cls}

        def apply(v, images, **kw):
            return jm.apply(v, jax_normalize(images, jnp.float64), **kw)

        tx = jt.build_optimizer("sgd", variables["params"], momentum=0.9, grad_clip_norm=10.0)
        jstate, m = jt.make_train_step(apply, loss_fn, tx, donate=False)(
            jt.TrainState.create(variables, tx), batch, 1e-2)
        want = yolov3_state_dict_from_jax(jax.device_get(jstate.variables()))
    yield {"metrics": {k: float(v) for k, v in m.items()}, "want": want, "start": start}


def _resnet_jax(workdir):
    """One SGD step of ResNet-18 (8 classes) on a global batch of 8 at 64 px."""
    rng = np.random.default_rng(1)
    batch = {"images": rng.integers(0, 256, (8, S, S, 3), dtype=np.uint8),
             "labels": (np.arange(8) % K).astype(np.int32)}
    with jax.enable_x64(True):
        jm = jz.resnet18(num_classes=K, dtype=jnp.float64)
        variables = jax.device_get(jax.jit(lambda k, x: jm.init(k, x, train=True))(
            jax.random.key(0), jnp.zeros((1, S, S, 3))))
    start = resnet_state_dict_from_jax(variables)
    torch.save({"state": start, "batch": batch, "k": K, "lr": 1e-2},
               os.path.join(workdir, "tp_resnet_inputs.pt"))
    yield
    with jax.enable_x64(True):
        def apply(v, images, **kw):
            return jm.apply(v, jax_normalize(images, jnp.float64, imagenet=True), **kw)

        def loss_fn(logits, b):
            return jt.cross_entropy(logits, b["labels"]), {}

        tx = jt.build_optimizer("sgd", variables["params"])
        jstate, m = jt.make_train_step(apply, loss_fn, tx, donate=False)(
            jt.TrainState.create(variables, tx), batch, 1e-2)
        want = resnet_state_dict_from_jax(jax.device_get(jstate.variables()))
    yield {"metrics": {k: float(v) for k, v in m.items()}, "want": want, "start": start}


def _next_of_each(gens: dict) -> dict:
    out = {}
    threads = [threading.Thread(target=lambda k=k, g=g: out.__setitem__(k, next(g)))
               for k, g in gens.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(out) == len(gens), "a JAX side failed (its traceback is above)"
    return out


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as workdir:
        jax_side = {"yolo": _yolo_jax(workdir), "resnet": _resnet_jax(workdir)}
        _next_of_each(jax_side)  # the ranks' inputs
        write_classification_dataset(os.path.join(workdir, "data", "cls"), 9, num_classes=4,
                                     sizes=((40, 48), (32, 32)))
        collect2 = spawn_ranks("tp2", workdir, world=2)
        collect4 = spawn_ranks("tp4", workdir, world=4)
        want = _next_of_each(jax_side)  # the JAX steps, while the ranks run
        yield {"tp2": collect2(), "tp4": collect4(), "workdir": workdir, **want}


def test_ranks_sit_where_jax_puts_them(runs):
    assert [o["coords"] for o in runs["tp2"]] == [{"data": 0, "model": m, "time": 0}
                                                   for m in (0, 1)]
    assert [o["coords"]["data"] for o in runs["tp4"]] == [0, 0, 1, 1]
    assert [o["coords"]["model"] for o in runs["tp4"]] == [0, 1, 0, 1]


def test_tp_yolo_step_matches_jax(runs):
    want = runs["yolo"]
    r0, r1 = (o["tp_yolo"] for o in runs["tp2"])
    for k in ("loss", "box", "obj", "cls"):
        assert r0["metrics"][k] == pytest.approx(want["metrics"][k], rel=1e-6), k
    assert r0["metrics"]["grad_norm"] == pytest.approx(want["metrics"]["grad_norm"], rel=1e-6)
    assert r0["metrics"] == r1["metrics"]
    _check_state(r0["state"], want["want"], want["start"])
    for k, v in r0["state"].items():
        assert same(v, r1["state"][k]), k
    # convs' and linears' output channels sharded, BN whole
    shapes = r0["local_shapes"]
    assert shapes["backbone.conv0.conv.weight"][0] == 16
    assert shapes["backbone.conv0.bn.weight"][0] == 32
    assert shapes["head.head_out_small.weight"][0] == 3 * (5 + C) // 2
    assert r0["eval_max_rel"] <= 1e-10


def test_tensor_parallel_wins_over_fsdp(runs):
    for out in runs["tp2"]:
        assert out["tp_yolo"]["tensor_parallel"] and out["tp_yolo"]["kind"] is None


def test_tp_checkpoint_is_the_one_process_format(runs):
    r0 = runs["tp2"][0]["tp_ckpt"]
    restored = CheckpointManager(os.path.join(runs["workdir"], "tp_ckpt")).restore(0)["state"]
    model = YOLOv3(num_classes=C, stage_sizes=(1, 1, 1, 1, 1)).double()
    model.load_state_dict(restored["model"])  # strict: every tensor whole
    for k, v in model.state_dict().items():
        assert torch.equal(v, r0["state"][k]), k
    for i, s in restored["optimizer"]["state"].items():
        assert torch.equal(s["momentum_buffer"], r0["optimizer"]["state"][i]["momentum_buffer"])
    for k, v in r0["ema"].items():
        assert torch.equal(restored["ema"][k], v), k
    for out in runs["tp2"]:  # the reverse: a one-process checkpoint resumed at mesh_model=2
        assert out["tp_ckpt"]["resumed_epoch"] == 1
    assert r0["resumed_equal_to_file"]


def test_host_shard_follows_the_data_index(runs):
    loaders = [o["loader"] for o in runs["tp4"]]
    assert [ld["host"] for ld in loaders] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    for a, b in zip(loaders[0]["images"], loaders[1]["images"]):
        np.testing.assert_array_equal(a, b)
    first = {x.tobytes() for b in loaders[0]["images"] for x in b}
    other = {x.tobytes() for b in loaders[2]["images"] for x in b}
    assert first and other and not first & other


def test_data_x_model_resnet18_step_matches_jax(runs):
    want = runs["resnet"]
    outs = [o["tp_resnet"] for o in runs["tp4"]]
    assert [o["local_batch"] for o in outs] == [4, 4, 4, 4]
    assert outs[0]["metrics"]["loss"] == pytest.approx(want["metrics"]["loss"], rel=1e-6)
    assert outs[0]["metrics"]["grad_norm"] == pytest.approx(want["metrics"]["grad_norm"],
                                                           rel=1e-6)
    _check_state(outs[0]["state"], want["want"], want["start"])
    for o in outs[1:]:
        assert o["metrics"] == outs[0]["metrics"]
        assert all(same(v, o["state"][k]) for k, v in outs[0]["state"].items())
    assert all(o["buffers_equal"] for o in outs)


def test_cli_train_cls_over_data_and_model_axes(runs):
    from fastvision_tpu_torch.core import restore_inference_weights
    from fastvision_tpu_torch.data import ClassificationDataset, ClassificationLoader
    from fastvision_tpu_torch.train import (TrainState, classification_evaluator,
                                            make_eval_step)
    from torch_dist_worker import _resnet

    clis = [o["cli"] for o in runs["tp4"]]
    for c in clis:
        assert c["tensor_parallel"] and c["steps"] == clis[0]["steps"] > 0
        assert c["eval"] == clis[0]["eval"]
    recs = clis[0]["records"]
    assert sum("train_loss" in r for r in recs) == 2
    assert all(np.isfinite(r["train_loss"]) for r in recs if "train_loss" in r)
    # the checkpoint loads into one process, which scores it as the ranks did
    model = _resnet(k=4).float()
    restore_inference_weights(os.path.join(runs["workdir"], "cli_tp_ckpt"), model)
    loader = ClassificationLoader(ClassificationDataset(
        os.path.join(runs["workdir"], "data", "cls"), "val"), 32, 4, train=False)
    res = classification_evaluator(make_eval_step(imagenet=True))(
        TrainState.create(model, None, "cpu"), loader)
    assert res["accuracy"] == clis[0]["eval"]
