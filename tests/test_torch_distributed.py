"""The port's data parallelism on the CPU: two ranks over gloo
(tests/torch_dist_worker.py, started once for the module) against the JAX
package's single-device step on the global batch and against one process.

  - `resolve_host_shard` / `host_shard_order` equal the JAX package's on its
    own tests' cases;
  - the global BN: output and input gradient on each rank's slice, the
    ranks' weight / bias gradients summed, and the running statistics after
    two forwards equal one process's on the global batch (float64, atol
    1e-10); the ranks' slices have different statistics;
  - the YOLOv3 loss under DDP with ``accum_steps: 2`` (`MultiSteps`), the
    ranks holding 10 and 2 positives, and a classifier step with mixup then
    one with cutmix (the JAX package's draws): each step's loss (rtol 1e-6)
    and gradient norm (rtol 1e-5; the first MultiSteps call's is the rank's
    own, see ROADMAP Queue 3) and the parameters and BN statistics after
    the steps (max|d| <= 1e-6 * std, or <= 1e-5 * the largest update for
    tensors that start constant, or within 4 float32 half-ulps of the
    tensor's largest value: the JAX side keeps float32 parameters) equal
    the JAX package's single-device steps on the global batch, computed in
    float64 on both sides; both ranks end bit-equal, and the
    BN buffers agree across ranks without DDP broadcasting them;
  - the union of the two ranks' host-sharded epochs ('auto') is byte-equal
    to the one-rank epoch, for the detection, classification and video
    loaders (thread, serial and process backends);
  - one YOLOv3 step of 2 in-step microbatches (``make_train_step(
    accum_steps=2)``) equals the JAX package's on the global batch, each
    microbatch a contiguous half of it;
  - each evaluator gives both ranks the metric one process computes;
  - a preemption request on one rank after the epoch's last agreement
    stops both ranks at the epoch's end with one checkpoint;
  - ``multihost=true`` with no reachable coordinator exits non-zero.
"""
import os
import subprocess
import sys
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvision_tpu.data as jd
import fastvision_tpu.train as jt
from fastvision_tpu.data import normalize_images as jax_normalize
from fastvision_tpu.models import classification as jz
from fastvision_tpu.models.classification.darknet53 import Darknet53 as JaxDarknet53
from fastvision_tpu.models.detection import YOLOv3 as JaxYOLOv3
from fastvision_tpu_torch.core import CheckpointManager
from fastvision_tpu_torch.data import (ClassificationDataset, ClassificationLoader,
                                       DetectionDataset, DetectionLoader, VideoClipLoader,
                                       VideoFolderDataset, host_shard_order, resolve_host_shard)
from fastvision_tpu_torch.data.augment import Augmentation, HorizontalFlip, HSVJitter
from fastvision_tpu_torch.models import resnet_state_dict_from_jax, yolov3_state_dict_from_jax
from fastvision_tpu_torch.testing import (write_classification_dataset,
                                          write_detection_dataset, write_video_dataset)
from test_torch_cls_train import _jax_draws
from torch_dist_worker import free_port, same, spawn_ranks

torch.set_num_threads(2)
C, S, K = 3, 64, 10
ANCHORS = np.array([[[116, 90], [156, 198], [373, 326]],
                    [[30, 61], [62, 45], [59, 119]],
                    [[10, 13], [16, 30], [33, 23]]], np.float32) / 4


class _ShallowJaxDarknet(JaxDarknet53):
    stage_sizes = (1, 1, 1, 1, 1)


def _labels(rng, counts):
    """[len(counts), 6, 5] padded labels, image i holding counts[i] boxes."""
    lab = np.full((len(counts), 6, 5), -1, np.float32)
    for i, n in enumerate(counts):
        lab[i, :n, 0] = rng.integers(0, C, n)
        lab[i, :n, 1:3] = rng.uniform(0.2, 0.8, (n, 2))
        lab[i, :n, 3:5] = rng.uniform(0.1, 0.5, (n, 2))
    return lab


def _yolo_jax(workdir):
    """Two MultiSteps(2) calls of the JAX YOLOv3 step on global batches of 4
    whose first two images (rank 0's) hold 5 boxes each, the others 1.
    Writes the ranks' inputs, then yields; the steps run on the next call."""
    rng = np.random.default_rng(0)
    batches = {"images": rng.integers(0, 256, (2, 4, S, S, 3), dtype=np.uint8),
               "labels": np.stack([_labels(rng, (5, 5, 1, 1)) for _ in range(2)])}
    lrs = (1e-2, 5e-3)
    with jax.enable_x64(True):
        jm = JaxYOLOv3(num_classes=C, dtype=jnp.float64,
                       backbone_fn=lambda **kw: _ShallowJaxDarknet(including_top=False, **kw))
        variables = jax.device_get(jax.jit(lambda k, x: jm.init(k, x, train=True))(
            jax.random.key(0), jnp.zeros((1, S, S, 3))))
    start = yolov3_state_dict_from_jax(variables)
    torch.save(start, os.path.join(workdir, "yolo_init.pt"))
    torch.save({"batches": batches, "lrs": lrs, "anchors": ANCHORS, "num_classes": C},
               os.path.join(workdir, "yolo_inputs.pt"))
    yield
    with jax.enable_x64(True):
        loss_obj = jt.YOLOv3Loss(ANCHORS, num_classes=C)

        def loss_fn(heads, batch):
            o = loss_obj(heads, batch["labels"])
            return o.total, {"box": o.box, "obj": o.obj, "cls": o.cls}

        def apply(v, images, **kw):
            return jm.apply(v, jax_normalize(images, jnp.float64), **kw)

        tx = jt.build_optimizer("sgd", variables["params"], accum_steps=2)
        jstate = jt.TrainState.create(variables, tx)
        step = jt.make_train_step(apply, loss_fn, tx, donate=False)
        metrics = []
        for i, lr in enumerate(lrs):
            jstate, m = step(jstate, {k: v[i] for k, v in batches.items()}, lr)
            metrics.append({k: float(v) for k, v in m.items()})
        want = yolov3_state_dict_from_jax(jax.device_get(jstate.variables()))
        # one step of 2 in-step microbatches over the first global batch
        # (BN statistics carried in float64 through the microbatch scan)
        tx = jt.build_optimizer("sgd", variables["params"])
        step = jt.make_train_step(apply, loss_fn, tx, donate=False, accum_steps=2)
        stats64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables["batch_stats"])
        jstate, m = step(jt.TrainState.create({**variables, "batch_stats": stats64}, tx),
                         {k: v[0] for k, v in batches.items()}, lrs[0])
        micro = {"metrics": {k: float(v) for k, v in m.items()},
                 "want": yolov3_state_dict_from_jax(jax.device_get(jstate.variables()))}
    yield {"metrics": metrics, "want": want, "start": start, "micro": micro}


def _cls_jax(workdir):
    """A mixup step then a cutmix step of a small ResNeXt on global batches
    of 4, the JAX package's draws fed to the port (as `_yolo_jax`)."""
    kw = dict(mixup_alpha=0.2, cutmix_alpha=1.0, smoothing=0.1)
    rng = np.random.default_rng(1)
    batches = {"images": rng.integers(0, 256, (2, 4, S, S, 3), dtype=np.uint8),
               "labels": rng.integers(0, K, (2, 4)).astype(np.int32)}
    with jax.enable_x64(True):
        seed = next(s for s in range(100) if [_jax_draws(s, i, 0.2, 1.0).mixup for i in (0, 1)]
                    == [True, False])
        draws = [_jax_draws(seed, i, 0.2, 1.0) for i in (0, 1)]
        jm = jz.ResNet(jz.resnet.Bottleneck, (1, 1, 1, 1), num_classes=K, groups=4,
                       base_width=4, dtype=jnp.float64)
        variables = jax.device_get(jax.jit(lambda k, x: jm.init(k, x, train=True))(
            jax.random.key(0), jnp.zeros((1, S, S, 3))))
    start = resnet_state_dict_from_jax(variables)
    torch.save({"batches": batches, "k": K, "mix": kw, "draws": draws, "state": start},
               os.path.join(workdir, "cls_inputs.pt"))
    yield
    with jax.enable_x64(True):
        def apply(v, images, **a):
            return jm.apply(v, jax_normalize(images, jnp.float64, imagenet=True), **a)

        def loss_fn(logits, batch):
            return jt.soft_cross_entropy(logits, batch["soft"]), {}

        tx = jt.build_optimizer("sgd", variables["params"])
        step = jt.make_train_step(apply, loss_fn, tx, donate=False,
                                  batch_transform=jt.make_classification_mix(K, **kw),
                                  transform_seed=seed)
        jstate = jt.TrainState.create(variables, tx)
        metrics, wants = [], []
        for i in range(2):
            jstate, m = step(jstate, {k: v[i] for k, v in batches.items()}, 1e-2)
            metrics.append({k: float(v) for k, v in m.items()})
            wants.append(resnet_state_dict_from_jax(jax.device_get(jstate.variables())))
    yield {"metrics": metrics, "wants": wants, "start": start}


def _write_data(workdir):
    root = os.path.join(workdir, "data")
    write_detection_dataset(os.path.join(root, "det"), 9, sizes=((48, 64), (64, 48), (40, 40)),
                            num_classes=C, max_objects=3)
    write_classification_dataset(os.path.join(root, "cls"), 9, num_classes=4,
                                 sizes=((40, 48), (32, 32)))
    write_video_dataset(os.path.join(root, "video"), (5, 4), num_classes=4, frames=8,
                        hw=(24, 32))
    return root


@pytest.fixture(scope="module")
def runs():
    # a directory of its own, removed at the end: the ranks' files hold
    # YOLOv3 states of a few hundred MB
    with tempfile.TemporaryDirectory() as workdir:
        jax_side = {"yolo": _yolo_jax(workdir), "cls": _cls_jax(workdir)}
        _both(jax_side)  # the ranks' inputs
        root = _write_data(workdir)
        collect = spawn_ranks("dp", workdir)
        want = _both(jax_side)  # the JAX steps, while the ranks run
        yield {"ranks": collect(), "root": root, "workdir": workdir, **want}


def _both(gens: dict) -> dict:
    """The next value of each generator, on threads of their own (XLA
    compiles the two programs side by side)."""
    out = {}
    threads = [threading.Thread(target=lambda k=k, g=g: out.__setitem__(k, next(g)))
               for k, g in gens.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(out) == len(gens), "a JAX side failed (its traceback is above)"
    return out


@pytest.mark.parametrize("spec", [None, "", "auto", "1/4", (2, 3), "half", (4, 4), "-1/2"])
def test_resolve_host_shard_matches_jax(spec):
    try:
        want = jd.resolve_host_shard(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(",")[0][:20]):
            resolve_host_shard(spec)
        return
    assert resolve_host_shard(spec) == want


@pytest.mark.parametrize("n,count", [(11, 3), (11, 1), (8, 2), (3, 4)])
def test_host_shard_order_matches_jax(n, count):
    order = np.random.default_rng(0).permutation(n)
    for i in range(count):
        got, want = host_shard_order(order, i, count), jd.host_shard_order(order, i, count)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_global_batchnorm_matches_one_process(runs):
    for out in runs["ranks"]:
        full, local = out["bn_full"], out["bn_local"]
        s = slice(*out["bn_slice"])
        for k in ("y", "dx"):
            torch.testing.assert_close(local[k], full[k][s], rtol=0, atol=1e-10)
        for k in ("dw", "db", "running_mean", "running_var"):
            torch.testing.assert_close(local[k], full[k], rtol=0, atol=1e-10)


def _check_state(got, want, start, rel=1e-6, moved_rel=1e-5):
    for k, w in want.items():
        if w.numel() == 1:
            continue
        w = w.double()
        d = float((got[k].double() - w).abs().max())
        moved = float((w - start[k].double()).abs().max())
        rounding = 4 * 2.0 ** -24 * float(w.abs().max())  # the JAX side's float32 storage
        assert d <= max(rel * float(w.std()), moved_rel * moved, rounding), (k, d, moved)


def test_yolo_accum_steps_2_matches_jax_global_batch(runs):
    want = runs["yolo"]
    r0, r1 = (o["yolo"] for o in runs["ranks"])
    assert r0["positives"] == [10, 10] and r1["positives"] == [2, 2]  # uneven
    for i, (got, jm) in enumerate(zip(r0["metrics"], want["metrics"])):
        for k in ("loss", "box", "obj", "cls"):
            assert got[k] == pytest.approx(jm[k], rel=1e-6), (i, k)
    assert r0["metrics"][1]["grad_norm"] == pytest.approx(want["metrics"][1]["grad_norm"],
                                                         rel=1e-5)
    # the first call skips DDP's all-reduce: its gradient norm is not measured
    assert np.isnan(r0["metrics"][0]["grad_norm"])
    assert r0["metrics"][1] == r1["metrics"][1]
    _check_state(r0["state"], want["want"], want["start"])
    for k, v in r0["state"].items():
        assert same(v, r1["state"][k]), k  # the ranks stay bit-equal


def test_yolo_microbatches_match_jax_global_batch(runs):
    """``make_train_step(accum_steps=2)`` over 2 ranks: microbatch i is the
    global batch's i-th half (images 0-1 with 10 positives, then 2-3 with
    2), each rank holding one image of it, as the JAX step splits it."""
    want = runs["yolo"]
    r0, r1 = (o["yolo_micro"] for o in runs["ranks"])
    for k in ("loss", "box", "obj", "cls"):
        assert r0["metrics"][k] == pytest.approx(want["micro"]["metrics"][k], rel=1e-6), k
    assert r0["metrics"]["grad_norm"] == pytest.approx(want["micro"]["metrics"]["grad_norm"],
                                                      rel=1e-5)
    assert r0["metrics"] == r1["metrics"]
    _check_state(r0["state"], want["micro"]["want"], want["start"])
    for k, v in r0["state"].items():
        assert same(v, r1["state"][k]), k


def test_preemption_on_one_rank_stops_every_rank(runs):
    """A request on rank 1 after the epoch's last agreement: both ranks
    stop at the epoch's end (3 steps, epoch 1 not run), and one
    preemption checkpoint is written, before any validation."""
    for out in runs["ranks"]:
        assert out["preempt"] == {"interrupted": True, "global_step": 3}
    ckpt = CheckpointManager(os.path.join(runs["workdir"], "preempt_ckpt"))
    assert ckpt.all_steps() == [0]
    meta = ckpt.restore(0)["meta"]
    assert meta["preempted"] is True and meta["epoch_batches_done"] == 3
    assert "ranks" not in meta


def test_classifier_mix_step_matches_jax_global_batch(runs):
    want = runs["cls"]
    r0, r1 = (o["cls"] for o in runs["ranks"])
    for got, jm in zip(r0["metrics"], want["metrics"]):
        assert got["loss"] == pytest.approx(jm["loss"], rel=1e-6)
        assert got["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-5)
    for got, w in zip(r0["states"], want["wants"]):
        _check_state(got, w, want["start"])
    assert r0["buffers_equal"] and r1["buffers_equal"]
    assert all(same(v, r1["states"][-1][k]) for k, v in r0["states"][-1].items())


def _single_loaders(root):
    return {
        "det": DetectionLoader(
            DetectionDataset(os.path.join(root, "det"), "train"), 64, 4, 8, train=True,
            augmentation=Augmentation([HorizontalFlip(p=0.5), HSVJitter(p=0.5)]),
            mosaic_prob=0.5, seed=3),
        "cls": ClassificationLoader(
            ClassificationDataset(os.path.join(root, "cls"), "train"), 32, 4,
            augmentation=Augmentation([HorizontalFlip(p=0.5)]), seed=3),
        "video": VideoClipLoader(VideoFolderDataset(os.path.join(root, "video"), "train"),
                                 num_frames=4, size=16, batch_size=2, seed=3),
    }


@pytest.mark.parametrize("name", ["det", "cls", "video"])
def test_host_sharded_epochs_union_is_the_single_epoch(runs, name):
    loader = _single_loaders(runs["root"])[name]
    world = len(runs["ranks"])
    for e in (0, 1):
        full = list(loader.epoch(e))
        for key in ("images", "labels"):
            want = np.concatenate([b[key] for b in full])
            parts = [np.concatenate([b[key] for b in out["loaders"][name]["epochs"][e]])
                     for out in runs["ranks"]]
            n = sum(len(p) for p in parts)
            assert n == len(want) - len(want) % world
            for r, part in enumerate(parts):
                np.testing.assert_array_equal(part, want[r:n:world])
    for r, out in enumerate(runs["ranks"]):
        assert out["loaders"][name]["host"] == (r, world)
        assert out["loaders"][name]["len"] == len(loader)  # global batch = world x local


@pytest.mark.parametrize("name", ["det", "cls", "video"])
def test_evaluators_agree_across_ranks_and_with_one_process(runs, name):
    results = [out["evaluators"][name] for out in runs["ranks"]]
    for res in results:
        assert res["mesh"] == res["alone"]
    assert results[0]["mesh"] == results[1]["mesh"]
    if name == "det":
        assert results[0]["mesh"]["map50"] >= 0.0
    else:
        assert 0.0 <= results[0]["mesh"]["accuracy"] <= 1.0


def test_multihost_without_a_coordinator_fails_loudly(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo, "RANK": "1", "WORLD_SIZE": "2",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "LOCAL_RANK": "1"}
    code = ("import fastvision_tpu_torch.core.distributed as d; d.DEFAULT_TIMEOUT_S = 3\n"
            "from fastvision_tpu_torch import cli; cli.main(['train-cls', 'multihost=true', "
            f"'data.data_root={tmp_path}', '--device', 'cpu'])")
    p = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert "Error" in p.stderr and "Traceback" in p.stderr


def test_mesh_and_prefetch_without_a_group():
    from fastvision_tpu_torch.core import Mesh, create_mesh, local_batch_size, shard_batch
    from fastvision_tpu_torch.data import prefetch_to_device

    assert create_mesh() == Mesh(1) and create_mesh(0) == Mesh(1)
    with pytest.raises(ValueError, match="mesh 2x1x1 != 1 processes"):
        create_mesh(2)
    for kw, shape in ((dict(model=2), "0x2x1"), (dict(time=2), "0x1x2")):
        with pytest.raises(ValueError, match=f"mesh {shape} != 1 processes"):
            create_mesh(**kw)  # the model and time axes too must cover the world
    batch = {"images": np.zeros((4, 2, 2, 3), np.uint8), "num_real": 4}
    assert shard_batch(batch, Mesh(1)) is batch
    assert shard_batch(batch, Mesh(2), per_host=True) is batch
    assert local_batch_size(8, Mesh(4)) == 2
    with pytest.raises(ValueError, match="not divisible"):
        local_batch_size(10, Mesh(4))
    # per_host batches are slices of a mesh's global batch: no mesh, no meaning
    with pytest.raises(ValueError, match="per_host"):
        next(prefetch_to_device(iter([batch]), device="cpu", per_host=True))
    got = next(prefetch_to_device(iter([batch]), device="cpu", mesh=Mesh(1)))
    assert got["images"].shape == (4, 2, 2, 3) and got["num_real"] == 4
