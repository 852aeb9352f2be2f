"""The port's video training path on the CPU: a 3-D model through
``TrainState.create`` and the entry points' placement, one SGD step of a
small SlowFast against the JAX package's, ``video_multiclip_evaluator``'s
windows and accuracy against the JAX package's, ``VideoClassifier``
against the JAX package's, ``model.pretrained`` for video checkpoints,
and ``cli.main(["train-video" | "eval", "--task", "video", ...])`` with a
small model on the config's default worker pools.

Tolerances: the train step in float64 on both sides (a ReLU net with
train-mode BN, see tests/test_torch_cls_train.py): loss rtol 1e-5, gradient
norm rtol 2e-4, the SGD state as in tests/test_torch_train_step.py; the
evaluator's windows (the frames it read) and accuracies equal;
probabilities to 1e-5.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvision_tpu.data as jd
import fastvision_tpu.train as jt
import fastvision_tpu_torch.train as tt
from fastvision_tpu.data import normalize_images as jax_normalize
from fastvision_tpu.infer.predictor import VideoClassifier as JaxVideoClassifier
from fastvision_tpu.models import video as jv
from fastvision_tpu.models.import_torch import apply_import, slowfast_from_reference
from fastvision_tpu_torch import cli
from fastvision_tpu_torch.core.config import Config, apply_overrides
from fastvision_tpu_torch.data import VideoClipLoader, VideoFolderDataset, write_bmp
from fastvision_tpu_torch.infer import Detector, VideoClassifier
from fastvision_tpu_torch.models import slowfast_state_dict_from_jax
from fastvision_tpu_torch.models import video as tv
from fastvision_tpu_torch.testing import write_video_dataset
from test_torch_train_step import _check_sgd_state

torch.set_num_threads(2)
K = 3
SMALL = dict(num_classes=K, alpha=4, beta_inv=4, expansion=1)


def _small_slowfast(seed=0):
    return tv.SlowFast((1, 1, 1, 1), generator=torch.Generator().manual_seed(seed), **SMALL)


def _jax_variables_of(port, x, dtype=jnp.float32):
    """(JAX SlowFast, its variables carrying ``port``'s weights)."""
    jm = jv.SlowFast((1, 1, 1, 1), dtype=dtype, **SMALL)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x[:1]), train=False))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)
    sd = {k: t.numpy() for k, t in port.state_dict().items()}
    return jm, apply_import(zeros, slowfast_from_reference(sd), verbose=False)


# ---------------------------------------------------------------- placement
def test_3d_models_go_through_the_entry_points_placement():
    """``TrainState.create`` and ``Detector`` moved every model into
    ``channels_last``, which torch refuses for a 5-D weight: a 3-D model now
    goes into ``channels_last_3d``, a 2-D one stays in ``channels_last``."""
    model = _small_slowfast()
    state = tt.TrainState.create(model, tt.build_optimizer("sgd", model), "cpu")
    w = state.model.fast_pathway.conv1[0].weight
    assert w.is_contiguous(memory_format=torch.channels_last_3d)
    det = Detector(tv.ResNet3D(tv.BasicBlock3D, (1,), num_classes=K),
                   np.ones((3, 3, 2), np.float32), device="cpu")
    assert det.model.conv1[0].weight.is_contiguous(memory_format=torch.channels_last_3d)
    vc = VideoClassifier(_small_slowfast(), device="cpu")
    assert not vc.model.training
    flat = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3))
    tt.TrainState.create(flat, None, "cpu")
    assert flat[0].weight.is_contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------- train step
def test_train_step_matches_jax_in_float64():
    """One SGD step (momentum 0.9, wd 1e-4) of SlowFast((1, 1, 1, 1),
    alpha=4, beta_inv=4, expansion=1) at 8 x 32 on 4 clips, cross-entropy,
    imagenet-standardized, from the same weights, float64 on both sides
    (the JAX side keeps float32 parameters and optimizer, as in
    tests/test_torch_cls_train.py)."""
    rng = np.random.default_rng(3)
    batch = {"images": rng.integers(0, 256, (4, 8, 32, 32, 3), dtype=np.uint8),
             "labels": rng.integers(0, K, 4).astype(np.int32)}
    port = tv.SlowFast((1, 1, 1, 1), generator=torch.Generator().manual_seed(1), **SMALL)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    with jax.enable_x64(True):
        jm, variables = _jax_variables_of(port, batch["images"], jnp.float64)

        def apply(v, images, **a):
            return jm.apply(v, jax_normalize(images, jnp.float64, imagenet=True), **a)

        def jax_loss(logits, b):
            return jt.cross_entropy(logits, b["labels"]), {}

        tx = jt.build_optimizer("sgd", variables["params"], weight_decay=1e-4, momentum=0.9)
        jstate, jmet = jt.make_train_step(apply, jax_loss, tx, donate=False)(
            jt.TrainState.create(variables, tx), batch, 1e-2)
        want = slowfast_state_dict_from_jax(jax.device_get(jstate.variables()))
        loss, grad_norm = float(jmet["loss"]), float(jmet["grad_norm"])

    def port_loss(logits, b):
        return tt.cross_entropy(logits, b["labels"]), {}

    state = tt.TrainState.create(port.double(), tt.build_optimizer(
        "sgd", port, weight_decay=1e-4, momentum=0.9), "cpu")
    step = tt.make_train_step(port_loss, torch.float64, imagenet=True)
    state, met = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, 1e-2)
    assert float(met["loss"]) == pytest.approx(loss, rel=1e-5)
    assert float(met["grad_norm"]) == pytest.approx(grad_norm, rel=2e-4)
    _check_sgd_state(port.state_dict(), want, start)


# ---------------------------------------------------------------- evaluator
@pytest.fixture(scope="module")
def frame_coded(tmp_path_factory):
    """Two classes of two frame-directory clips (12 and 5 frames), every
    pixel of frame t of clip i of class c equal to 20 t + 2 c + i: the
    frames a fake eval step sees name the windows the evaluator read."""
    root = tmp_path_factory.mktemp("coded")
    for c, name in enumerate(("a", "b")):
        for i, n in enumerate((12, 5)):
            d = root / "val" / name / f"clip{i}"
            os.makedirs(d)
            for t in range(n):
                write_bmp(str(d / f"f{t:02d}.bmp"), np.full((16, 16, 3), 20 * t + 2 * c + i,
                                                            np.uint8))
    return str(root)


def test_multiclip_evaluator_reads_jax_windows(frame_coded):
    seen = {"jax": [], "port": []}

    def fake_step(tag):
        def step(state, batch):
            images = np.asarray(batch["images"].cpu() if tag == "port" else batch["images"])
            seen[tag].extend(images[:, :, 0, 0, 0].tolist())
            code = images[:, 0, 0, 0, 0].astype(np.float32) % 20  # 2 c + i
            logits = np.stack([1.5 - code, code - 1.5], axis=-1)  # c = 1 iff code >= 2
            return torch.from_numpy(logits) if tag == "port" else jnp.asarray(logits)
        return step

    for n_clips in (1, 3, 4):
        seen["jax"].clear()
        seen["port"].clear()
        want = jt.video_multiclip_evaluator(fake_step("jax"), n_clips)(
            None, jd.VideoClipLoader(jd.VideoFolderDataset(frame_coded, "val"), num_frames=4,
                                     size=16, batch_size=3, train=False))
        loader = VideoClipLoader(VideoFolderDataset(frame_coded, "val"), num_frames=4, size=16,
                                 batch_size=3, train=False)
        state = tt.TrainState(torch.nn.Linear(1, 1), None)
        got = tt.video_multiclip_evaluator(fake_step("port"), n_clips)(state, loader)
        assert got == want and got["accuracy"] == 1.0
        assert seen["port"] == seen["jax"]  # the same windows, padding included
        assert len(seen["port"]) == 3 * -(-4 * n_clips // 3)
    assert [list(w) for w in tt.multiclip_windows(12, 4, 3)] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                                                [8, 9, 10, 11]]
    assert [list(w) for w in tt.multiclip_windows(3, 4, 2)] == [[0, 1, 2, 2]] * 2
    loader = VideoClipLoader(VideoFolderDataset(frame_coded, "val"), num_frames=4, size=16,
                             batch_size=3, train=False, num_workers=2, worker_backend="process")
    try:  # on the loader's process pool: the same result
        assert tt.video_multiclip_evaluator(fake_step("port"), 4)(state, loader) == want
    finally:
        loader.close()


def test_video_classifier_matches_jax():
    port = _small_slowfast(4).eval()
    clip = np.random.default_rng(5).integers(0, 256, (8, 32, 32, 3), np.uint8)
    jm, variables = _jax_variables_of(port, clip[None])
    want = JaxVideoClassifier(jm, variables, num_frames=8, size=32, class_names=["x", "y", "z"],
                              dtype=jnp.float32).predict_clip(clip)
    got = VideoClassifier(port, num_frames=8, size=32, class_names=["x", "y", "z"],
                          dtype=torch.float32, device="cpu").predict_clip(clip)
    assert got["class"] == want["class"]
    np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-5)
    assert got["probs"].dtype == np.float32


# ---------------------------------------------------------------- CLI
def _small_zoo_model(cfg, task="cls"):
    assert task == "video"
    return tv.SlowFast((1, 1, 1, 1), generator=torch.Generator().manual_seed(cfg.train.seed),
                       **{**SMALL, "num_classes": cfg.model.num_classes})


def test_pretrained_video_checkpoints(tmp_path):
    cfg = apply_overrides(Config(), ["model.backbone=c3d_bn", "model.num_classes=5",
                                     f"model.pretrained={tmp_path / 'w.pt'}"])
    src = _small_slowfast(7)
    torch.save(src.state_dict(), tmp_path / "w.pt")
    model = _small_slowfast(8)
    cli._maybe_import_pretrained(cfg, model, task="video")
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  src.state_dict().values()))
    torch.save({"conv1.weight": torch.zeros(4, 3, 3, 3)}, tmp_path / "w.pt")
    with pytest.raises(ValueError, match="video checkpoint naming"):
        cli._maybe_import_pretrained(cfg, model, task="video")


def test_cli_train_video_resume_and_eval_on_default_pools(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(cli, "_build_zoo_model", _small_zoo_model)
    root = write_video_dataset(str(tmp_path / "ds"), (6, 4), num_classes=K, frames=10,
                               hw=(20, 24), seed=2)
    ckpt = str(tmp_path / "ck")
    common = [f"data.data_root={root}", f"model.num_classes={K}", "data.input_size=32",
              "data.num_frames=8", "data.batch_size=2", "data.eval_clips=2",
              f"train.ckpt_dir={ckpt}", "--device", "cpu"]
    fit = cli.main(["train-video", "train.epochs=1", "train.lr=1e-2", *common])
    assert fit.global_step == 3 and not fit.interrupted
    loaders = (fit.train_loader, fit.val_loader)
    assert all(ld.num_workers == 4 and ld.worker_backend == "process" for ld in loaders)
    assert all(ld._decode_pool is None for ld in loaders)  # stopped at the end
    fit = cli.main(["train-video", "--resume", "train.epochs=2", "train.lr=1e-2", *common])
    assert fit.start_epoch == 1 and fit.global_step == 6
    with open(os.path.join(ckpt, "train.jsonl")) as f:
        last = [r for r in map(json.loads, f) if "accuracy" in r][-1]
    assert last["n_clips"] == 2
    res = cli.main(["eval", "--task", "video", "--ckpt", ckpt, *common])
    assert res["accuracy"] == last["accuracy"] and res["n_clips"] == 2  # same weights, evaluator
    assert "2-clip protocol" in capsys.readouterr().out and res["clip_per_sec"] > 0
    with pytest.raises(SystemExit, match="needs --ckpt"):
        cli.main(["eval", "--task", "video", *common])
    with pytest.raises(ValueError, match="mesh 0x1x2 != 1 processes"):
        cli.main(["train-video", "mesh_time=2", *common])  # ported: two ranks needed
    monkeypatch.undo()
    with pytest.raises(SystemExit, match="unknown video model"):
        cli.main(["train-video", "model.backbone=slowfast_resnet9", *common])
