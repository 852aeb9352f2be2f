"""The port's time sharding on the CPU: two gloo ranks on the time axis
(tests/torch_dist_worker.py scenario ``time2``, started once for the
module) against the JAX package.

  - `time_sharded_conv` on tests/test_time_shard.py's case (2 x 32 x 4 x 4 x
    3, kernel [0.25, 0.5, 0.25], halo 1) equals the JAX package's
    `time_sharded_conv` (over an 8-device time mesh, as its test runs it)
    and the unsharded conv, float64, to 1e-12; the gradient of a weighted
    sum of its output with respect to the clip (the ranks' gradients summed:
    each holds its frames' and its halos' owners got theirs) equals
    ``jax.grad`` of the same;
  - one SGD step (momentum 0.9, weight decay 1e-4) of a SlowFast((1, 1, 1,
    1), alpha 4, beta_inv 4, expansion 1) on 2 clips of 8 x 32 x 32, its
    frames split over the two ranks, equals the JAX package's unsharded
    step, float64 (loss rtol 1e-6; each tensor within 1e-6 of its std, or
    1e-5 of the update for tensors that start constant; BN statistics
    over both ranks' frames, equal on both); the ranks end bit-equal;
  - the float32 eval forward of the sharded model is within the JAX test's
    own bound of the JAX unsharded forward (rtol 2e-4, atol 2e-5);
  - a clip whose frames do not split into multiples of alpha per rank
    raises, naming the numbers;
  - ``train-video ... mesh_time=2`` runs end to end and its checkpoint
    loads into one unsharded process, which scores it as the ranks did;
    ``mesh_time=2`` with a backbone without ``time_axis`` exits with the
    JAX package's message.
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
from fastvision_tpu.core.mesh import create_mesh as jax_create_mesh
from fastvision_tpu.data import normalize_images as jax_normalize
from fastvision_tpu.models import video as jv
from fastvision_tpu.models.import_torch import apply_import, slowfast_from_reference
from fastvision_tpu.parallel import time_sharded_conv as jax_time_sharded_conv
from fastvision_tpu_torch.models import slowfast_state_dict_from_jax
from fastvision_tpu_torch.models import video as tv
from fastvision_tpu_torch.testing import write_video_dataset
from test_torch_distributed import _check_state
from torch_dist_worker import _temporal_conv_valid, same, spawn_ranks

torch.set_num_threads(2)
KW = dict(alpha=4, beta_inv=4, expansion=1, num_classes=5)
KERNEL = np.array([0.25, 0.5, 0.25])


def _jax_conv_valid(x, kernel):
    k = kernel.shape[0]
    return sum(x[:, i:x.shape[1] - (k - 1 - i)] * kernel[i] for i in range(k))


def _jax_slowfast(port, x, dtype):
    jm = jv.SlowFast((1, 1, 1, 1), dtype=dtype, **KW)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x[:1]), train=False))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)
    sd = {k: t.numpy() for k, t in port.state_dict().items()}
    return jm, apply_import(zeros, slowfast_from_reference(sd), verbose=False)


def _jax_side(conv, batch, port) -> dict:
    """The JAX results the ranks are held to: the conv case (global and
    time-sharded) and its gradient, the unsharded float64 step and the
    float32 eval forward."""
    clip, cot = conv["clip"].numpy(), conv["cotangent"].numpy()
    with jax.enable_x64(True):
        kernel = jnp.asarray(KERNEL)

        def global_conv(x):
            return _jax_conv_valid(jnp.pad(x, ((0, 0), (1, 1), (0, 0), (0, 0), (0, 0))), kernel)

        res = {"conv": np.asarray(global_conv(jnp.asarray(clip))),
               "conv_grad": np.asarray(jax.grad(lambda x: (global_conv(x) * cot).sum())(
                   jnp.asarray(clip)))}
        mesh = jax_create_mesh(data=1, model=1, time=8)
        with mesh:
            res["conv_sharded"] = np.asarray(jax_time_sharded_conv(
                lambda x: _jax_conv_valid(x, kernel), jnp.asarray(clip), mesh, halo=1))
        jm, variables = _jax_slowfast(port, batch["images"], jnp.float64)

        def apply(v, images, **a):
            return jm.apply(v, jax_normalize(images, jnp.float64, imagenet=True), **a)

        def loss_fn(logits, b):
            return jt.cross_entropy(logits, b["labels"]), {}

        tx = jt.build_optimizer("sgd", variables["params"], weight_decay=1e-4, momentum=0.9)
        jstate, m = jt.make_train_step(apply, loss_fn, tx, donate=False)(
            jt.TrainState.create(variables, tx), batch, 1e-2)
        res["step"] = {"want": slowfast_state_dict_from_jax(jax.device_get(jstate.variables())),
                       "metrics": {k: float(v) for k, v in m.items()}}
    jm, variables = _jax_slowfast(port, batch["images"], jnp.float32)
    res["eval32"] = np.asarray(jm.apply(variables, jax_normalize(
        batch["images"], jnp.float32, imagenet=True), train=False))
    return res


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    conv = {"clip": torch.from_numpy(rng.normal(0, 1, (2, 32, 4, 4, 3))),
            "kernel": KERNEL.tolist(),
            "cotangent": torch.from_numpy(rng.normal(0, 1, (2, 32, 4, 4, 3)))}
    batch = {"images": rng.integers(0, 256, (2, 8, 32, 32, 3), dtype=np.uint8),
             "labels": np.array([1, 3], np.int32)}
    port = tv.SlowFast((1, 1, 1, 1), generator=torch.Generator().manual_seed(1), **KW)
    with tempfile.TemporaryDirectory() as workdir:
        torch.save(conv, os.path.join(workdir, "time_conv_inputs.pt"))
        torch.save({"state": port.state_dict(), "batch": batch, "kw": KW},
                   os.path.join(workdir, "time_inputs.pt"))
        write_video_dataset(os.path.join(workdir, "data", "video"), (4, 4), num_classes=4,
                            frames=10, hw=(24, 32), seed=2)
        collect = spawn_ranks("time2", workdir)
        want = {}
        side = threading.Thread(target=lambda: want.update(_jax_side(conv, batch, port)))
        side.start()  # while the ranks run
        ranks = collect()
        side.join()
        assert want, "the JAX side failed (its traceback is above)"
        yield {"ranks": ranks, "conv": conv, "port": port, "workdir": workdir, "jax": want}


def test_time_sharded_conv_matches_jax(runs):
    want, grad = runs["jax"]["conv"], runs["jax"]["conv_grad"]
    np.testing.assert_allclose(runs["jax"]["conv_sharded"], want, rtol=0, atol=1e-12)
    outs = [o["time_conv"] for o in runs["ranks"]]
    for o in outs:
        np.testing.assert_allclose(o["y"].numpy(), want, rtol=0, atol=1e-12)
    # each rank's clip gradient: its own frames (zeros elsewhere)
    assert not outs[0]["grad"][:, 16:].any() and not outs[1]["grad"][:, :16].any()
    np.testing.assert_allclose((outs[0]["grad"] + outs[1]["grad"]).numpy(), grad,
                               rtol=0, atol=1e-12)
    y = _temporal_conv_valid(torch.nn.functional.pad(runs["conv"]["clip"].movedim(1, -1),
                                                     (1, 1)).movedim(-1, 1), KERNEL)
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-12)


def test_time_sharded_slowfast_step_matches_jax(runs):
    start = runs["port"].state_dict()
    want, metrics = runs["jax"]["step"]["want"], runs["jax"]["step"]["metrics"]
    r0, r1 = (o["time_slowfast"] for o in runs["ranks"])
    assert r0["metrics"]["loss"] == pytest.approx(metrics["loss"], rel=1e-6)
    assert r0["metrics"]["grad_norm"] == pytest.approx(metrics["grad_norm"], rel=1e-6)
    assert r0["metrics"] == r1["metrics"]
    _check_state(r0["state"], want, start)
    for k, v in r0["state"].items():
        assert same(v, r1["state"][k]), k
    assert r0["buffers_equal"] and r1["buffers_equal"]


def test_time_sharded_eval_forward_matches_jax(runs):
    for o in runs["ranks"]:
        np.testing.assert_allclose(o["time_slowfast"]["eval32"].numpy(), runs["jax"]["eval32"],
                                   rtol=2e-4, atol=2e-5)


def test_uneven_clip_is_refused(runs):
    for o in runs["ranks"]:
        assert o["time_slowfast"]["uneven"] == (
            "time sharding: a clip of 6 frames does not split into 2 parts of a multiple of "
            "alpha=4 frames (T must be a multiple of mesh_time * alpha = 8)")
    with pytest.raises(ValueError, match="multiple of mesh_time \\* alpha = 4"):
        tv.SlowFast((1, 1, 1, 1), time_axis="time", **KW)(torch.zeros(1, 6, 32, 32, 3))


def test_cli_train_video_over_the_time_axis(runs):
    from fastvision_tpu_torch.core import restore_inference_weights
    from fastvision_tpu_torch.data import VideoClipLoader, VideoFolderDataset
    from fastvision_tpu_torch.train import (TrainState, classification_evaluator,
                                            make_eval_step)

    clis = [o["cli"] for o in runs["ranks"]]
    for c in clis:
        assert c["time_axis"] == "time" and c["steps"] == clis[0]["steps"] > 0
        assert c["eval"] == clis[0]["eval"]
        assert c["c3d"] == ("mesh_time=2 needs a time-shardable model (slowfast_*); 'c3d' has "
                            "no time_axis")
    assert any(np.isfinite(r.get("train_loss", np.nan)) for r in clis[0]["records"])
    model = tv.SlowFast((1, 1, 1, 1), **{**KW, "num_classes": 4})
    restore_inference_weights(os.path.join(runs["workdir"], "cli_time_ckpt"), model)
    loader = VideoClipLoader(VideoFolderDataset(os.path.join(runs["workdir"], "data", "video"),
                                                "val"), num_frames=8, size=32, batch_size=2,
                             train=False)
    res = classification_evaluator(make_eval_step(imagenet=True))(
        TrainState.create(model, None, "cpu"), loader)
    loader.close()
    assert res["accuracy"] == clis[0]["eval"]
