"""Port's train and eval steps vs the JAX package's on the CPU in float32: a
shallow YOLOv3 (stage_sizes (1, 1, 1, 1, 1), 3 classes, 128 px, batch 4)
from the same JAX-initialised variables, 3 steps with a changing lr.

Tolerances, and why. Both packages' float32 gradients are ~5e-5 of the
largest gradient away from a float64 run of the port: train-mode BN over
few values per channel (4 x 4 x 4 at the deepest level) amplifies rounding
through the backward. So:
  - loss per step: rtol 1e-5 (the forward is not amplified);
  - grad_norm per step: rtol 2e-4;
  - SGD, final params and BN statistics, per tensor: max|d| <= 1e-4 * std
    of the tensor, or, for tensors that start as constants (BN scale and
    shift, running statistics) and whose std is made by the updates alone,
    max|d| <= 2e-3 * the largest update of the tensor (measured: 4e-4);
  - Adam divides each gradient by its own RMS, so an element whose gradient
    is below the rounding floor moves by a full step either way: at most
    0.1% of the elements may differ by more than 1e-4 * std, and the
    difference's norm must stay below 2% of the update's norm, per tensor.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvision_tpu.train as jt
import fastvision_tpu_torch.train as tt
from fastvision_tpu.data import normalize_images as jax_normalize
from fastvision_tpu.infer.decode import decode_predictions as jax_decode
from fastvision_tpu.models.classification.darknet53 import Darknet53 as JaxDarknet53
from fastvision_tpu.models.detection import YOLOv3 as JaxYOLOv3
from fastvision_tpu.ops.nms import batched_non_max_suppression as jax_bnms
from fastvision_tpu_torch.infer import decode_predictions
from fastvision_tpu_torch.models import YOLOv3, yolov3_state_dict_from_jax
from fastvision_tpu_torch.ops import batched_non_max_suppression

torch.set_num_threads(2)
C, S, B = 3, 128, 4
ANCHORS = np.array([[[116, 90], [156, 198], [373, 326]],
                    [[30, 61], [62, 45], [59, 119]],
                    [[10, 13], [16, 30], [33, 23]]], np.float32) / 2


class _ShallowJaxDarknet(JaxDarknet53):
    stage_sizes = (1, 1, 1, 1, 1)


JAX_MODEL = JaxYOLOv3(num_classes=C,
                      backbone_fn=lambda **kw: _ShallowJaxDarknet(including_top=False, **kw))


@pytest.fixture(scope="module")
def variables():
    init = jax.jit(lambda key, x: JAX_MODEL.init(key, x, train=True))  # one compile
    return jax.device_get(init(jax.random.key(0), jnp.zeros((2, S, S, 3))))


def _batch(seed, b=B):
    rng = np.random.default_rng(seed)
    lab = np.full((b, 6, 5), -1, np.float32)
    lab[:, :3, 0] = rng.integers(0, C, (b, 3))
    lab[:, :3, 1:3] = rng.uniform(0.2, 0.8, (b, 3, 2))
    lab[:, :3, 3:5] = rng.uniform(0.1, 0.5, (b, 3, 2))
    return {"images": rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8), "labels": lab,
            "num_real": b, "meta": [{}] * b}


def _jax_apply(v, images, **kw):
    return JAX_MODEL.apply(v, jax_normalize(images), **kw)


_jax_loss_obj = jt.YOLOv3Loss(ANCHORS, num_classes=C)
_port_loss_obj = tt.YOLOv3Loss(ANCHORS, num_classes=C)


def _jax_loss(heads, batch):
    out = _jax_loss_obj(heads, batch["labels"])
    return out.total, {"box": out.box}


def _port_loss(heads, batch):
    out = _port_loss_obj(heads, batch["labels"])
    return out.total, {"box": out.box}


def _port_model(variables):
    m = YOLOv3(num_classes=C, stage_sizes=(1, 1, 1, 1, 1))
    m.load_state_dict(yolov3_state_dict_from_jax(variables))
    return m


def _run_both(variables, opt_name, lrs=(1e-2, 5e-3, 2e-3), step_kw=None):
    step_kw = step_kw or {}
    tx = jt.build_optimizer(opt_name, variables["params"])
    jstate = jt.TrainState.create(variables, tx)
    jstep = jt.make_train_step(_jax_apply, _jax_loss, tx, donate=False, **step_kw)
    model = _port_model(variables)
    state = tt.TrainState.create(model, tt.build_optimizer(opt_name, model), "cpu")
    step = tt.make_train_step(_port_loss, **step_kw)
    per_step = []
    for i, lr in enumerate(lrs):
        batch = _batch(i)
        jstate, jm = jstep(jstate, {k: batch[k] for k in ("images", "labels")}, lr)
        state, m = step(state, {**batch, "images": torch.from_numpy(batch["images"]),
                                "labels": torch.from_numpy(batch["labels"])}, lr)
        per_step.append((float(m["loss"]), float(jm["loss"]), float(m["grad_norm"]),
                         float(jm["grad_norm"])))
    assert state.step == len(lrs)
    want = yolov3_state_dict_from_jax(jax.device_get(jstate.variables()))
    return per_step, model.state_dict(), want


def _check_steps(per_step):
    for loss, jloss, gn, jgn in per_step:
        assert loss == pytest.approx(jloss, rel=1e-5)
        assert gn == pytest.approx(jgn, rel=2e-4)


def _check_sgd_state(got, want, start):
    for k, w in want.items():
        if w.numel() == 1:
            continue
        d = float((got[k].float() - w).abs().max())
        moved = float((w - start[k]).abs().max())
        assert d <= 1e-4 * float(w.std()) or d <= 2e-3 * moved, (k, d, float(w.std()), moved)


def test_sgd_steps_match_jax(variables):
    per_step, got, want = _run_both(variables, "sgd")
    _check_steps(per_step)
    _check_sgd_state(got, want, yolov3_state_dict_from_jax(variables))


def test_adam_steps_match_jax(variables):
    per_step, got, want = _run_both(variables, "adam", lrs=(1e-4, 5e-5, 2e-5))
    _check_steps(per_step)
    start = yolov3_state_dict_from_jax(variables)
    for k, w in want.items():
        if w.numel() == 1:
            continue
        d = (got[k].float() - w).abs()
        if w.ndim > 1:
            assert float((d > 1e-4 * w.std()).float().mean()) <= 1e-3, k
        update = float((w - start[k]).norm())
        assert float(d.norm()) <= 2e-2 * update or float(d.max()) <= 1e-4 * float(w.std()), k


@pytest.mark.parametrize("step_kw", [{"accum_steps": 2}, {"remat": True}],
                         ids=["accum_steps_2", "remat"])
def test_step_options_match_jax(variables, step_kw):
    per_step, got, want = _run_both(variables, "sgd", lrs=(1e-2, 5e-3), step_kw=step_kw)
    _check_steps(per_step)
    _check_sgd_state(got, want, yolov3_state_dict_from_jax(variables))


def test_remat_equals_no_remat_and_moves_bn_once(variables):
    """The recompute's BN update is undone: remat gives the plain step's
    parameters and statistics."""
    batch = _batch(0)
    batch = {"images": torch.from_numpy(batch["images"]), "labels": torch.from_numpy(batch["labels"])}
    states = []
    for remat in (False, True):
        model = _port_model(variables)
        st = tt.TrainState.create(model, tt.build_optimizer("sgd", model), "cpu")
        tt.make_train_step(_port_loss, remat=remat)(st, batch, 1e-2)
        states.append(model.state_dict())
    for k in states[0]:
        torch.testing.assert_close(states[1][k], states[0][k], rtol=1e-5, atol=1e-6)


def test_eval_step_matches_jax_and_restores_mode(variables):
    batch = _batch(9, b=2)
    anchors = torch.from_numpy(ANCHORS)

    def post(heads, _):
        return batched_non_max_suppression(decode_predictions(heads, anchors).float(),
                                           conf_thres=0.3, max_det=20)

    def jpost(heads, _):
        return jax_bnms(jax_decode(heads, jnp.asarray(ANCHORS), (32, 16, 8), "v5"),
                        conf_thres=0.3, max_det=20)

    want = jt.make_eval_step(_jax_apply, jpost)(
        jt.TrainState.create(variables, jt.build_optimizer("sgd", variables["params"])),
        {"images": batch["images"]})
    model = _port_model(variables).train()
    state = tt.TrainState.create(model, tt.build_optimizer("sgd", model), "cpu")
    got = tt.make_eval_step(post)(state, {"images": torch.from_numpy(batch["images"])})
    assert model.training
    assert int(got.valid.sum()) > 0
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4, atol=1e-6)


def test_step_api_details(variables):
    model = _port_model(variables)
    state = tt.TrainState.create(model, tt.build_optimizer("sgd", model), "cpu")
    assert state.device == torch.device("cpu") and state.step == 0
    assert model.backbone.conv0.conv.weight.is_contiguous(memory_format=torch.channels_last)
    batch = _batch(1, b=3)
    kept = tt.device_batch({**batch, "images": torch.from_numpy(batch["images"]),
                            "labels": torch.from_numpy(batch["labels"])})
    assert set(kept) == {"images", "labels"}
    _, metrics = tt.make_train_step(_port_loss, with_grad_norm=False)(state, kept, 1e-3)
    assert "grad_norm" not in metrics and metrics["loss"].ndim == 0
    assert not metrics["loss"].requires_grad
    # batch_transform (ported) gets a numpy Generator seeded from (transform_seed, step)
    seen = []
    tt.make_train_step(_port_loss, transform_seed=7, batch_transform=lambda b, r: (
        seen.append(r.uniform()) or b))(state, kept, 1e-3)
    assert seen == [np.random.default_rng((7, state.step - 1)).uniform()]
    with pytest.raises(ValueError, match="divisible"):
        tt.make_train_step(_port_loss, accum_steps=2)(state, kept, 1e-3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tt.TrainState.create(model, state.optimizer)
