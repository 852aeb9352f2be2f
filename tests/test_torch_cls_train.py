"""The port's classification training path on the CPU: the mix transform,
a train step with it, ``Accuracy`` and ``classification_evaluator`` against
the JAX package's; ``Fit``'s rng-taking ``step_fn`` and its best slot; and
``cli.main(["train-cls" | "eval", "--task", "cls", ...])`` with a small
model, on the config's default worker pools.

The mix's draws come from a numpy Generator in the port and from JAX keys
in the JAX package: the tests feed the JAX package's draws to the port
(`MixDraws`). Tolerances: mixed images and targets equal to float32
rounding (1e-6 of the targets, 1e-4 of a pixel); the train step's loss
rtol 1e-5, its gradient norm rtol 2e-4 and the SGD state as in
tests/test_torch_train_step.py (float32 BN-train rounding, see there);
accuracies equal.
"""
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvision_tpu.train as jt
import fastvision_tpu_torch.train as tt
from fastvision_tpu.data import normalize_images as jax_normalize
from fastvision_tpu.models import classification as jz
from fastvision_tpu_torch import cli
from fastvision_tpu_torch.core import step_seed
from fastvision_tpu_torch.data import ClassificationLoader
from fastvision_tpu_torch.models import classification as tz
from fastvision_tpu_torch.models import resnet_state_dict_from_jax
from fastvision_tpu_torch.ops import Accuracy, accuracy
from fastvision_tpu_torch.testing import write_classification_dataset
from test_torch_train_step import _check_sgd_state

torch.set_num_threads(2)
jax_accuracy = importlib.import_module("fastvision_tpu.ops.accuracy")  # the function shadows it
K, S, B = 10, 64, 4


def _jax_draws(seed, step, mixup_alpha, cutmix_alpha, switch_prob=0.5):
    """The draws of the JAX package's make_classification_mix at ``step``."""
    key = jax.random.fold_in(jax.random.key(seed), step)
    k_switch, k_mix = jax.random.split(key)
    if mixup_alpha > 0 and cutmix_alpha > 0:
        use_mixup = bool(jax.random.bernoulli(k_switch, switch_prob))
    else:
        use_mixup = mixup_alpha > 0
    if use_mixup:
        return tt.MixDraws(True, float(jax.random.beta(k_mix, mixup_alpha, mixup_alpha)))
    k_lam, k_cy, k_cx = jax.random.split(k_mix, 3)
    return tt.MixDraws(False, float(jax.random.beta(k_lam, cutmix_alpha, cutmix_alpha)),
                       float(jax.random.uniform(k_cy)), float(jax.random.uniform(k_cx)))


def _batch(seed, b=B, size=S):
    rng = np.random.default_rng(seed)
    return {"images": rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8),
            "labels": rng.integers(0, K, b).astype(np.int32)}


@pytest.mark.parametrize("alphas", [(0.2, 1.0), (0.2, 0.0), (0.0, 1.0), (0.0, 0.0)],
                         ids=["both", "mixup", "cutmix", "smoothing_only"])
def test_mix_matches_jax_with_its_draws(alphas):
    mixup_alpha, cutmix_alpha = alphas
    kw = dict(mixup_alpha=mixup_alpha, cutmix_alpha=cutmix_alpha, smoothing=0.1)
    jmix, tmix = jax.jit(jt.make_classification_mix(K, **kw)), tt.make_classification_mix(K, **kw)
    batch = _batch(0, size=37)  # odd sides: the window's clipping at the border
    for step in range(6):
        want = jmix({k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.fold_in(jax.random.key(3), step))
        draws = (_jax_draws(3, step, mixup_alpha, cutmix_alpha)
                 if mixup_alpha or cutmix_alpha else None)
        got = tmix({k: torch.from_numpy(v) for k, v in batch.items()}, draws=draws)
        np.testing.assert_allclose(got["soft"].numpy(), np.asarray(want["soft"]), atol=1e-6)
        np.testing.assert_allclose(got["images"].numpy(), np.asarray(want["images"]), atol=1e-4)
        np.testing.assert_array_equal(got["labels"].numpy(), batch["labels"])
    with pytest.raises(ValueError):
        tt.make_classification_mix(K)
    # the port's own draws: from the step's numpy Generator, the same on every call
    own = [tmix({k: torch.from_numpy(v) for k, v in batch.items()},
                np.random.default_rng((5, 1)))["images"] for _ in range(2)]
    assert torch.equal(own[0], own[1])


def test_train_step_with_mix_matches_jax():
    """One SGD step of a small ResNeXt (ResNet(Bottleneck, (1, 1, 1, 1),
    groups=4, base_width=4), 64 px, batch 4) with mixup 0.2 + cutmix 1.0 +
    smoothing 0.1, from the same weights, at a step whose draws pick mixup
    and at one whose draws pick cutmix.

    The networks run in float64 on both sides (the mix itself stays
    float32 in both packages). In float32 a ReLU net has pre-activations
    within rounding of 0, on either side of the kink in each package: at
    most random batches either package's float32 gradients then sit 1e-3
    to 1e-2 (relative) from a float64 run, far above the thresholds, while
    a smooth net (YOLOv3's SiLU, tests/test_torch_train_step.py) does not.
    The JAX side keeps its float32 parameters and optimizer."""
    kw = dict(mixup_alpha=0.2, cutmix_alpha=1.0, smoothing=0.1)
    with jax.enable_x64(True):  # the draws too: JAX draws them in float64 here
        seed = next(s for s in range(100) if [_jax_draws(s, i, 0.2, 1.0).mixup for i in (0, 1)]
                    == [True, False])
        draws = [_jax_draws(seed, i, 0.2, 1.0) for i in (0, 1)]
        jm = jz.ResNet(jz.resnet.Bottleneck, (1, 1, 1, 1), num_classes=K, groups=4,
                       base_width=4, dtype=jnp.float64)
        variables = jax.device_get(jax.jit(lambda k, x: jm.init(k, x, train=True))(
            jax.random.key(0), jnp.zeros((1, S, S, 3))))

        def jax_apply(v, images, **a):
            return jm.apply(v, jax_normalize(images, jnp.float64, imagenet=True), **a)

        def jax_loss(logits, batch):
            return jt.soft_cross_entropy(logits, batch["soft"]), {}

        tx = jt.build_optimizer("sgd", variables["params"])
        jstep = jt.make_train_step(jax_apply, jax_loss, tx, donate=False,
                                   batch_transform=jt.make_classification_mix(K, **kw),
                                   transform_seed=seed)
        wants = []
        for step_index in (0, 1):  # mixup, then cutmix
            jstate = jt.TrainState.create(variables, tx)
            jstate.step = jnp.int32(step_index)
            jstate, jmet = jstep(jstate, _batch(10 + step_index), 1e-2)
            wants.append((float(jmet["loss"]), float(jmet["grad_norm"]),
                          resnet_state_dict_from_jax(jax.device_get(jstate.variables()))))

    def port_loss(logits, batch):
        return tt.soft_cross_entropy(logits, batch["soft"]), {}

    pmix = tt.make_classification_mix(K, **kw)
    start = resnet_state_dict_from_jax(variables)
    for step_index, (loss, grad_norm, want) in enumerate(wants):
        tm = tz.ResNet(tz.Bottleneck, (1, 1, 1, 1), num_classes=K, groups=4, base_width=4)
        tm.load_state_dict(start)
        state = tt.TrainState.create(tm.double(), tt.build_optimizer("sgd", tm), "cpu")
        state.step = step_index
        step = tt.make_train_step(port_loss, torch.float64, imagenet=True,
                                  batch_transform=lambda b, rng: pmix(b, draws=draws[state.step]))
        batch = {k: torch.from_numpy(v) for k, v in _batch(10 + step_index).items()}
        state, met = step(state, batch, 1e-2)
        assert float(met["loss"]) == pytest.approx(loss, rel=1e-5)
        assert float(met["grad_norm"]) == pytest.approx(grad_norm, rel=2e-4)
        _check_sgd_state(tm.state_dict(), want, start)


def test_accuracy_and_classification_evaluator_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.integers(0, 4, (50, 7)).astype(np.float32)  # many ties
    labels = rng.integers(0, 7, 50)
    for k in (1, 3):
        assert float(accuracy(torch.from_numpy(logits), torch.from_numpy(labels), k)) == \
            pytest.approx(float(jax_accuracy.accuracy(jnp.asarray(logits), jnp.asarray(labels),
                                                      k)), abs=1e-7)
        ours, theirs = Accuracy(k), jax_accuracy.Accuracy(k)
        for i in range(0, 50, 16):
            assert ours(torch.from_numpy(logits[i:i + 16]), labels[i:i + 16]) == \
                theirs(logits[i:i + 16], labels[i:i + 16])
        assert ours.fetch() == theirs.fetch()

    # the evaluators over the same logits, with a ragged last batch (num_real)
    batches = [{"images": np.zeros((16, 2, 2, 3), np.uint8),
                "labels": np.resize(labels[i:i + 16], 16).astype(np.int32),
                "num_real": min(16, 50 - i), "logits": np.resize(logits[i:i + 16], (16, 7))}
               for i in range(0, 50, 16)]

    class Loader:
        def epoch(self, e):
            return iter([dict(b) for b in batches])

    # host keys ride through prefetch_to_device: the step reads its logits there
    want = jt.classification_evaluator(lambda s, b: jnp.asarray(b["logits"]))(None, Loader())
    state = tt.TrainState(torch.nn.Linear(1, 1), None)
    got = tt.classification_evaluator(lambda s, b: torch.from_numpy(b["logits"]))(state, Loader())
    assert got == want and got["accuracy"] == float((logits.argmax(-1) == labels).mean())


# ---------------------------------------------------------------- Fit
class _Log:
    def __init__(self):
        self.records = []

    def log(self, step, **m):
        self.records.append({"step": step, **m})


def _tiny_fit(model=None, **kw):
    rng = np.random.default_rng(4)
    ds = [(rng.integers(0, 256, (20, 24, 3), np.uint8), i % 3) for i in range(8)]
    model = model or tz.ResNet(tz.BasicBlock, (1, 1, 1, 1), num_classes=3,
                               generator=torch.Generator().manual_seed(0))
    args = dict(epochs=2, device="cpu", logger=_Log(), dtype=torch.float32)
    args.update(kw)

    def loss_fn(logits, batch):
        return tt.cross_entropy(logits, batch["labels"]), {}

    return tt.Fit(model, loss_fn, tt.build_optimizer("sgd", model),
                  ClassificationLoader(ds, 16, 4, seed=1), **args)


def test_fit_rng_taking_step_fn():
    """A step taking a 4th positional argument gets a generator seeded from
    (seed, global step), the JAX package's setter rules decide which do."""
    seen = []

    def step(state, batch, lr, rng):
        seen.append(float(torch.rand((), generator=rng)))
        return state, {"loss": torch.tensor(1.0)}

    fit = _tiny_fit(step_fn=step, seed=5)
    fit.run()
    assert seen == [float(torch.rand((), generator=torch.Generator().manual_seed(
        step_seed(5, g)))) for g in range(4)]
    for fn, takes in ((lambda s, b, lr: 0, False), (lambda *a: 0, True),
                      (lambda s, b, rng: 0, True), (lambda s, b, lr, *, rng=None: 0, False),
                      (lambda s, b, lr, **kw: 0, False), (tt.make_train_step(None), True)):
        fit.step_fn = fn
        assert fit._step_takes_rng is takes

    # VGG's dropout draws from that generator through the default step: the
    # same seed repeats a run, another seed does not
    def vgg_run(seed):
        m = tz.VGG((8, "M"), num_classes=3, generator=torch.Generator().manual_seed(0))
        f = _tiny_fit(m, seed=seed, epochs=1)
        f.run()
        return m.fc1.weight.detach().clone()

    a, b, c = vgg_run(0), vgg_run(0), vgg_run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_fit_best_slot_follows_the_later_validation_metric(tmp_path):
    """eval_every=2 with a checkpoint directory: the epochs without a fresh
    validation are saved without a metric, so a train loss above 1 never
    becomes the best 'accuracy' (the JAX package saves them under the train
    loss, and its best slot then stays at epoch 0, metric 7.0)."""
    scores = iter([0.3, 0.6])

    def step(state, batch, lr):
        return state, {"loss": torch.tensor(7.0)}

    fit = _tiny_fit(step_fn=step, epochs=4, eval_every=2, val_loader=[],
                    evaluator=lambda s, loader: {"accuracy": next(scores)},
                    ckpt_dir=str(tmp_path), metric_key="accuracy", metric_mode="max")
    fit.run()
    with open(tmp_path / "best.json") as f:
        assert json.load(f) == {"step": 3, "metric": 0.6}
    assert sorted(os.listdir(tmp_path / "best")) == ["3"]


# ---------------------------------------------------------------- CLI
def _small_zoo_model(cfg):
    return tz.ResNet(tz.BasicBlock, (1, 1, 1, 1), num_classes=cfg.model.num_classes,
                     generator=torch.Generator().manual_seed(cfg.train.seed))


def test_cli_train_cls_resume_and_eval_on_default_pools(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(cli, "_build_zoo_model", _small_zoo_model)
    root = write_classification_dataset(str(tmp_path / "ds"), 12, num_classes=3,
                                        sizes=((40, 30), (32, 32), (24, 50)), seed=2)
    ckpt = str(tmp_path / "ck")
    common = [f"data.data_root={root}", "model.num_classes=3", "data.input_size=32",
              "data.batch_size=4", f"train.ckpt_dir={ckpt}", "--device", "cpu"]
    mix = ["train.mixup_alpha=0.2", "train.cutmix_alpha=1.0", "train.label_smoothing=0.1"]
    fit = cli.main(["train-cls", "train.epochs=2", "train.lr=1e-2", *mix, *common])
    assert fit.global_step == 6 and not fit.interrupted
    loaders = (fit.train_loader, fit.val_loader)
    assert all(ld.num_workers == 4 and ld.worker_backend == "process" for ld in loaders)
    assert all(ld._decode_pool is None for ld in loaders)  # stopped at the end
    fit = cli.main(["train-cls", "--resume", "train.epochs=3", "train.lr=1e-2", *mix, *common])
    assert fit.start_epoch == 2 and fit.global_step == 9
    with open(os.path.join(ckpt, "train.jsonl")) as f:
        last = [r for r in map(json.loads, f) if "accuracy" in r][-1]
    res = cli.main(["eval", "--task", "cls", "--ckpt", ckpt, *common])
    assert res["accuracy"] == last["accuracy"]  # the same weights, the same evaluator
    assert "top-1 accuracy" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="needs --ckpt"):
        cli.main(["eval", "--task", "cls", *common])
    with pytest.raises(SystemExit, match="unknown cls model"):
        monkeypatch.undo()
        cli.main(["train-cls", "model.backbone=resnet9", *common])


def test_cli_detection_train_on_default_pools(tmp_path, monkeypatch):
    from test_torch_eval_cli import C, SIZES, _small_yolo

    from fastvision_tpu_torch.testing import write_detection_dataset

    monkeypatch.setattr(cli, "_build_yolo", _small_yolo)
    root = write_detection_dataset(str(tmp_path / "ds"), 8, sizes=SIZES, seed=4, num_classes=C)
    fit = cli.main(["train", f"data.data_root={root}", f"model.num_classes={C}",
                    "data.input_size=64", "data.batch_size=4", "train.epochs=1",
                    f"train.ckpt_dir={tmp_path / 'ck'}", "--device", "cpu"])
    assert fit.global_step == 2 and fit.train_loader.worker_backend == "process"
    assert fit.train_loader.num_workers == 4
