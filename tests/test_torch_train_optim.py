"""Port's optimizers, schedules and EMA vs the JAX package (optax) on the CPU.

The optimizer cases feed both packages the same seeded gradient sequence
for 5 updates with a changing learning rate and compare the parameters:
max|port - jax| <= 1e-6 * max|jax| per tensor (float32; torch and optax
round the same formulas in a slightly different order, e.g. Adam's bias
correction). Schedules are pure Python and must be equal; EMA within 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from fastvision_tpu.train import ema as jax_ema
from fastvision_tpu.train import optim as jax_optim
from fastvision_tpu.train import schedulers as jax_sched
from fastvision_tpu_torch.nn.layers import BatchNorm
from fastvision_tpu_torch.train import (
    PlateauScheduler,
    build_optimizer,
    decay_mask,
    ema_update,
    get_lr,
    make_ema_update,
    set_lr,
)
from fastvision_tpu_torch.train import schedulers as port_sched
from fastvision_tpu_torch.train.optim import MultiSteps

torch.set_num_threads(2)
LRS = (1e-2, 5e-3, 2e-2, 1e-3, 7e-3)


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, bias=False)
        self.bn = BatchNorm(4)
        self.head = nn.Conv2d(4, 2, 1)


def _tiny(seed=0):
    m = Tiny()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return m


def _grads(step, model):
    rng = np.random.default_rng(100 + step)
    return {k: (rng.normal(0, 1, p.shape) * (1 + step)).astype(np.float32)
            for k, p in model.named_parameters()}


CASES = {
    "sgd_nesterov": dict(name="sgd"),
    "sgd_plain_momentum": dict(name="sgd", nesterov=False, momentum=0.9),
    "adam": dict(name="adam"),
    "sgd_clip_active": dict(name="sgd", grad_clip_norm=1.0),
    "adam_clip_active": dict(name="adam", grad_clip_norm=1.0),
    "sgd_clip_inactive": dict(name="sgd", grad_clip_norm=1e4),
    "sgd_frozen_conv": dict(name="sgd", trainable={"conv.weight": False}),
    "adam_frozen_head": dict(name="adam", trainable={"head.weight": False, "head.bias": False}),
    "adam_no_decay": dict(name="adam", weight_decay=0.0),
    "sgd_accum_2": dict(name="sgd", accum_steps=2),
    "adam_accum_2_clip_frozen": dict(name="adam", accum_steps=2, grad_clip_norm=1.0,
                                     trainable={"conv.weight": False}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_optax(case):
    kw = dict(CASES[case])
    model = _tiny()
    params = {k: jnp.asarray(p.detach().numpy()) for k, p in model.named_parameters()}
    jkw = dict(kw)
    if "trainable" in kw:
        jkw["trainable"] = {k: kw["trainable"].get(k, True) for k in params}
    kw.setdefault("weight_decay", 5e-2)
    jkw.setdefault("weight_decay", 5e-2)
    tx = jax_optim.build_optimizer(params=params, **jkw)
    opt_state = tx.init(params)
    opt = build_optimizer(model=model, **kw)
    for step, lr in enumerate(LRS):
        grads = _grads(step, model)
        opt_state = jax_optim.set_lr(opt_state, lr)
        updates, opt_state = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[k])
        set_lr(opt, lr)
        opt.step()
    assert get_lr(opt) == pytest.approx(LRS[-1])
    assert jax_optim.get_lr(opt_state) == pytest.approx(LRS[-1])
    for k, p in model.named_parameters():
        want = np.asarray(params[k])
        assert np.abs(p.detach().numpy() - want).max() <= 1e-6 * np.abs(want).max(), k
    if "trainable" in kw:
        frozen = [k for k, t in kw["trainable"].items() if not t]
        ref = dict(_tiny().named_parameters())
        for k in frozen:
            assert torch.equal(dict(model.named_parameters())[k], ref[k])


def test_clip_rule_is_optax_not_clip_grad_norm():
    """Gradients below the limit pass untouched (clip_grad_norm_ scales them
    by max / (norm + 1e-6) all the same)."""
    model = _tiny()
    opt = build_optimizer("sgd", model, weight_decay=0.0, momentum=0.0, nesterov=False,
                          grad_clip_norm=10.0)
    grads = {k: np.full(p.shape, 0.01, np.float32) for k, p in model.named_parameters()}
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    for k, p in model.named_parameters():
        p.grad = torch.from_numpy(grads[k].copy())
    set_lr(opt, 1.0)
    opt.step()
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), before[k] - torch.from_numpy(grads[k]))


def test_decay_mask_matches_jax():
    model = _tiny()
    params = {k: np.asarray(p.detach().numpy()) for k, p in model.named_parameters()}
    assert decay_mask(model) == jax_optim.decay_mask(params)
    assert decay_mask(model) == {"conv.weight": True, "bn.weight": False, "bn.bias": False,
                                 "head.weight": True, "head.bias": False}


def test_build_optimizer_rejects_what_is_not_ported():
    """Every option is ported: accum_steps > 1 wraps the optimizer, whose
    param groups stay the inner optimizer's; unknown names are refused."""
    accum = build_optimizer("sgd", _tiny(), accum_steps=2)
    assert isinstance(accum, MultiSteps) and accum.param_groups is accum.inner.param_groups
    with pytest.raises(ValueError, match="unknown optimizer"):
        build_optimizer("lamb", _tiny())
    opt = build_optimizer("adam", _tiny())
    assert get_lr(opt) == 0.0
    set_lr(opt, 3e-4)
    assert [g["lr"] for g in opt.param_groups] == [3e-4, 3e-4]


SCHEDULE_CASES = [
    ("cosine_lr", (1e-2, 1e-4, 50)),
    ("linear_lr", (1e-2, 1e-4, 50)),
    ("exponential_lr", (1e-2, 1e-4, 50)),
    ("step_decay_lr", (1e-2, 7, 0.5)),
    ("warmup_cosine_lr", (1e-2, 1e-4, 60, 10)),
    ("warmup_cosine_lr", (1e-2, 1e-4, 60, 5, 1e-3, 3)),
    ("constant_lr", (3e-3,)),
]


@pytest.mark.parametrize("name,args", SCHEDULE_CASES)
def test_schedules_equal_jax(name, args):
    ours, theirs = getattr(port_sched, name)(*args), getattr(jax_sched, name)(*args)
    for step in range(0, 80):
        assert ours(step) == theirs(step), (name, step)
    assert set(port_sched.SCHEDULES) == set(jax_sched.SCHEDULES)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_plateau_matches_jax(mode):
    metrics = [5.0, 4.0, 4.5, 4.2, 4.1, 3.0, 3.5, 3.6, 3.7, 3.8, 2.0, 2.5, 2.6, 2.7]
    ours = PlateauScheduler(patience=2, gamma=0.5, mode=mode, min_scale=0.1)
    theirs = jax_sched.PlateauScheduler(patience=2, gamma=0.5, mode=mode, min_scale=0.1)
    for m in metrics:
        assert ours.update(m) == theirs.update(m)
        assert (ours.best, ours.bad_epochs) == (theirs.best, theirs.bad_epochs)


def test_ema_matches_jax_over_three_updates():
    rng = np.random.default_rng(5)
    shapes = [(4, 3, 3, 3), (4,), (2, 4)]
    ema = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    ema_t = [torch.from_numpy(e.copy()) for e in ema]
    update = make_ema_update(0.99)
    for step in (1, 2, 3):
        params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
        ema = jax_ema.ema_update(ema, params, step, decay=0.99)
        out = update(ema_t, [torch.from_numpy(p) for p in params], step)
        assert all(o is e for o, e in zip(out, ema_t))  # in place
    for got, want in zip(ema_t, ema):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    # past the warm-up the decay is the configured one
    e, p = [torch.zeros(2)], [torch.ones(2)]
    ema_update(e, p, 10**6, decay=0.9)
    np.testing.assert_allclose(e[0].numpy(), np.full(2, 0.1, np.float32), rtol=1e-6)
