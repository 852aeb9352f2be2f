"""Port's gradient accumulation across calls (`build_optimizer(accum_steps=k)`,
`train.optim.MultiSteps`) vs optax's MultiSteps in the JAX package's
`build_optimizer` on the CPU.

Both packages take the same seeded gradient sequence for 7 calls with a
changing learning rate; the parameters are compared after every call:
max|port - jax| <= 1e-6 * max|jax| per tensor (float32; torch and optax
round the same formulas in a slightly different order). Between updates
the port's parameters must not move at all. A state dict saved mid-cycle
and loaded into a fresh optimizer must continue bit-equal to the uncut run.
"""
import io

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from fastvision_tpu.train import optim as jax_optim
from fastvision_tpu_torch.nn.layers import BatchNorm
from fastvision_tpu_torch.train import build_optimizer, get_lr, set_lr
from fastvision_tpu_torch.train.optim import MultiSteps

torch.set_num_threads(2)
LRS = (1e-2, 5e-3, 2e-2, 1e-3, 7e-3, 4e-3, 1.5e-2)


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


def _grads(call, model):
    rng = np.random.default_rng(200 + call)
    return {k: (rng.normal(0, 1, p.shape) * (1 + call)).astype(np.float32)
            for k, p in model.named_parameters()}


def _set_grads(model, grads):
    for k, p in model.named_parameters():
        p.grad = torch.from_numpy(grads[k].copy())


CASES = {
    "sgd_k2": dict(name="sgd", accum_steps=2),
    "sgd_k3_clip_frozen": dict(name="sgd", accum_steps=3, grad_clip_norm=1.0,
                               trainable={"head.weight": False, "head.bias": False}),
    "adam_k2_clip": dict(name="adam", accum_steps=2, grad_clip_norm=1.0),
    "adam_k3_frozen": dict(name="adam", accum_steps=3, trainable={"conv.weight": False}),
    "sgd_k3_no_nesterov": dict(name="sgd", accum_steps=3, nesterov=False, momentum=0.9),
}


@pytest.mark.parametrize("case", list(CASES))
def test_multisteps_matches_optax_after_every_call(case):
    kw = dict(CASES[case], weight_decay=5e-2)
    k = kw["accum_steps"]
    model = _tiny()
    params = {n: jnp.asarray(p.detach().numpy()) for n, p in model.named_parameters()}
    jkw = dict(kw)
    if "trainable" in kw:
        jkw["trainable"] = {n: kw["trainable"].get(n, True) for n in params}
    tx = jax_optim.build_optimizer(params=params, **jkw)
    opt_state = tx.init(params)
    opt = build_optimizer(model=model, **kw)
    assert isinstance(opt, MultiSteps) and opt.every_k == k
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    for call, lr in enumerate(LRS):
        grads = _grads(call, model)
        opt_state = jax_optim.set_lr(opt_state, lr)
        updates, opt_state = tx.update({n: jnp.asarray(g) for n, g in grads.items()},
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        _set_grads(model, grads)
        set_lr(opt, lr)
        opt.step()
        updated = (call + 1) % k == 0
        assert opt.mini_step == (call + 1) % k
        for n, p in model.named_parameters():
            want = np.asarray(params[n])
            assert np.abs(p.detach().numpy() - want).max() <= 1e-6 * np.abs(want).max(), (n, call)
            if not updated:
                assert torch.equal(p.detach(), before[n]), (n, call)
    assert get_lr(opt) == pytest.approx(LRS[-1])
    for n, trainable in kw.get("trainable", {}).items():
        assert not trainable and torch.equal(dict(model.named_parameters())[n], start[n])


def _run(model, opt, calls):
    for call in calls:
        _set_grads(model, _grads(call, model))
        set_lr(opt, LRS[call])
        opt.step()
        model.zero_grad(set_to_none=True)


@pytest.mark.parametrize("name,k,cut", [("sgd", 2, 3), ("adam", 3, 4)])
def test_multisteps_resumes_mid_cycle_bit_equal(name, k, cut):
    kw = dict(name=name, accum_steps=k, grad_clip_norm=1.0)
    uncut = _tiny()
    opt = build_optimizer(model=uncut, **kw)
    _run(uncut, opt, range(len(LRS)))

    first = _tiny()
    opt = build_optimizer(model=first, **kw)
    _run(first, opt, range(cut))
    assert opt.mini_step == cut % k != 0  # mid-cycle
    buf = io.BytesIO()
    torch.save({"model": first.state_dict(), "optimizer": opt.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf)
    resumed = _tiny(seed=1)  # other weights, replaced by the load
    resumed.load_state_dict(saved["model"])
    opt = build_optimizer(model=resumed, **kw)
    opt.load_state_dict(saved["optimizer"])
    assert opt.mini_step == cut % k
    _run(resumed, opt, range(cut, len(LRS)))
    for (n, a), b in zip(uncut.state_dict().items(), resumed.state_dict().values()):
        assert torch.equal(a, b), n


def test_multisteps_refuses_a_state_of_another_k():
    opt2 = build_optimizer("sgd", _tiny(), accum_steps=2)
    opt3 = build_optimizer("sgd", _tiny(), accum_steps=3)
    with pytest.raises(ValueError, match="accumulates over 2"):
        opt3.load_state_dict(opt2.state_dict())


def test_multisteps_counts_a_missing_gradient_as_zero_as_optax():
    """A parameter without ``.grad`` in some calls (unused by the forward)
    takes zeros there, as the JAX package's gradient of an unused
    parameter is zero: the update matches optax fed those zeros."""
    model = _tiny()
    params = {n: jnp.asarray(p.detach().numpy()) for n, p in model.named_parameters()}
    tx = jax_optim.build_optimizer("sgd", params, weight_decay=5e-2, accum_steps=2)
    opt_state = tx.init(params)
    opt = build_optimizer("sgd", model, weight_decay=5e-2, accum_steps=2)
    for call in range(4):
        grads = _grads(call, model)
        missing = {"head.weight"} | ({"conv.weight"} if call == 1 else set())
        for n in missing:
            grads[n] = np.zeros_like(grads[n])
        opt_state = jax_optim.set_lr(opt_state, LRS[call])
        updates, opt_state = tx.update({n: jnp.asarray(g) for n, g in grads.items()},
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        _set_grads(model, grads)
        for n, p in model.named_parameters():
            if n in missing:
                p.grad = None
        set_lr(opt, LRS[call])
        opt.step()
    for n, p in model.named_parameters():
        want = np.asarray(params[n])
        assert np.abs(p.detach().numpy() - want).max() <= 1e-6 * np.abs(want).max(), n
