"""The port's GPipe pipeline (`parallel.pipeline`) on the CPU: four gloo
ranks (tests/torch_dist_worker.py scenario ``pipe4``, started once for the
module) on a 4-stage model axis (mesh 1 x 4 x 1) and a 2-stage one (2 x 2
x 1), against the JAX package's pipeline functions (over the conftest's 8
host devices, as tests/test_pipeline.py runs them) and against the port's
sequential chain or plain model in this process, all in float64. Each
tensor is held to 1e-10 of its std (max |got - want| / std(want)):

  - the tanh chain (4 stages, `pipeline_apply`) with 8 and 2 microbatches
    (2 < n_stages): outputs, and the gradient of sum(y^2) with respect to
    the stacked parameters, each rank's own row (its other rows zero);
  - the heterogeneous dense chain (`pipeline_hetero_apply`, 4 stages, one
    with an extra parameter; float32 parameter values, which the JAX
    package's float32 parameter vector holds exactly): outputs and every
    stage's gradient (against the JAX package's to 1e-6 of the std: it takes
    the gradient of that float32 vector);
  - a ViT (patch 8, dim 32, depth 4, 2 heads, 32 px, batch 8, 4
    microbatches) through `pipeline_vit_apply` at 4 and 2 stages: its
    trunk (``including_top=False``) with a float64 head and a
    cross-entropy written here, the tokens and every gradient (the
    replicated prefix and the final norm on every rank, each block on the
    rank that owns it); the classifier against the port's plain model (its
    head runs in float32, as both packages' models run it, so it is held to
    the JAX package through the trunk);
  - a ResNet (BasicBlock, (1, 1, 1, 1), 5 classes, 64 px, batch 8, 4
    microbatches) through `resnet_stage_split` + `pipeline_hetero_apply` at
    4 and 2 stages from train mode: logits against the JAX package's, the
    gradient of sum(logits^2) against the port's eval-mode model, its BN
    buffers and modes unchanged;
  - every validation error of the JAX package's, with its message.
"""
import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvision_tpu.core.mesh import create_mesh as jax_create_mesh
from fastvision_tpu.models.classification.resnet import BasicBlock as JaxBasicBlock
from fastvision_tpu.models.classification.resnet import ResNet as JaxResNet
from fastvision_tpu.models.classification.vit import ViT as JaxViT
from fastvision_tpu.parallel import pipeline as jp
from fastvision_tpu_torch.models import import_jax
from fastvision_tpu_torch.models.classification import BasicBlock, ResNet, ViT
from fastvision_tpu_torch.parallel import (pipeline_apply, pipeline_hetero_apply,
                                           pipeline_vit_apply, resnet_stage_split,
                                           stack_stage_params, vit_stage_split)
from torch_dist_worker import (chain_stage, hetero_stage_fns, spawn_ranks,
                               vit_trunk_loss)

torch.set_num_threads(2)
C, MB = 16, 2
HET_WIDTHS = [16, 32, 8, 12, 4]
VIT_KW = dict(num_classes=5, patch=8, dim=32, depth=4, heads=2)
TOL = 1e-10


def rel_to_std(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (want.std() or 1.0))


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _bridge64(fn, tree) -> dict:
    """A JAX tree through a weight bridge of `models.import_jax` without its
    float32 cast (gradients keep float64)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(import_jax, "_t", lambda a: torch.from_numpy(np.array(a, np.float64)))
        return fn(tree)


def _inputs(rng):
    chain = {"w": rng.normal(0, 0.5, (4, C, C)), "b": rng.normal(0, 0.1, (4, C)),
             "mbs8": rng.normal(0, 1, (8, MB, C)), "mbs2": rng.normal(0, 1, (2, MB, C))}
    het = []
    for i in range(4):
        p = {"w": rng.normal(0, 0.5, (HET_WIDTHS[i], HET_WIDTHS[i + 1])),
             "b": rng.normal(0, 0.1, (HET_WIDTHS[i + 1],))}
        if i == 2:
            p["gain"] = rng.normal(1, 0.1, (HET_WIDTHS[i + 1],))
        # float32 values: the JAX package ravels the stages' parameters into
        # one float32 vector
        het.append({k: v.astype(np.float32).astype(np.float64) for k, v in p.items()})
    hetero = {"params": het, "mbs": rng.normal(0, 1, (4, MB, HET_WIDTHS[0]))}
    vit = {"images": rng.normal(0, 1, (8, 32, 32, 3)), "labels": rng.integers(0, 5, 8),
           "head": {"w": rng.normal(0, 0.2, (32, 5)), "b": rng.normal(0, 0.1, (5,))}}
    resnet = {"images": rng.normal(0, 1, (8, 64, 64, 3))}
    return chain, hetero, vit, resnet


def _random_variables(model, shape, rng) -> dict:
    """Float64 variables of the JAX ``model`` (their tree from
    ``jax.eval_shape``: an eager flax ``init`` costs seconds) drawn from
    ``rng`` with float32 values, so that the bridge's float32 copies are
    exact: kernels N(0, 1 / fan_in), biases N(0, 0.1), norm scales 1 +
    N(0, 0.1), embeddings N(0, 0.1), BN means U(-0.5, 0.5) and variances
    U(0.5, 1.5)."""
    tree = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros(shape)))

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            v = rng.normal(0, 1 / np.sqrt(np.prod(a.shape[:-1])), a.shape)
        elif "scale" in name:
            v = 1 + rng.normal(0, 0.1, a.shape)
        elif "var" in name:
            v = rng.uniform(0.5, 1.5, a.shape)
        elif "mean" in name:
            v = rng.uniform(-0.5, 0.5, a.shape)
        else:
            v = rng.normal(0, 0.1, a.shape)
        return v.astype(np.float32).astype(np.float64)

    return jax.tree_util.tree_map_with_path(draw, dict(tree))


def _jax_models(vit, resnet):
    """The JAX models, their float64 variables and the port's state dicts."""
    rng = np.random.default_rng(5)
    jt = JaxViT(**VIT_KW, including_top=False, dtype=jnp.float64)
    jr = JaxResNet(JaxBasicBlock, (1, 1, 1, 1), num_classes=5, dtype=jnp.float64)
    with jax.enable_x64(True):
        vt = _random_variables(jt, (1, 32, 32, 3), rng)
        vc = _random_variables(JaxViT(**VIT_KW, dtype=jnp.float64), (1, 32, 32, 3), rng)
        vr = _random_variables(jr, (1, 64, 64, 3), rng)
    vit["trunk"] = {k: v.double() for k, v in import_jax.vit_state_dict_from_jax(vt).items()}
    vit["cls"] = {k: v.double() for k, v in import_jax.vit_state_dict_from_jax(vc).items()}
    resnet["state"] = {k: v.double() if v.is_floating_point() else v
                       for k, v in import_jax.resnet_state_dict_from_jax(vr).items()}
    return (jt, vt), (jr, vr)


def _jax_side(chain, hetero, vit, resnet, models) -> dict:
    (jt, vt), (jr, vr) = models
    res = {}
    with jax.enable_x64(True):
        m4 = jax_create_mesh(data=2, model=4, time=1)
        m2 = jax_create_mesh(data=4, model=2, time=1)

        def stage(p, x):
            return jnp.tanh(x @ p["w"] + p["b"])

        stacked = {k: jnp.asarray(chain[k]) for k in ("w", "b")}
        for n in (8, 2):
            mbs = jnp.asarray(chain[f"mbs{n}"])
            with m4:
                (loss, y), g = jax.jit(jax.value_and_grad(lambda s: (
                    lambda y: ((y ** 2).sum(), y))(jp.pipeline_apply(stage, s, mbs, m4)),
                    has_aux=True))(stacked)
            res[f"chain{n}"] = {"y": np.asarray(y), "w": np.asarray(g["w"]),
                                "b": np.asarray(g["b"])}
        fns = [stage, stage, lambda p, x: stage(p, x) * p["gain"], stage]
        params = [{k: jnp.asarray(v) for k, v in p.items()} for p in hetero["params"]]
        mbs = jnp.asarray(hetero["mbs"])
        with m4:
            (_, y), g = jax.jit(jax.value_and_grad(lambda ps: (
                lambda y: ((y ** 2).sum(), y))(jp.pipeline_hetero_apply(fns, ps, mbs, m4)),
                has_aux=True))(params)
        res["hetero"] = {"y": np.asarray(y), "grads": jax.device_get(g)}

        images = jnp.asarray(vit["images"])
        labels = jnp.asarray(vit["labels"])
        head = {k: jnp.asarray(v) for k, v in vit["head"].items()}

        def ce(logits):
            return -jax.nn.log_softmax(logits)[jnp.arange(8), labels].mean()

        for n, mesh in ((4, m4), (2, m2)):
            def trunk_loss(v, h, mesh=mesh):
                tokens = jp.pipeline_vit_apply(jt, v, images, mesh, n_micro=4)
                return ce(tokens[:, 0] @ h["w"] + h["b"]), tokens

            with mesh:
                (_, tokens), (gv, gh) = jax.jit(jax.value_and_grad(
                    trunk_loss, argnums=(0, 1), has_aux=True))(vt, head)
            res[f"vit_trunk{n}"] = {"tokens": np.asarray(tokens), "grads": _bridge64(
                import_jax.vit_state_dict_from_jax, jax.device_get(gv)),
                "head": jax.device_get(gh)}
        rimages = jnp.asarray(resnet["images"])
        for n, mesh in ((4, m4), (2, m2)):
            fns, ps = jp.resnet_stage_split(jr, vr, n_stages=n)
            with mesh:
                y = jax.jit(lambda p, m, fns=fns, mesh=mesh: jp.pipeline_hetero_apply(
                    fns, p, m, mesh))(ps, rimages.reshape(4, 2, 64, 64, 3))
            res[f"resnet{n}"] = np.asarray(y).reshape(8, 5)
    return res


def _plain_side(chain, hetero, vit, resnet) -> dict:
    """The port's sequential chains and plain models, with autograd."""
    res = {}
    for n in (8, 2):
        p = {k: torch.tensor(chain[k], requires_grad=True) for k in ("w", "b")}
        x = torch.tensor(chain[f"mbs{n}"])
        for i in range(4):
            x = chain_stage({k: v[i] for k, v in p.items()}, x)
        (x ** 2).sum().backward()
        res[f"chain{n}"] = {"y": x.detach(), "w": p["w"].grad, "b": p["b"].grad}
    ps = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
          for p in hetero["params"]]
    x = torch.tensor(hetero["mbs"])
    for f, p in zip(hetero_stage_fns(), ps):
        x = f(p, x)
    (x ** 2).sum().backward()
    res["hetero"] = {"y": x.detach(), "grads": [{k: v.grad for k, v in p.items()} for p in ps]}
    trunk = ViT(**VIT_KW, including_top=False, image_size=32).double()
    trunk.load_state_dict(vit["trunk"])
    head = {k: torch.tensor(v, requires_grad=True) for k, v in vit["head"].items()}
    images, labels = torch.tensor(vit["images"]), torch.tensor(vit["labels"])
    tokens = trunk(images.permute(0, 3, 1, 2))
    vit_trunk_loss(tokens, head, labels).backward()
    res["vit_trunk"] = {"tokens": tokens.detach(), "head": {k: v.grad for k, v in head.items()},
                        "grads": {k: p.grad for k, p in trunk.named_parameters()}}
    cls = ViT(**VIT_KW, image_size=32).double()
    cls.load_state_dict(vit["cls"])
    cls.head.float()
    logits = cls(images)
    torch.nn.functional.cross_entropy(logits, labels).backward()
    res["vit_cls"] = {"logits": logits.detach(),
                      "grads": {k: p.grad for k, p in cls.named_parameters()}}
    model = ResNet(BasicBlock, (1, 1, 1, 1), num_classes=5).double()
    model.load_state_dict(resnet["state"])
    model.eval()
    logits = model(torch.tensor(resnet["images"]))
    (logits ** 2).sum().backward()
    res["resnet"] = {"logits": logits.detach(),
                     "grads": {k: p.grad for k, p in model.named_parameters()}}
    return res


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    chain, hetero, vit, resnet = _inputs(rng)
    models = _jax_models(vit, resnet)
    t = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v for k, v in chain.items()}
    rank_inputs = {
        "chain": t,
        "hetero": {"params": [{k: torch.tensor(v) for k, v in p.items()}
                              for p in hetero["params"]], "mbs": torch.tensor(hetero["mbs"])},
        "vit": {"kw": {**VIT_KW, "image_size": 32}, "trunk": vit["trunk"], "cls": vit["cls"],
                "head": {k: torch.tensor(v) for k, v in vit["head"].items()},
                "images": torch.tensor(vit["images"]), "labels": torch.tensor(vit["labels"])},
        "resnet": {"state": resnet["state"], "images": torch.tensor(resnet["images"])}}
    with tempfile.TemporaryDirectory() as workdir:
        torch.save(rank_inputs, os.path.join(workdir, "pipe_inputs.pt"))
        collect = spawn_ranks("pipe4", workdir, world=4)
        want = {}
        side = threading.Thread(
            target=lambda: want.update(_jax_side(chain, hetero, vit, resnet, models)))
        side.start()  # while the ranks run
        plain = _plain_side(chain, hetero, vit, resnet)
        ranks = collect()
        side.join()
        assert want, "the JAX side failed (its traceback is above)"
        yield {"ranks": ranks, "jax": want, "plain": plain}


def _rows_check(got: torch.Tensor, want, rank: int):
    """A stacked parameter's gradient on ``rank``: its row equal to the
    sequential chain's, the other rows zero."""
    got = got.numpy()
    assert rel_to_std(got[rank], want[rank]) <= TOL
    assert not np.delete(got, rank, axis=0).any()


@pytest.mark.parametrize("n_micro", [8, 2])
def test_pipeline_apply_matches_jax_and_the_chain(runs, n_micro):
    want, plain = runs["jax"][f"chain{n_micro}"], runs["plain"][f"chain{n_micro}"]
    assert rel_to_std(want["y"], plain["y"]) <= TOL
    for r, o in enumerate(runs["ranks"]):
        got = o["stages4"][f"chain{n_micro}"]
        assert got["y"].shape == (n_micro, MB, C)
        assert rel_to_std(got["y"], want["y"]) <= TOL
        assert rel_to_std(got["y"], plain["y"]) <= TOL
        for k in ("w", "b"):
            _rows_check(got[k], want[k], r)
            _rows_check(got[k], plain[k].numpy(), r)


def test_pipeline_hetero_matches_jax_and_the_chain(runs):
    want, plain = runs["jax"]["hetero"], runs["plain"]["hetero"]
    for r, o in enumerate(runs["ranks"]):
        got = o["stages4"]["hetero"]
        assert got["y"].shape == (4, MB, HET_WIDTHS[-1])
        assert rel_to_std(got["y"], want["y"]) <= TOL
        assert rel_to_std(got["y"], plain["y"]) <= TOL
        for i, (g, w, p) in enumerate(zip(got["grads"], want["grads"], plain["grads"])):
            for k in w:
                if i == r:  # each rank's gradient: its own stage's (JAX's went
                    # through its float32 parameter vector: float32's rounding)
                    assert rel_to_std(g[k], p[k]) <= TOL and rel_to_std(g[k], w[k]) <= 1e-6
                else:
                    assert g[k] is None


def _owned(ranks, key, name):
    """The ranks holding a gradient of ``name``."""
    return [r for r, o in enumerate(ranks) if name in o[key]["grads"]]


@pytest.mark.parametrize("n_stages", [4, 2])
def test_pipeline_vit_trunk_matches_jax_and_the_plain_model(runs, n_stages):
    want, plain = runs["jax"][f"vit_trunk{n_stages}"], runs["plain"]["vit_trunk"]
    assert rel_to_std(want["tokens"], plain["tokens"]) <= TOL
    ranks = [o[f"stages{n_stages}"] for o in runs["ranks"]]
    for o in ranks:
        got = o["vit_trunk"]
        assert rel_to_std(got["tokens"], want["tokens"]) <= TOL
        for k in ("w", "b"):
            assert rel_to_std(got["head"][k], want["head"][k]) <= TOL
    per_stage = 4 // n_stages
    for name, w in want["grads"].items():
        holders = _owned(ranks, "vit_trunk", name)
        if name.startswith("blocks."):  # the block's stage on every data index
            stage = int(name.split(".")[1]) // per_stage
            assert holders == [r for r in range(4) if r % n_stages == stage], name
        else:  # the prefix and the final norm: every rank
            assert holders == [0, 1, 2, 3], name
        for r in holders:
            g = ranks[r]["vit_trunk"]["grads"][name]
            assert rel_to_std(g, w) <= TOL, name
            assert rel_to_std(g, plain["grads"][name]) <= TOL, name


@pytest.mark.parametrize("n_stages", [4, 2])
def test_pipeline_vit_classifier_matches_the_plain_model(runs, n_stages):
    plain = runs["plain"]["vit_cls"]
    ranks = [o[f"stages{n_stages}"] for o in runs["ranks"]]
    for name, w in plain["grads"].items():
        holders = _owned(ranks, "vit_cls", name)
        assert holders, name
        for r in holders:
            assert rel_to_std(ranks[r]["vit_cls"]["grads"][name], w) <= TOL, name
    for o in ranks:
        assert rel_to_std(o["vit_cls"]["logits"], plain["logits"]) <= TOL


@pytest.mark.parametrize("n_stages", [4, 2])
def test_resnet_stage_split_matches_jax(runs, n_stages):
    want, plain = runs["jax"][f"resnet{n_stages}"], runs["plain"]["resnet"]
    assert rel_to_std(plain["logits"], want) <= TOL
    ranks = [o[f"stages{n_stages}"]["resnet"] for o in runs["ranks"]]
    for o in ranks:
        assert rel_to_std(o["logits"], want) <= TOL
        assert o["buffers_unchanged"] and o["still_training"]
    for name, w in plain["grads"].items():
        holders = [r for r, o in enumerate(ranks) if name in o["grads"]]
        assert holders and len(holders) == 4 // n_stages, name
        for r in holders:
            assert rel_to_std(ranks[r]["grads"][name], w) <= TOL, name


def _message(fn, *a, **kw) -> str:
    with pytest.raises(ValueError) as e:
        fn(*a, **kw)
    return str(e.value)


def test_validation_errors_match_jax(runs):
    """Each JAX validation error has its counterpart, with the same text."""
    jr = JaxResNet(JaxBasicBlock, (1, 1, 1, 1), num_classes=3)
    variables = {"params": {}, "batch_stats": {}}
    model = ResNet(BasicBlock, (1, 1, 1, 1), num_classes=3)
    assert _message(resnet_stage_split, model, 3) == _message(
        jp.resnet_stage_split, jr, variables, n_stages=3)
    pyramid = ResNet(BasicBlock, (1, 1, 1, 1), including_top=False)
    jpyr = JaxResNet(JaxBasicBlock, (1, 1, 1, 1), including_top=False)
    assert _message(resnet_stage_split, pyramid, 4) == _message(
        jp.resnet_stage_split, jpyr, variables, n_stages=4)
    vit = ViT(num_classes=3, patch=8, dim=16, depth=3, heads=2, image_size=16)
    jvit = JaxViT(num_classes=3, patch=8, dim=16, depth=3, heads=2)
    jparams = {f"block{i}": {} for i in range(3)}
    assert _message(vit_stage_split, vit, 2) == _message(jp.vit_stage_split, jvit, jparams, 2)
    vit4 = ViT(num_classes=3, patch=8, dim=16, depth=4, heads=2, image_size=16)
    got = _message(pipeline_vit_apply, vit4, torch.zeros(6, 16, 16, 3), None, n_micro=4)
    assert got == "batch 6 not divisible into 4 microbatches"  # JAX's text (:360)
    # on the ranks: the stage count against the axis size, and a stacked
    # parameter's stages against it
    for o in runs["ranks"]:
        assert o["stages4"]["errors"]["stage_count"] == (
            "3 stage_fns / 3 stage_params for a 4-device 'model' axis")
        assert o["stages4"]["errors"]["stacked"] == (
            "stacked params lead with 2 stages for a 4-device 'model' axis")


def test_single_process_is_the_sequential_chain():
    """Without a group the model axis has one rank: every function is the
    plain chain, and `vit_stage_split`'s stacked stage equals the blocks."""
    rng = np.random.default_rng(3)
    ps = [{"w": torch.tensor(rng.normal(0, 0.5, (C, C))), "b": torch.tensor(rng.normal(0, 0.1, C))}
          for _ in range(1)]
    mbs = torch.tensor(rng.normal(0, 1, (3, MB, C)))
    y = pipeline_apply(chain_stage, stack_stage_params(ps), mbs)
    assert torch.equal(y, torch.stack([chain_stage(ps[0], x) for x in mbs]))
    vit = ViT(**VIT_KW, image_size=32).double()
    images = torch.tensor(rng.normal(0, 1, (4, 32, 32, 3)))
    stage_fn, stacked = vit_stage_split(vit, 2)
    x = torch.tensor(rng.normal(0, 1, (4, 17, 32)))
    row = {k: v[1] for k, v in stacked.items()}
    assert torch.allclose(stage_fn(row, x), vit.blocks[3](vit.blocks[2](x)), rtol=0, atol=1e-12)
    vit.head.float()
    with torch.no_grad():
        assert rel_to_std(pipeline_vit_apply(vit, images, n_micro=2), vit(images)) <= 1e-12
