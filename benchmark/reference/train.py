"""The reference's first training steps: the plain model, loss and SGD,
float32 with TF32 off, from the weights the benchmark made, on the same
batches the program got. Reads what the comparison holds the program to."""
from __future__ import annotations

import torch

from . import family
from .layers import set_fp8


def leaf_norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    names = list(tensors)
    norms = torch.stack(torch._foreach_norm([tensors[n].float() for n in names])).cpu()
    return dict(zip(names, norms.tolist()))


def outputs(pred) -> list[torch.Tensor]:
    """A model's outputs (a tensor or a list of them) as float32 host tensors."""
    return [t.detach().float().cpu() for t in (pred if isinstance(pred, (list, tuple)) else [pred])]


def reference_steps(cfg: dict, weights: dict[str, torch.Tensor], batches: list[dict],
                    device: torch.device, fp8: bool = False, half_batch: bool = False) -> dict:
    """Trains ``len(batches)`` steps, each stage recomputed in the backward
    so that float32 fits at the timed batch. -> {'loss': [per step], 'out':
    the first step's forward outputs (float32, on the host), 'grad': {leaf:
    norm of the first step's gradient with its weight decay, what the
    momentum buffer holds after one step}, 'grad_raw': {leaf: the first
    gradient's norm}, 'delta': {leaf: norm of the change over the steps}}.
    ``fp8``: the control, under bfloat16 autocast with its GEMMs in fp8
    (`reference.layers`); ``half_batch``: the fault that trains on the
    first half of each batch alone."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        models = family(cfg)
        with torch.device(device):
            model = models.build(cfg)
        model.load_state_dict(weights)
        set_fp8(model, fp8)
        model.remat = True
        model.train()
        params = dict(model.named_parameters())
        start = {n: p.detach().clone() for n, p in params.items()}
        opt = cfg["optimizer"]
        lr, mu, wd, nesterov = opt["lr"], opt["momentum"], opt["weight_decay"], opt["nesterov"]
        bufs: dict[str, torch.Tensor] = {}
        out = {"loss": []}
        for k, batch in enumerate(batches):
            images, labels = batch["images"], batch["labels"]
            if half_batch:
                images, labels = images[: len(images) // 2], labels[: len(labels) // 2]
            model.zero_grad(set_to_none=True)
            with torch.autocast(device.type, dtype=torch.bfloat16, enabled=fp8):
                pred = model(torch.from_numpy(images).to(device))
            pred = [p.float() for p in pred] if isinstance(pred, list) else pred.float()
            if k == 0:
                out["out"] = outputs(pred)
            loss = models.loss(pred, labels, cfg)
            loss.backward()
            out["loss"].append(loss.detach().item())
            with torch.no_grad():
                d = {n: p.grad + wd * p if p.ndim > 1 else p.grad.clone()
                     for n, p in params.items()}
                if k == 0:
                    out["grad"] = leaf_norms(d)
                    out["grad_raw"] = leaf_norms({n: p.grad for n, p in params.items()})
                for n, p in params.items():
                    bufs[n] = d[n].clone() if k == 0 else bufs[n].mul_(mu).add_(d[n])
                    p.sub_(lr * (d[n] + mu * bufs[n] if nesterov else bufs[n]))
        with torch.no_grad():
            out["delta"] = leaf_norms({n: p - start[n] for n, p in params.items()})
        return out
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
