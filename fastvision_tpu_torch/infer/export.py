"""Program export: a ``torch.export`` program with its weights in one ``.pt2``
file (port of fastvision_tpu/infer/export.py's ``export_stablehlo`` /
``load_stablehlo``).

`export_program` captures an inference function, for example the
Detector's normalize + forward + decode + NMS, with ``torch.export.export``
at the example inputs' shapes (static, as the JAX artifact's are) and
writes it with ``torch.export.save``. The tensors the function reads (the
model's parameters and buffers, the int8 state included) go into the file,
so `load_program` needs no model code at the destination: it imports the
port's custom ops (the NMS and int8 kernels, ``fastvision::*``, which the
program calls as one node each on the card) and returns the program as a
callable module.

On the CPU a program runs the kernels' plain versions, traced (the NMS's
greedy loop unrolls into K steps); on the card it calls the custom ops, so
a loaded program launches the same kernels as eager code, and counts the
launches in the same wrappers.

The JAX package's SavedModel and TFLite writers go through jax2tf and
TensorFlow; the port has no route from PyTorch to either.
"""
from __future__ import annotations

import collections
import warnings
from typing import Callable, Sequence

import torch
from torch import nn


class _Function(nn.Module):
    """A plain function as the module ``torch.export`` takes; the tensors
    it reads become the program's constants."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *inputs):
        return self.fn(*inputs)


def export_program(infer_fn: Callable | nn.Module, example_inputs: Sequence[torch.Tensor],
                   path: str) -> str:
    """Capture ``infer_fn(*inputs)`` (a module or a function of tensors,
    returning tensors or a dict / tuple of them) at the shapes, types and
    device of ``example_inputs``, with every tensor it reads, and write it
    to ``path`` (a ``.pt2`` file). -> ``path``."""
    module = infer_fn if isinstance(infer_fn, nn.Module) else _Function(infer_fn)
    program = torch.export.export(module, tuple(example_inputs))
    program.example_inputs = None  # the file keeps the weights, not an example batch
    with warnings.catch_warnings():
        # a channels_last weight is not contiguous, so the writer finds no
        # "complete" tensor in its storage and says so; it writes the
        # storage's bytes with the strides, which load as they were
        warnings.filterwarnings("ignore", message="No complete tensor found in the group")
        torch.export.save(program, path)
    return path


def detector_program(det) -> Callable:
    """A `Detector`'s device program as `export_program` takes it: uint8
    NHWC images [B, S, S, 3] -> {"boxes", "scores", "classes", "valid"}
    (`Detector.infer`: normalize + forward + decode + NMS)."""
    def infer(images: torch.Tensor) -> dict:
        return det.infer(images)._asdict()

    return infer


def classifier_program(model: nn.Module, dtype: torch.dtype) -> Callable:
    """A classification or video model's program: uint8 images [B, S, S, 3]
    or clips [B, T, S, S, 3] -> {"probs": float32 softmax [B, classes]},
    imagenet-standardized, the forward under ``dtype`` autocast as the eval
    step runs it (``model`` in eval mode)."""
    from ..train.steps import _forward

    def infer(images: torch.Tensor) -> dict:
        with torch.inference_mode():
            logits = _forward(model, images, dtype, imagenet=True)
            return {"probs": torch.softmax(logits.float(), dim=-1)}

    return infer


def _register_ops() -> None:
    """Import the modules that register the port's custom ops."""
    from ..ops import int8, nms_kernel  # noqa: F401


def load_exported(path: str) -> torch.export.ExportedProgram:
    """The ``ExportedProgram`` in an `export_program` file (its graph can be
    read, e.g. by `op_counts`)."""
    _register_ops()
    return torch.export.load(path)


def load_program(path: str) -> Callable:
    """Load an `export_program` file -> a callable module taking the example
    inputs' shapes and types, returning what the exported function returned."""
    return load_exported(path).module()


def op_counts(program: torch.export.ExportedProgram) -> collections.Counter:
    """Operator -> number of nodes that call it, over the program's graph
    and the graphs nested in it (autocast regions): e.g.
    ``counts["fastvision.nms_suppression_mask.default"]``."""
    counts: collections.Counter = collections.Counter()
    for gm in program.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            counts.update(str(n.target) for n in gm.graph.nodes if n.op == "call_function")
    return counts


def node_count(program: torch.export.ExportedProgram) -> int:
    """Nodes of the program's graph and of the graphs nested in it."""
    return sum(len(gm.graph.nodes) for gm in program.graph_module.modules()
               if isinstance(gm, torch.fx.GraphModule))
