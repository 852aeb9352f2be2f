"""int8 w8a8 convolution: the counterpart of the JAX package's quantized
ConvBN conv (fastvision_tpu/nn/layers.py:100-122), an XLA
``conv_general_dilated`` with int32 accumulation there, not a Pallas kernel.

One quantized conv is three steps, on [M, K] / [M, N] matrices over the
NHWC rows (M = B * Ho * Wo):

  1. quantize + patches (`quantize_patches`): per-tensor symmetric int8,
     ``clip(round(x.float() / in_scale), -127, 127)`` rounding half to even
     as ``jnp.round`` does, gathered into the conv's patches, int8 [M, K_pad]
     with columns in (kh, kw, cin) order (the JAX package's HWIO flatten of
     ``w_q``), zero past K = k * k * Cin. Patches are never built in a float
     type: at batch 256 Darknet-53's 208 x 208, K = 288 layers need 3.2 GB of
     them in int8 (6.4 / 12.8 GB in fp16 / fp32);
  2. the int8 x int8 -> int32 product with the weight matrix
     (`gemm_weight`: K and N zero-padded to multiples of 8; a grouped conv is
     ONE block-diagonal GEMM, zero outside each group's block, which costs
     ``groups`` times the grouped conv's operations but one launch a layer):
     ``torch._int_mm``, cuBLASLt's int8 tensor-core GEMM on the card (it
     takes M > 16 and K, N multiples of 8: M is padded with zero rows for
     tiny maps);
  3. the epilogue (`epilogue`): ``act((acc * (in_scale * w_scale) + bias)
     rounded to the activation dtype)``, a float32 multiply and add each
     rounded, as the JAX package computes them.

Steps 1 and 3 are CUDA kernels (``csrc/int8.cu``) on the card,
`quantize_patches_cuda` and `epilogue_cuda`, one pass over memory each (two
for a k x k conv's patches of a C % 8 == 0 input: quantize, then gather;
an RGB stem's in one line kernel that stages the quantized input lines in
shared memory) where eager PyTorch takes five to seven; their plain PyTorch versions
(`quantize_patches_plain`, `epilogue_plain`) run on CPU tensors and are the
kernels' yardstick of correctness. A CUDA tensor launches the kernel or
raises. What bounds both on an H100 is bytes (int8 patches written,
int32 accumulators read), and at YOLOv3's widths the GEMM too: its K and N
are small, and C is 4 bytes an output.

On the card a conv that `implicit_gemm_eligible` takes (groups 1, C a
multiple of 32, k 1 or 3, N a multiple of 8: every conv of YOLOv3 but its
RGB stem, of ResNet-50 but its stem, of VGG16 but its first) runs instead
as two launches: `quantize_activation_cuda` (the k = 1 float case of the
patches kernel: the input quantized once, int8 NHWC) and `int8_conv_cuda`
(``csrc/int8_conv.cu``), an implicit-GEMM tensor-core kernel that gathers
the patches into shared memory, never into device memory, and runs the
epilogue from its registers (mode (a)), or writes the int32 accumulators
(mode (b)). In mode (a) its epilogue can also add a residual (Darknet's
skip, rounded as PyTorch's add rounds) and write the int8 input of the conv
that consumes its output, quantized at that conv's ``in_scale``, so the
consumer runs no quantize pass (`infer.quantize.link_int8` decides where);
the float output may then be left unwritten. Its plain version
`int8_conv_plain` is the plain conv, epilogue, add and quantize on the same
inputs. This is a dispatch by shape: a build or launch failure of the
kernel raises.

Each kernel is a custom op, CUDA only, with a fake that gives its outputs'
shapes and types: ``fastvision::int8_patches`` (the patches kernel: the
quantize pass and the patches), ``fastvision::int8_epilogue`` and
``fastvision::int8_conv`` (whose missing outputs are empty tensors, which
its wrapper maps back to None), so that ``torch.export`` records one node
for each launch where it cannot trace a ``ctypes`` call, and a loaded
program launches the kernels (and counts the launches) as eager code does.
The wrappers (`quantize_activation_cuda`, `quantize_patches_cuda`,
`epilogue_cuda`, `int8_conv_cuda`) check their inputs and call the ops.

`int8_conv2d` is the whole int8 x int8 -> int32 conv: on the card the
implicit GEMM in mode (b), or for the other shapes the patches of the int8
input and ``_int_mm`` (`int8_conv2d_gemm`); on the CPU the plain version
`int8_conv2d_plain`, a float64 ``F.conv2d`` on the int8 values cast to
int32, exact since every partial sum is an integer below 2^53 (at most
127^2 * 9 * 2048 ~ 3e8 here). A float conv never stands in for the int8
one on the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .. import cuda_build

QMAX = 127
ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu,
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.1),
    "none": lambda x: x,
}
_ACT_CODES = {"none": 0, "relu": 1, "leaky_relu": 2, "silu": 3}  # csrc/int8_common.cuh's
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.int32: 3}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def out_hw(h: int, w: int, k: int, stride: int, padding: int) -> tuple[int, int]:
    return (h + 2 * padding - k) // stride + 1, (w + 2 * padding - k) // stride + 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("int8")
    lib.fv_int8_patches.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.fv_int8_patches.restype = ctypes.c_int
    lib.fv_int8_epilogue.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.fv_int8_epilogue.restype = ctypes.c_int
    lib.fv_int8_error_string.argtypes = [ctypes.c_int]
    lib.fv_int8_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _conv_lib() -> ctypes.CDLL:
    lib = cuda_build.load("int8_conv")
    lib.fv_int8_conv.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.fv_int8_conv.restype = ctypes.c_int
    lib.fv_int8_conv_error_string.argtypes = [ctypes.c_int]
    lib.fv_int8_conv_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str, error_string=None) -> None:
    if err != 0:
        text = (error_string or _lib().fv_int8_error_string)(err).decode()
        raise RuntimeError(f"{what} launch failed: {text} ({err})")


def _scalar_on(t: torch.Tensor, dev: torch.device, what: str) -> None:
    if t.device != dev or t.dtype != torch.float32 or t.numel() != 1:
        raise ValueError(f"{what} must be one float32 value on {dev}")


def quantize_activation(x: torch.Tensor, in_scale: torch.Tensor) -> torch.Tensor:
    """Any float tensor -> int8 of the same shape (and memory format):
    ``clip(round(x.float() / in_scale), -127, 127)``, half to even."""
    q = torch.div(x.float(), in_scale)
    return q.round_().clamp_(-QMAX, QMAX).to(torch.int8)


def quantize_activation_cuda(x: torch.Tensor, in_scale: torch.Tensor) -> torch.Tensor:
    """`quantize_activation` of a contiguous NHWC float32 / bfloat16 tensor
    with C a multiple of 8, on a CUDA device, in one launch of
    ``csrc/int8.cu`` (the patches kernel at k = 1: one IEEE division an
    element) -> int8 NHWC, the implicit GEMM's input."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"quantize_activation_cuda needs a CUDA tensor, got {dev}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_activation_cuda takes float32 or bfloat16, got {x.dtype}")
    _scalar_on(in_scale, dev, "in_scale")
    if x.ndim != 4 or not x.is_contiguous() or x.shape[3] % 8:
        raise ValueError(f"expected contiguous NHWC [B, H, W, C], C % 8 == 0, got "
                         f"{tuple(x.shape)}")
    c = x.shape[3]
    return torch.ops.fastvision.int8_patches(x, in_scale, 1, 1, 0, c, True).view(x.shape)


quantize_activation_cuda.launches = 0


@torch.library.custom_op("fastvision::int8_patches", mutates_args=(), device_types="cuda")
def int8_patches(x: torch.Tensor, in_scale: Optional[torch.Tensor], k: int, stride: int,
                 padding: int, k_pad: int, quantize_pass: bool) -> torch.Tensor:
    """One launch of ``csrc/int8.cu``'s patches kernel on checked inputs:
    NHWC ``x`` -> int8 patches [B * Ho * Wo, k_pad] (`quantize_patches_cuda`);
    ``quantize_pass`` marks the k = 1 launch of `quantize_activation_cuda`
    (the NHWC rows as they are), which is counted there."""
    dev = x.device
    b, h, w, c = x.shape
    ho, wo = out_hw(h, w, k, stride, padding)
    out = torch.empty(b * ho * wo, k_pad, dtype=torch.int8, device=dev)
    # a k x k conv of a float input quantizes into scratch first (csrc/int8.cu)
    scratch = (torch.empty(x.shape, dtype=torch.int8, device=dev)
               if in_scale is not None and k > 1 and c % 8 == 0 and k_pad == k * k * c else None)
    err = _lib().fv_int8_patches(
        x.data_ptr(), _DTYPE_CODES[x.dtype], None if in_scale is None else in_scale.data_ptr(),
        None if scratch is None else scratch.data_ptr(), out.data_ptr(), b, h, w, c, k, stride,
        padding, k_pad, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "int8 quantize kernel" if quantize_pass else "int8 patches kernel")
    (quantize_activation_cuda if quantize_pass else quantize_patches_cuda).launches += 1
    return out


@int8_patches.register_fake
def _(x, in_scale, k, stride, padding, k_pad, quantize_pass):
    b, h, w, _ = x.shape
    ho, wo = out_hw(h, w, k, stride, padding)
    return x.new_empty((b * ho * wo, k_pad), dtype=torch.int8)


def conv_patches(xq: torch.Tensor, k: int, stride: int, padding: int,
                 k_pad: int) -> torch.Tensor:
    """NHWC int8 [B, H, W, C] -> the conv's patches, int8 [B * Ho * Wo,
    k_pad], in PyTorch operations (a 1x1 stride-1 conv: the NHWC rows as
    they are; else the padded tensor's k^2 strided slices concatenated)."""
    b, h, w, c = xq.shape
    ho, wo = out_hw(h, w, k, stride, padding)
    kk = k * k * c
    if k == 1 and padding == 0:
        cols = [xq if stride == 1 else xq[:, ::stride, ::stride]]
    else:
        xp = F.pad(xq, (0, 0, padding, padding, padding, padding))
        cols = [xp[:, i:i + stride * (ho - 1) + 1:stride, j:j + stride * (wo - 1) + 1:stride]
                for i in range(k) for j in range(k)]
    if k_pad > kk:
        cols.append(xq.new_zeros(b, ho, wo, k_pad - kk))
    a = cols[0] if len(cols) == 1 else torch.cat(cols, dim=3)
    return a.reshape(b * ho * wo, k_pad)


def quantize_patches_plain(x: torch.Tensor, in_scale: torch.Tensor | None, k: int, stride: int,
                           padding: int, k_pad: int) -> torch.Tensor:
    """NHWC [B, H, W, C] float (quantized with ``in_scale``) or int8 (with
    ``in_scale=None``) -> int8 patches [B * Ho * Wo, k_pad]."""
    xq = x if x.dtype == torch.int8 else quantize_activation(x, in_scale)
    return conv_patches(xq, k, stride, padding, k_pad)


def quantize_patches_cuda(x: torch.Tensor, in_scale: torch.Tensor | None, k: int, stride: int,
                          padding: int, k_pad: int) -> torch.Tensor:
    """`quantize_patches_plain` in one call of ``csrc/int8.cu`` (one grid;
    two for a k x k conv of a float input with C a multiple of 8, which
    quantizes into scratch, then gathers): ``x`` contiguous NHWC float32 /
    bfloat16 (``in_scale`` a float32 scalar on its device) or int8
    (``in_scale=None``), on a CUDA device."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"quantize_patches_cuda needs a CUDA tensor, got {dev}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"quantize_patches_cuda takes float32, bfloat16 or int8, got {x.dtype}")
    if (x.dtype == torch.int8) != (in_scale is None):
        raise ValueError("in_scale goes with a float input, and only with one")
    if in_scale is not None:
        _scalar_on(in_scale, dev, "in_scale")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"expected contiguous NHWC [B, H, W, C], got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if k_pad < k * k * c or k_pad % 8:
        raise ValueError(f"k_pad {k_pad} must be a multiple of 8, >= k * k * C = {k * k * c}")
    return torch.ops.fastvision.int8_patches(x, in_scale, k, stride, padding, k_pad, False)


quantize_patches_cuda.launches = 0


def quantize_patches(x: torch.Tensor, in_scale: torch.Tensor | None, k: int, stride: int,
                     padding: int, k_pad: int) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if x.device.type == "cpu":
        return quantize_patches_plain(x, in_scale, k, stride, padding, k_pad)
    return quantize_patches_cuda(x.contiguous(), in_scale, k, stride, padding, k_pad)


def epilogue_plain(acc: torch.Tensor, n: int, scale: torch.Tensor, bias: torch.Tensor,
                   act: str, dtype: torch.dtype) -> torch.Tensor:
    """int32 accumulators [M, >= n] -> ``act((acc * scale + bias).to(dtype))``
    [M, n], ``scale = in_scale * w_scale`` and ``bias`` [n] float32."""
    y = torch.mul(acc[:, :n], scale)  # int32 -> float32 inside the multiply
    return ACTIVATIONS[act](y.add_(bias).to(dtype))


def epilogue_cuda(acc: torch.Tensor, n: int, scale: torch.Tensor, bias: torch.Tensor,
                  act: str, dtype: torch.dtype) -> torch.Tensor:
    """`epilogue_plain` in one launch of ``csrc/int8.cu``: ``acc`` contiguous
    int32 [M, N_pad] on a CUDA device, ``dtype`` float32 or bfloat16."""
    dev = acc.device
    if dev.type != "cuda":
        raise ValueError(f"epilogue_cuda needs a CUDA tensor, got {dev}")
    if acc.dtype != torch.int32 or acc.ndim != 2 or not acc.is_contiguous():
        raise ValueError(f"expected contiguous int32 [M, N_pad], got {acc.dtype} "
                         f"{tuple(acc.shape)}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"epilogue_cuda writes float32 or bfloat16, not {dtype}")
    if act not in _ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    for t in (scale, bias):
        if t.device != dev or t.dtype != torch.float32 or t.numel() != n or not t.is_contiguous():
            raise ValueError("scale and bias must be contiguous float32 [n] on acc's device")
    if n > acc.shape[1]:
        raise ValueError(f"n {n} > the accumulators' {acc.shape[1]} columns")
    return torch.ops.fastvision.int8_epilogue(acc, n, scale, bias, act, dtype)


epilogue_cuda.launches = 0


@torch.library.custom_op("fastvision::int8_epilogue", mutates_args=(), device_types="cuda")
def int8_epilogue(acc: torch.Tensor, n: int, scale: torch.Tensor, bias: torch.Tensor, act: str,
                  dtype: torch.dtype) -> torch.Tensor:
    """One launch of ``csrc/int8.cu``'s epilogue kernel on checked inputs
    (`epilogue_cuda`) -> [M, n] in ``dtype``."""
    dev = acc.device
    m, n_pad = acc.shape
    out = torch.empty(m, n, dtype=dtype, device=dev)
    err = _lib().fv_int8_epilogue(
        acc.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), m, n, n_pad,
        _DTYPE_CODES[dtype], _ACT_CODES[act], dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "int8 epilogue kernel")
    epilogue_cuda.launches += 1
    return out


@int8_epilogue.register_fake
def _(acc, n, scale, bias, act, dtype):
    return acc.new_empty((acc.shape[0], n), dtype=dtype)


def epilogue(acc: torch.Tensor, n: int, scale: torch.Tensor, bias: torch.Tensor, act: str,
             dtype: torch.dtype) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if acc.device.type == "cpu":
        return epilogue_plain(acc, n, scale, bias, act, dtype)
    return epilogue_cuda(acc, n, scale, bias, act, dtype)


def gemm_weight(w_q: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """OIHW int8 [N, Cin / groups, k, k] -> the card route's weight matrix,
    int8 [N_pad, K_pad] (K = k * k * Cin in (kh, kw, cin) order, block
    diagonal over the groups), K and N zero-padded to multiples of 8."""
    n, cg, kh, kw = w_q.shape
    cin = cg * groups
    full = w_q.new_zeros(n, kh, kw, cin)
    ng = n // groups
    for g in range(groups):
        full[g * ng:(g + 1) * ng, :, :, g * cg:(g + 1) * cg] = \
            w_q[g * ng:(g + 1) * ng].permute(0, 2, 3, 1)
    k = kh * kw * cin
    mat = w_q.new_zeros(_round_up(n, 8), _round_up(k, 8))
    mat[:n, :k] = full.reshape(n, k)
    return mat


def int8_gemm(a: torch.Tensor, w_mat: torch.Tensor) -> torch.Tensor:
    """int8 patches [M, K_pad] x `gemm_weight`'s [N_pad, K_pad] -> int32
    [M, N_pad] through ``torch._int_mm`` (zero rows added below M = 17)."""
    m = a.shape[0]
    if m <= 16:
        a = torch.cat([a, a.new_zeros(17 - m, a.shape[1])])
    acc = torch._int_mm(a, w_mat.t())
    return acc if acc.shape[0] == m else acc[:m]


def implicit_gemm_eligible(c: int, n: int, k: int, stride: int, padding: int,
                           groups: int) -> bool:
    """Whether ``csrc/int8_conv.cu`` takes the conv: groups 1, C (input
    channels) a multiple of 32, k 1 or 3 with padding k // 2, stride 1 or 2,
    N (output channels) a multiple of 8. The others (an RGB stem, grouped
    convs) take the patches + ``_int_mm`` + epilogue route on the card."""
    return (groups == 1 and c % 32 == 0 and k in (1, 3) and padding == k // 2
            and stride in (1, 2) and n % 8 == 0 and n > 0)


def int8_conv_plain(xq: torch.Tensor, w_mat: torch.Tensor, n: int, k: int, stride: int,
                    scale: torch.Tensor | None = None, bias: torch.Tensor | None = None,
                    act: str = "none", dtype: torch.dtype = torch.bfloat16,
                    residual: torch.Tensor | None = None, out_scale: torch.Tensor | None = None,
                    keep_float: bool = True) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The plain version of `int8_conv_cuda` on its inputs: int8 NHWC ``xq``
    and `gemm_weight`'s ``w_mat`` -> ``(y, q)``, each [B * Ho * Wo, n] or
    None: in mode (b) (``scale=None``) ``y`` the int32 accumulators of
    `int8_conv2d_plain`; in mode (a) ``y`` = `epilogue_plain` of them,
    ``residual + y`` (PyTorch's add) where a ``residual`` is given, and
    ``q`` = `quantize_activation` of that at ``out_scale`` where one is
    given; ``y`` None with ``keep_float=False``."""
    b, h, w, c = xq.shape
    w_q = w_mat[:n, :k * k * c].reshape(n, k, k, c).permute(0, 3, 1, 2)
    acc = int8_conv2d_plain(xq.permute(0, 3, 1, 2), w_q, stride, k // 2)
    acc = acc.permute(0, 2, 3, 1).reshape(-1, n)
    if scale is None:
        return acc, None
    y = epilogue_plain(acc, n, scale, bias, act, dtype)
    if residual is not None:
        y = residual + y
    q = None if out_scale is None else quantize_activation(y, out_scale)
    return (y if keep_float else None), q


def int8_conv_cuda(xq: torch.Tensor, w_mat: torch.Tensor, n: int, k: int, stride: int,
                   scale: torch.Tensor | None = None, bias: torch.Tensor | None = None,
                   act: str = "none", dtype: torch.dtype = torch.bfloat16,
                   residual: torch.Tensor | None = None, out_scale: torch.Tensor | None = None,
                   keep_float: bool = True) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The implicit-GEMM int8 conv in one launch of ``csrc/int8_conv.cu``:
    ``xq`` contiguous int8 NHWC [B, H, W, C] (16-byte aligned) and
    ``w_mat`` int8 [n, k * k * C] on a CUDA device, a shape that
    `implicit_gemm_eligible` takes (padding k // 2) -> ``(y, q)``, each
    [B * Ho * Wo, n] or None. Without ``scale`` and ``bias`` (mode (b)):
    ``y`` the int32 accumulators. With them (float32 [n], mode (a)): ``y`` =
    ``act`` of the dequantized conv in ``dtype`` (bfloat16 or float32), plus
    ``residual`` (contiguous [B * Ho * Wo, n] in ``dtype``) where one is
    given, rounded as PyTorch's add rounds; ``q`` that value quantized at
    ``out_scale`` (one float32 on the device: the consumer's input scale)
    where one is given, the consumer's int8 NHWC input; ``keep_float=False``
    leaves ``y`` unwritten (None)."""
    dev = xq.device
    if xq.dtype != torch.int8 or w_mat.dtype != torch.int8:
        raise TypeError(f"int8_conv_cuda takes int8 tensors, got {xq.dtype} and {w_mat.dtype}")
    if xq.ndim != 4 or not xq.is_contiguous():
        raise ValueError(f"expected contiguous NHWC [B, H, W, C], got {tuple(xq.shape)}")
    b, h, w, c = xq.shape
    if not implicit_gemm_eligible(c, n, k, stride, k // 2, 1):
        raise ValueError(f"int8_conv_cuda does not take C={c}, N={n}, k={k}, stride={stride}")
    if (w_mat.device != dev or not w_mat.is_contiguous()
            or tuple(w_mat.shape) != (n, k * k * c)):
        raise ValueError(f"w_mat must be contiguous int8 [{n}, {k * k * c}] on {dev}, got "
                         f"{tuple(w_mat.shape)} on {w_mat.device}")
    if (scale is None) != (bias is None):
        raise ValueError("scale and bias go together")
    ho, wo = out_hw(h, w, k, stride, k // 2)
    m = b * ho * wo
    if scale is None:
        if residual is not None or out_scale is not None or not keep_float:
            raise ValueError("a residual or an int8 output needs mode (a): scale and bias")
    else:
        if dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"int8_conv_cuda writes float32 or bfloat16, not {dtype}")
        if act not in _ACT_CODES:
            raise ValueError(f"unknown activation {act!r}")
        for t in (scale, bias):
            if t.device != dev or t.dtype != torch.float32 or t.numel() != n \
                    or not t.is_contiguous():
                raise ValueError("scale and bias must be contiguous float32 [n] on xq's device")
        if residual is not None and (
                residual.dtype != dtype or residual.device != dev or tuple(residual.shape) != (m, n)
                or not residual.is_contiguous()):
            raise ValueError(f"residual must be contiguous {dtype} [{m}, {n}] on {dev}, got "
                             f"{residual.dtype} {tuple(residual.shape)}")
        if out_scale is not None:
            _scalar_on(out_scale, dev, "out_scale")
        elif not keep_float:
            raise ValueError("keep_float=False leaves nothing to write without out_scale")
    if dev.type != "cuda":
        raise ValueError(f"int8_conv_cuda needs a CUDA tensor, got {dev}")
    y, q = torch.ops.fastvision.int8_conv(xq, w_mat, n, k, stride, scale, bias, act, dtype,
                                          residual, out_scale, keep_float)
    return (y if keep_float else None), (None if out_scale is None else q)


int8_conv_cuda.launches = 0


def _int8_conv_outputs(xq: torch.Tensor, n: int, k: int, stride: int,
                       scale: Optional[torch.Tensor], dtype: torch.dtype,
                       out_scale: Optional[torch.Tensor], keep_float: bool):
    """`int8_conv`'s two outputs, allocated: [M, n] each, or empty where
    the mode writes nothing (no [M, n] buffer that nothing fills)."""
    b, h, w, _ = xq.shape
    ho, wo = out_hw(h, w, k, stride, k // 2)
    m = b * ho * wo
    out_dtype = torch.int32 if scale is None else dtype
    return (xq.new_empty((m, n) if keep_float else (0,), dtype=out_dtype),
            xq.new_empty((m, n) if out_scale is not None else (0,), dtype=torch.int8))


@torch.library.custom_op("fastvision::int8_conv", mutates_args=(), device_types="cuda")
def int8_conv(xq: torch.Tensor, w_mat: torch.Tensor, n: int, k: int, stride: int,
              scale: Optional[torch.Tensor], bias: Optional[torch.Tensor], act: str,
              dtype: torch.dtype, residual: Optional[torch.Tensor],
              out_scale: Optional[torch.Tensor], keep_float: bool
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``csrc/int8_conv.cu`` on inputs `int8_conv_cuda` has
    checked -> ``(y, q)``, each [M, n], or an empty tensor where the mode
    writes nothing (``keep_float=False``; no ``out_scale``). ``xq``,
    ``w_mat`` and ``residual`` must be 16-byte aligned."""
    for name, t in (("xq", xq), ("w_mat", w_mat), ("residual", residual)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"int8_conv: {name} must be contiguous and 16-byte aligned (the "
                             "kernel reads it in 16-byte chunks)")
    dev = xq.device
    b, h, w, c = xq.shape
    out, q = _int8_conv_outputs(xq, n, k, stride, scale, dtype, out_scale, keep_float)

    def ptr(t, present=True):
        return None if t is None or not present else t.data_ptr()

    err = _conv_lib().fv_int8_conv(
        xq.data_ptr(), w_mat.data_ptr(), ptr(scale), ptr(bias), ptr(out, keep_float),
        ptr(residual), ptr(out_scale), ptr(q, out_scale is not None), b, h, w, c, n, k, stride,
        _DTYPE_CODES[out.dtype], _ACT_CODES[act] if scale is not None else 0, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "int8 implicit-GEMM conv kernel", _conv_lib().fv_int8_conv_error_string)
    int8_conv_cuda.launches += 1
    return out, q


@int8_conv.register_fake
def _(xq, w_mat, n, k, stride, scale, bias, act, dtype, residual, out_scale, keep_float):
    return _int8_conv_outputs(xq, n, k, stride, scale, dtype, out_scale, keep_float)


def add_residual(residual: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``residual + y``, PyTorch's add, where no conv's epilogue takes the
    add (a float conv, train mode, a conv off the implicit GEMM); counted in
    ``add_residual.runs``."""
    add_residual.runs += 1
    return residual + y


add_residual.runs = 0


def int8_conv2d_gemm(xq: torch.Tensor, w_mat: torch.Tensor, n: int, kernel_size: int,
                     stride: int = 1, padding: int = 0, groups: int = 1) -> torch.Tensor:
    """The card route: int8 [B, C, H, W] (any memory format; channels_last
    needs no copy) and `gemm_weight`'s matrix -> int32 accumulators
    [B, n, Ho, Wo] in channels_last memory: `int8_conv_cuda` (mode (b)) on a
    CUDA tensor of a shape it takes, else the patches and ``_int_mm``."""
    b, c, h, w = xq.shape
    ho, wo = out_hw(h, w, kernel_size, stride, padding)
    if xq.is_cuda and implicit_gemm_eligible(c, n, kernel_size, stride, padding, groups):
        acc, _ = int8_conv_cuda(xq.permute(0, 2, 3, 1).contiguous(), w_mat, n, kernel_size,
                                stride)
    else:
        a = quantize_patches(xq.permute(0, 2, 3, 1), None, kernel_size, stride, padding,
                             w_mat.shape[1])
        acc = int8_gemm(a, w_mat)
    return acc[:, :n].reshape(b, ho, wo, n).permute(0, 3, 1, 2)


def int8_conv2d_plain(xq: torch.Tensor, w_q: torch.Tensor, stride: int = 1, padding: int = 0,
                      groups: int = 1) -> torch.Tensor:
    """The plain version: int8 [B, C, H, W] and OIHW int8 ``w_q`` -> int32
    [B, N, Ho, Wo], a float64 conv on the int8 values (exact)."""
    with torch.autocast(xq.device.type, enabled=False):
        y = F.conv2d(xq.double(), w_q.double(), stride=stride, padding=padding, groups=groups)
    return y.to(torch.int32)


def int8_conv2d(xq: torch.Tensor, w_q: torch.Tensor, stride: int = 1, padding: int = 0,
                groups: int = 1, w_mat: torch.Tensor | None = None) -> torch.Tensor:
    """int8 activations and OIHW int8 weights -> int32 accumulators: the card
    route on a CUDA tensor (``w_mat``: `gemm_weight`'s matrix, built here
    when not given), the plain version on a CPU tensor."""
    if xq.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_conv2d takes int8 tensors, got {xq.dtype} and {w_q.dtype}")
    if xq.device.type == "cpu":
        return int8_conv2d_plain(xq, w_q, stride, padding, groups)
    if w_mat is None:
        w_mat = gemm_weight(w_q, groups)
    return int8_conv2d_gemm(xq, w_mat, w_q.shape[0], w_q.shape[-1], stride, padding, groups)


def quantized_conv(x: torch.Tensor, in_scale: torch.Tensor, w_q: torch.Tensor,
                   w_mat: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, stride: int,
                   padding: int, groups: int, act: str, dtype: torch.dtype,
                   residual: torch.Tensor | None = None, out_scale: torch.Tensor | None = None,
                   keep_float: bool = True) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The whole quantized conv: x [B, C, H, W], float (quantized here at
    ``in_scale``) or int8 (its producer quantized it at ``in_scale``) ->
    ``(y, q)``, [B, N, Ho, Wo] each in channels_last memory or None: ``y``
    ``act`` of the dequantized int8 conv in ``dtype`` (+ ``residual``, of
    ``dtype``, as PyTorch adds), None with ``keep_float=False``; ``q`` that
    value quantized at ``out_scale`` (its consumer's input scale) where one
    is given. On the card: where `implicit_gemm_eligible`,
    `quantize_activation_cuda` (for a float input) and `int8_conv_cuda`,
    which adds the residual and writes ``q`` in its epilogue; else the
    patches kernel, ``_int_mm``, the epilogue kernel and `add_residual`. On
    the CPU the plain versions of the same steps. Only a conv on the
    implicit GEMM writes ``q``."""
    b, c, h, w = x.shape
    n, k = w_q.shape[0], w_q.shape[-1]
    ho, wo = out_hw(h, w, k, stride, padding)
    implicit = implicit_gemm_eligible(c, n, k, stride, padding, groups)
    if (out_scale is not None or not keep_float) and not implicit:
        raise ValueError("only a conv on the implicit GEMM writes its consumer's int8 input")
    if residual is not None and residual.dtype != dtype:
        raise ValueError(f"the residual is {residual.dtype}, the conv writes {dtype}")
    cpu = x.device.type == "cpu"
    given = x.dtype == torch.int8

    def nchw(t: torch.Tensor | None) -> torch.Tensor | None:
        return None if t is None else t.reshape(b, ho, wo, n).permute(0, 3, 1, 2)

    if implicit:
        nhwc = x.permute(0, 2, 3, 1)
        res = None if residual is None else residual.permute(0, 2, 3, 1).reshape(-1, n)
        if cpu:
            xq = nhwc if given else quantize_activation(nhwc, in_scale)
            y, q = int8_conv_plain(xq, w_mat, n, k, stride, scale, bias, act, dtype, res,
                                   out_scale, keep_float)
        else:
            xq = nhwc.contiguous()
            if not given:
                xq = quantize_activation_cuda(xq, in_scale)
            y, q = int8_conv_cuda(xq, w_mat, n, k, stride, scale, bias, act, dtype,
                                  None if res is None else res.contiguous(), out_scale,
                                  keep_float)
        return nchw(y), nchw(q)
    if cpu:
        xq = x if given else quantize_activation(x, in_scale)
        acc = int8_conv2d_plain(xq, w_q, stride, padding, groups)
        acc = acc.permute(0, 2, 3, 1).reshape(b * ho * wo, n)
    else:
        a = quantize_patches(x.permute(0, 2, 3, 1), None if given else in_scale, k, stride,
                             padding, w_mat.shape[1])
        acc = int8_gemm(a, w_mat)
    y = nchw(epilogue(acc, n, scale, bias, act, dtype))
    return (y if residual is None else add_residual(residual, y)), None
