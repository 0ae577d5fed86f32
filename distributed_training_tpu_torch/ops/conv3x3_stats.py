"""A 3×3 convolution that also returns the per-channel statistics of its
result: the kernel's wrapper, its plain PyTorch version and its launch
counter.

The port of ``pallas_conv3x3_stats`` in ``tools/conv_fusion_probe.py`` (K5;
the kernel is ``csrc/conv3x3_stats.cu``, whose note says what bounds it:
bfloat16 and float16 run on the tensor cores, float32 on CUDA cores).
In the JAX layout: ``x`` ``[N, H, W, Cin]`` (NHWC), ``w`` ``[3, 3, Cin,
Cout]`` (HWIO), stride 1, SAME padding; ``out`` ``[N, H, W, Cout]`` in x's
dtype, and ``sum`` and ``sumsq`` float32 ``[Cout]``, the sums over N, H and
W of the float32 result and of its square, taken before the cast.

:func:`conv3x3_stats` takes its kernel for CUDA tensors and its plain
version (:func:`conv3x3_stats_reference`) for CPU tensors, and nothing
else: a CUDA tensor the kernel cannot take raises.
``conv3x3_stats.launches`` counts kernel launches.

The kernel copies 16-byte rows: Cin and Cout multiples of 8 in the 16-bit
types, of 4 in float32. The wrapper takes any channel counts by padding
(:func:`pad_channels`): zero input channels (of x and w) add exact zeros
to every product, and zero output channels (of w) are sliced off ``out``,
``sum`` and ``sumsq``. Padding in the wrapper, and not a scalar copy path
in the kernel, keeps the kernel's one load path and its aligned 16-byte
copies; it costs a copy of x only where Cin is not a multiple, as at a
network's stem.

Two behaviours of the JAX kernel are not kept. Its per-program partial sums
start from its uninitialised output times 0, which interpret mode fills
with NaN; here every partial starts at zero. With ``N % bn != 0`` it never
writes the last ``N % bn`` images; here that raises ``ValueError``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from distributed_training_tpu_torch.ops import cuda_build
from distributed_training_tpu_torch.utils.device import set_fp32_math

# The kernel's dtype argument (csrc/conv3x3_stats.cu) and the channel
# multiple it needs.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_bn(n: int, bn: int) -> None:
    """``bn`` (the JAX kernel's images per program) must divide ``N``. It is
    validated, not used: the CUDA kernel tiles pixels its own way."""
    if bn < 1 or n % bn:
        raise ValueError(f"batch {n} is not a multiple of the batch block bn={bn}")


def conv3x3_stats_reference(x, w):
    """Plain version: ``F.conv2d`` of float32 copies (exact for bf16
    values), TF32 off, then the sums of the float32 result; ``out`` cast to
    x's dtype."""
    set_fp32_math()
    out = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                   padding=1).permute(0, 2, 3, 1)
    return (out.to(x.dtype), out.sum((0, 1, 2)), out.square().sum((0, 1, 2)))


def channel_multiple(dtype: torch.dtype) -> int:
    """The multiple the kernel needs of Cin and Cout: 16 bytes of
    channels, 8 in bfloat16 and float16 (the tensor-core kernel), 4 in
    float32."""
    return 4 if dtype == torch.float32 else 8


def pad_channels(x, w):
    """``(x, w)`` with Cin (of both) and Cout (of w) zero-padded up to
    :func:`channel_multiple`, and the true Cout."""
    mult = channel_multiple(x.dtype)
    cin, cout = x.shape[-1], w.shape[-1]
    pin, pout = -cin % mult, -cout % mult
    if pin:
        x = F.pad(x, (0, pin))
    if pin or pout:
        w = F.pad(w, (0, pout, 0, pin))
    return x, w, cout


def _check_shapes(x, w) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[-1]):
        raise ValueError(f"conv3x3_stats: the kernel takes x [N, H, W, Cin] and "
                         f"w [3, 3, Cin, Cout], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")


def _check_for_kernel(x, w) -> None:
    """Raise unless the kernel can take these tensors: ``x`` ``[N, H, W,
    Cin]`` and ``w`` ``[3, 3, Cin, Cout]`` of one float32, bfloat16 or
    float16 dtype, ``Cin`` and ``Cout`` multiples of
    :func:`channel_multiple` (the wrapper pads them so), contiguous,
    16-byte aligned, on one CUDA device."""
    _check_shapes(x, w)
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"conv3x3_stats: the kernel takes float32, bfloat16 or "
                         f"float16 x and w of one dtype, got {x.dtype} and {w.dtype}")
    align = channel_multiple(x.dtype)
    if x.shape[-1] % align or w.shape[-1] % align:
        raise ValueError(f"conv3x3_stats: Cin and Cout must be multiples of {align} "
                         f"in {x.dtype} (the kernel's copies take 16-byte rows), "
                         f"got {x.shape[-1]} and {w.shape[-1]}")
    for t in (x, w):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"conv3x3_stats: tensors must all be on the CPU or "
                             f"all on one CUDA device, got {t.device} and {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("conv3x3_stats: tensors must be contiguous and "
                             "16-byte aligned")


def _lib():
    lib = cuda_build.load("conv3x3_stats")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.conv3x3_stats_blocks.restype = ctypes.c_longlong
    lib.conv3x3_stats_blocks.argtypes = [i32] * 3
    lib.conv3x3_stats.restype = i32
    lib.conv3x3_stats.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
    return lib


def conv3x3_stats(x, w, *, bn: int = 1):
    """K5: ``(out, sum, sumsq)`` (see the module docstring)."""
    _check_bn(x.shape[0], bn)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv3x3_stats_reference(x, w)
    _check_shapes(x, w)
    x, w, true_cout = pad_channels(x, w)
    _check_for_kernel(x, w)
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    lib = _lib()
    blocks = lib.conv3x3_stats_blocks(n, h, wd)
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    psum = torch.empty((blocks, cout), dtype=torch.float32, device=x.device)
    psumsq = torch.empty_like(psum)
    with torch.cuda.device(x.device):
        err = lib.conv3x3_stats(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), psum.data_ptr(),
            psumsq.data_ptr(), n, h, wd, cin, cout, _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_stats kernel launch failed: CUDA error {err}")
    conv3x3_stats.launches += 1
    if cout != true_cout:
        out = out[..., :true_cout].contiguous()
        psum, psumsq = psum[:, :true_cout], psumsq[:, :true_cout]
    return out, psum.sum(0), psumsq.sum(0)


conv3x3_stats.launches = 0
