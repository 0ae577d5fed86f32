"""Fused Adam: the CUDA kernel's wrapper, its plain PyTorch version, and a
launch counter.

The port of ``distributed_training_tpu/ops/fused_adam.py``
(``fused_adam_kernel_update``, a Pallas kernel). The kernel is
``csrc/fused_adam.cu``: one multi-tensor launch over the parameter list
(see the note there for its design and what bounds it).

:func:`fused_adam_update` takes the kernel for CUDA tensors and the plain
version (:func:`fused_adam_reference`) for CPU tensors, and for nothing
else: a CUDA tensor that the kernel cannot take raises, it does not fall
back. ``fused_adam_update.launches`` counts kernel launches.

The bias corrections are float32 scalars computed on the host as the JAX
wrapper computes them (``t`` as float32, ``1/(1 - b1**t)``), and the
update keeps the JAX formula ``lr·(m·bc1)/(√(v·bc2)+eps)``. Or, for a step
that a CUDA graph captures, ``scalars``: a float32 tensor ``(lr, bc1, bc2)``
on the tensors' device (:func:`adam_scalars_tensor`, computed there from
the count tensor), which the kernel reads from device memory at run time,
so each replay takes that replay's values (``fused_adam_multi_dev``).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from distributed_training_tpu_torch.ops import cuda_build


def adam_scalars(lr: float, step: int, b1: float, b2: float):
    """``(lr, bc1, bc2)`` as float32, ``step`` 1-based."""
    one = np.float32(1.0)
    t = np.float32(step)
    bc1 = one / (one - np.float32(b1) ** t)
    bc2 = one / (one - np.float32(b2) ** t)
    return np.float32(lr), bc1, bc2


def adam_scalars_tensor(lr: torch.Tensor, step: torch.Tensor, b1: float,
                        b2: float) -> torch.Tensor:
    """:func:`adam_scalars` as a float32 tensor ``[lr, bc1, bc2]`` on
    ``step``'s device, from the 0-d float32 ``lr`` and the 1-based integer
    ``step`` tensors: nothing is read on the host."""
    t = step.float()
    bc1 = 1.0 / (1.0 - torch.pow(float(np.float32(b1)), t))
    bc2 = 1.0 / (1.0 - torch.pow(float(np.float32(b2)), t))
    return torch.stack([lr.to(torch.float32), bc1, bc2])


def fused_adam_reference(p, g, m, v, lr=None, step=None, b1=0.9, b2=0.999, eps=1e-8,
                         scalars=None):
    """Plain PyTorch fused Adam on one tensor: ``(new_p, new_m, new_v)``.

    One operation per step of the formula, each rounded to float32, in
    the JAX kernel's order (no ``alpha=`` or ``addcmul`` fusions, which
    may round once where the formula rounds twice). ``scalars`` (the
    tensor of :func:`adam_scalars_tensor`) replaces ``lr`` and ``step``.
    """
    if scalars is None:
        lr, bc1, bc2 = (float(x) for x in adam_scalars(lr, step, b1, b2))
    else:
        lr, bc1, bc2 = scalars.unbind()
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g * g
    p = p - lr * (m * bc1) / (torch.sqrt(v * bc2) + eps)
    return p, m, v


def _check_for_kernel(tensors: Sequence[torch.Tensor]) -> None:
    ref = tensors[0]
    dense = (ref.is_contiguous()
             or (ref.dim() == 4 and ref.is_contiguous(memory_format=torch.channels_last)))
    if not dense:
        raise ValueError("fused_adam: tensors must be dense (contiguous or "
                         "channels_last)")
    for t in tensors:
        if t.device != ref.device or t.dtype != torch.float32:
            raise ValueError(
                f"fused_adam: the kernel takes float32 tensors on one CUDA "
                f"device, got {t.dtype} on {t.device}")
        if t.shape != ref.shape or t.stride() != ref.stride():
            raise ValueError("fused_adam: p, g, m, v (and outputs) must share "
                             "shape and strides")


def _launch(groups, step_scalars, b1, b2, eps) -> int:
    """One launch a ``kMaxTensors`` tensors: ``step_scalars`` is ``(lr,
    bc1, bc2)`` by value (``fused_adam_multi``) or the float32 tensor of
    :func:`adam_scalars_tensor`, read by the kernel (``fused_adam_multi_dev``)."""
    lib = cuda_build.load("fused_adam")
    on_device = isinstance(step_scalars, torch.Tensor)
    fn = lib.fused_adam_multi_dev if on_device else lib.fused_adam_multi
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + (
        [ctypes.c_void_p] + [ctypes.c_float] * 5 if on_device
        else [ctypes.c_float] * 8) + [ctypes.c_void_p]
    lib.fused_adam_max_tensors.argtypes = []
    lib.fused_adam_max_tensors.restype = ctypes.c_int
    n = len(groups)
    ptrs = (ctypes.c_void_p * (7 * n))(
        *[t.data_ptr() for grp in groups for t in grp])
    numels = (ctypes.c_int64 * n)(*[grp[0].numel() for grp in groups])
    device = groups[0][0].device
    stream = torch.cuda.current_stream(device).cuda_stream
    step = ([step_scalars.data_ptr()] if on_device
            else [float(x) for x in step_scalars])
    with torch.cuda.device(device):
        err = fn(ctypes.cast(ptrs, ctypes.c_void_p),
                 ctypes.cast(numels, ctypes.c_void_p), n, *step,
                 float(np.float32(b1)), float(np.float32(1.0 - b1)),
                 float(np.float32(b2)), float(np.float32(1.0 - b2)),
                 float(np.float32(eps)), stream)
    if err != 0:
        raise RuntimeError(f"fused_adam kernel launch failed: CUDA error {err}")
    per = lib.fused_adam_max_tensors()
    return -(-n // per)


@torch.no_grad()
def fused_adam_update(params, grads, mus, nus, *, lr: float | None = None,
                      step: int | None = None, b1: float = 0.9, b2: float = 0.999,
                      eps: float = 1e-8, out=None,
                      scalars: torch.Tensor | None = None) -> None:
    """Adam on lists of float32 tensors.

    Updates ``params``, ``mus`` and ``nus`` in place, or, with
    ``out=(params_out, mus_out, nus_out)``, writes the results there and
    leaves the inputs untouched. ``step`` is the 1-based step count; or
    ``scalars`` (:func:`adam_scalars_tensor`, on the tensors' device)
    replaces ``lr`` and ``step`` and is read where the update runs.
    """
    outs = out if out is not None else (params, mus, nus)
    groups = [grp for grp in zip(params, grads, mus, nus, *outs)]
    if not groups:
        return
    if all(t.device.type == "cpu" for grp in groups for t in grp):
        for p, g, m, v, po, mo, vo in groups:
            np_, nm, nv = fused_adam_reference(p, g, m, v, lr, step, b1, b2, eps,
                                               scalars=scalars)
            po.copy_(np_)
            mo.copy_(nm)
            vo.copy_(nv)
        return
    for grp in groups:
        if any(t.device.type != "cuda" for t in grp):
            raise ValueError("fused_adam: tensors must all be on the CPU or "
                             "all on one CUDA device")
        _check_for_kernel(grp)
    if scalars is None:
        step_scalars = adam_scalars(lr, step, b1, b2)
    else:
        device = groups[0][0].device
        if (scalars.device != device or scalars.dtype != torch.float32
                or scalars.shape != (3,) or not scalars.is_contiguous()):
            raise ValueError(f"fused_adam: scalars must be a contiguous float32 "
                             f"[lr, bc1, bc2] on {device}, got {scalars.dtype} "
                             f"{tuple(scalars.shape)} on {scalars.device}")
        step_scalars = scalars
    fused_adam_update.launches += _launch(groups, step_scalars, b1, b2, eps)


fused_adam_update.launches = 0
