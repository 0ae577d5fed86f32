"""Per-channel int8 weight quantization for the serving engine.

The port of ``distributed_training_tpu/serving/quantize.py``. Decode
reads every weight once an iteration to emit a handful of tokens, so
weight bytes set its floor. This module quantizes the transformer's
matmul weights to symmetric per-channel int8 once, off the hot path: at
engine construction, or at hot-swap staging on the watcher's thread
(``Engine.arm_swap``), never inside ``Engine.step``.

Scheme (JAX's, bit for bit):

- **Symmetric, per output channel.** ``q = clip(round(w / scale), -127,
  127)`` with one float32 scale per output channel, ``amax / 127`` over
  the contraction axes, kept with ``keepdim`` so dequantization is one
  broadcast multiply; an all-zero channel gets scale 1.0. Rounding is to
  nearest even (``torch.round``, as ``jnp.round``), so quantizing the
  same tree twice gives the same bytes.
- **What quantizes** (:func:`reduce_axes_for`, on the Flax names the
  port keeps): ``tok_embed.embedding`` per row, the attention ``qkv``
  kernel ``[D, 3, H, hd]`` over axis 0, ``out`` ``[H, hd, D]`` over axes 0
  and 1, the MLP ``fc1``/``fc2`` kernels over axis 0.
- **What stays high-precision:** layernorms, biases, ``pos_embed``,
  ``lm_head`` and MoE experts.

Representation: :class:`QuantizedTensor` (``q`` int8 in the weight's
shape, ``scale`` float32) stands where the ``nn.Parameter`` stood
(:func:`install_params`). Its ``to(dtype)`` dequantizes, so the modules'
``self.kernel.to(self.dtype)`` call sites serve it with no branch; the
token embedding gathers the rows first and dequantizes only those
(``models/gpt.py``'s ``Embed``). A parameter set is a dict of the
model's parameter names to tensors or :class:`QuantizedTensor`
(:func:`serving_params`); the engine swaps such sets by installing
their leaves, which copies nothing.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

# Symmetric int8 range: ±127, so q and -q are both representable.
Q_MAX = 127.0


class QuantizedTensor:
    """A per-channel int8 weight: ``q`` int8 (the weight's shape) and
    ``scale`` float32 (``keepdim``-reduced, broadcast-ready)."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    def to(self, dtype: torch.dtype) -> torch.Tensor:
        """Dequantize to ``dtype``: the method the modules' kernel use
        sites already call (JAX's duck-typed ``astype``)."""
        return self.q.to(dtype) * self.scale.to(dtype)

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.to(dtype)

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def nbytes(self) -> int:
        """Stored bytes (int8 values and float32 scales)."""
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def __repr__(self) -> str:
        return (f"QuantizedTensor(q={tuple(self.q.shape)} int8, "
                f"scale={tuple(self.scale.shape)})")


def reduce_axes_for(path: str) -> tuple[int, ...] | None:
    """Contraction axes the per-channel scales reduce over for the leaf
    at ``path`` ('/'-joined Flax names), or None when it stays
    high-precision (JAX's rule, see the module docstring)."""
    if path.endswith("tok_embed/embedding"):
        return (1,)
    if path.endswith("/kernel") or path == "kernel":
        if path.endswith("attn/qkv/kernel"):
            return (0,)
        if path.endswith("attn/out/kernel"):
            return (0, 1)
        if path.endswith("fc1/kernel") or path.endswith("fc2/kernel"):
            return (0,)
    return None


def quantize_array(w: torch.Tensor, reduce_axes: tuple[int, ...]) -> QuantizedTensor:
    """Symmetric per-channel int8 of one weight: ``scale = amax / 127``
    over ``reduce_axes`` (keepdim), round to nearest even, clipped; an
    all-zero channel gets scale 1.0."""
    w32 = w.detach().float()
    amax = w32.abs().amax(dim=reduce_axes, keepdim=True)
    scale = torch.where(amax > 0, amax / Q_MAX, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale), -Q_MAX, Q_MAX).to(torch.int8)
    return QuantizedTensor(q, scale)


def quantize_params(params: dict[str, Any]) -> dict[str, Any]:
    """Quantize every eligible leaf of a parameter set (names as the
    model's, see :func:`reduce_axes_for`); the other leaves pass as they
    are. Pure and deterministic."""
    out = {}
    for name, leaf in params.items():
        axes = reduce_axes_for(name.replace(".", "/"))
        out[name] = (quantize_array(leaf, axes)
                     if axes is not None and not isinstance(leaf, QuantizedTensor)
                     else leaf)
    return out


def is_quantized(params: dict[str, Any]) -> bool:
    """True when the set holds at least one :class:`QuantizedTensor`."""
    return any(isinstance(v, QuantizedTensor) for v in params.values())


def quantized_param_bytes(params: dict[str, Any]) -> int:
    """Stored bytes of the quantized leaves (the ``quantized_params_bytes``
    gauge); 0 for a set without any."""
    return sum(v.nbytes for v in params.values() if isinstance(v, QuantizedTensor))


def dequantize_params(params: dict[str, Any],
                      dtype: torch.dtype = torch.float32) -> dict[str, Any]:
    """The set with every quantized leaf expanded to ``dtype`` (the
    quality and dequant-at-use checks' reference, never the serving
    path)."""
    return {n: v.dequantize(dtype) if isinstance(v, QuantizedTensor) else v
            for n, v in params.items()}


def serving_params(model: nn.Module) -> dict[str, Any]:
    """The leaves ``model`` serves, by parameter name: its parameters and
    the :class:`QuantizedTensor` that stand where parameters stood. The
    values are the model's own objects (no copy)."""
    out = {}
    for mod_name, mod in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        for leaf, p in mod._parameters.items():
            if p is not None:
                out[prefix + leaf] = p
        for leaf, v in vars(mod).items():
            if isinstance(v, QuantizedTensor):
                out[prefix + leaf] = v
    return out


def install_params(model: nn.Module, params: dict[str, Any]) -> None:
    """Point ``model``'s leaves at ``params`` (names as
    :func:`serving_params` gives them): a tensor becomes the parameter
    (sharing its storage), a :class:`QuantizedTensor` takes the
    parameter's place as a plain attribute. Copies nothing."""
    modules = dict(model.named_modules())
    for name, value in params.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = modules[mod_name]
        if isinstance(value, QuantizedTensor):
            mod._parameters.pop(leaf, None)
            mod.__dict__[leaf] = value
        else:
            mod.__dict__.pop(leaf, None)
            if not isinstance(value, nn.Parameter):
                value = nn.Parameter(value, requires_grad=False)
            mod._parameters[leaf] = value


def params_signature(params: dict[str, Any]) -> dict[str, tuple]:
    """Each leaf's structure, shape and dtype: what a swap candidate must
    match to serve in place of the current set."""
    out = {}
    for name, v in params.items():
        if isinstance(v, QuantizedTensor):
            out[name] = ("int8", tuple(v.q.shape), v.q.dtype, tuple(v.scale.shape),
                         v.scale.dtype)
        elif isinstance(v, torch.Tensor):
            out[name] = ("dense", tuple(v.shape), v.dtype)
        else:
            out[name] = ("unknown", type(v).__name__)
    return out
