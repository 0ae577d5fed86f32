"""Model registry: name → ``nn.Module`` factory (the ResNet family).

The JAX package's other models (``vit_b16``, ``moe_mlp``,
``transformer_lm``) are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

import torch

from distributed_training_tpu_torch.models.resnet import STAGE_SIZES, make_resnet

NOT_PORTED = ("moe_mlp", "transformer_lm", "vit_b16")


def available_models() -> list[str]:
    return sorted(STAGE_SIZES)


def get_model(
    name: str,
    *,
    num_classes: int = 10,
    dtype: torch.dtype = torch.float32,
    axis_name: str | None = None,
    **kwargs: Any,
):
    """Instantiate a model by name (``kwargs`` go to :class:`ResNet`, e.g.
    ``stem`` or ``generator``)."""
    if name in NOT_PORTED:
        raise NotImplementedError(f"model {name!r} is not ported yet")
    if name not in STAGE_SIZES:
        raise ValueError(f"unknown model {name!r}; available: {available_models()}")
    if axis_name is not None:
        raise NotImplementedError(
            "cross-replica BatchNorm (axis_name) needs multi-GPU data "
            "parallelism, which is not ported yet")
    return make_resnet(name, num_classes=num_classes, dtype=dtype, **kwargs)
