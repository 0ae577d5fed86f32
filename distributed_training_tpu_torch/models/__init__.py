"""Model registry: name → ``nn.Module`` factory (the ResNet family,
``moe_mlp``, ``transformer_lm`` and ``vit_b16``), the JAX package's
registry."""

from __future__ import annotations

from typing import Any

import torch

from distributed_training_tpu_torch.models.gpt import make_transformer_lm
from distributed_training_tpu_torch.models.moe import make_moe_classifier
from distributed_training_tpu_torch.models.resnet import STAGE_SIZES, make_resnet
from distributed_training_tpu_torch.models.vit import make_vit

NOT_PORTED: tuple[str, ...] = ()


def available_models() -> list[str]:
    return sorted([*STAGE_SIZES, "moe_mlp", "transformer_lm", "vit_b16"])


def get_model(
    name: str,
    *,
    num_classes: int = 10,
    dtype: torch.dtype = torch.float32,
    axis_name: str | None = None,
    **kwargs: Any,
):
    """Instantiate a model by name (``kwargs`` go to :class:`ResNet`, e.g.
    ``stem`` or ``generator``, to ``make_moe_classifier``,
    ``make_transformer_lm`` or ``make_vit``). ``axis_name`` is the JAX registry's SyncBN
    slot: the port's BatchNorm takes its group from
    ``resnet.set_batchnorm_group``, so a name here raises."""
    if name in NOT_PORTED:
        raise NotImplementedError(f"model {name!r} is not ported yet")
    if name == "transformer_lm":
        return make_transformer_lm(num_classes=num_classes, dtype=dtype,
                                   axis_name=axis_name, **kwargs)
    if name == "vit_b16":
        return make_vit(num_classes=num_classes, dtype=dtype, axis_name=axis_name,
                        **kwargs)
    if name == "moe_mlp":
        return make_moe_classifier(num_classes=num_classes, dtype=dtype,
                                   axis_name=axis_name, **kwargs)
    if name not in STAGE_SIZES:
        raise ValueError(f"unknown model {name!r}; available: {available_models()}")
    if axis_name is not None:
        raise ValueError(
            "axis_name has no meaning in the port: SyncBN takes its process "
            "group from models.resnet.set_batchnorm_group")
    return make_resnet(name, num_classes=num_classes, dtype=dtype, **kwargs)
