"""Analytic per-step FLOPs and MFU accounting.

The port's copy of ``distributed_training_tpu/observability/flops.py``
for the models the port has (the ResNet family and the GPT LM), with the
same conventions, so that an MFU of one package compares with the other's:

- **matmul FLOPs only**: a ``[M, K] × [K, N]`` product counts ``2·M·K·N``;
  elementwise work (LayerNorm, GELU, softmax, BatchNorm) is excluded;
- **backward = 2× forward**, so a train step is ``3× forward``;
  recomputation is not charged;
- **attention is charged full-T²** (``4·B·T²·D`` per layer forward), the
  published convention even for causal models: kernels that skip the
  masked half (the flash kernels do) report a conservative MFU;
- callers pass the *effective* batch of one optimizer update.

The peak table holds the card's dense bf16 tensor-core rate, keyed by
``torch.cuda.get_device_name()``; every throughput configuration the port
ships computes its matmuls in bf16.
"""

from __future__ import annotations

import math
import os
from typing import Any

import torch

# Dense (no sparsity) bf16 tensor-core peak of one card, FLOP/s, by
# torch.cuda.get_device_name(). Source: NVIDIA H100 Tensor Core GPU
# Architecture white paper, H100 SXM5, "Peak BF16 Tensor TFLOPS with FP32
# Accumulate: 989.4" (1,978.9 with sparsity; the data sheet rounds it to
# 1,979), at the card's 700 W limit.
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}

# Environment override (a CPU smoke run that still wants a numeric MFU,
# or a card the table does not know): peak FLOP/s of one device.
PEAK_FLOPS_ENV = "OBS_PEAK_FLOPS"


def device_peak_flops(device=None) -> float | None:
    """Peak dense bf16 FLOP/s of one card; None when unknown (no card, or
    one the table does not list). ``$OBS_PEAK_FLOPS`` overrides."""
    env = os.environ.get(PEAK_FLOPS_ENV)
    if env:
        return float(env)
    if not torch.cuda.is_available():
        return None
    return PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(device))


def mfu(model_flops_per_sec: float, n_devices: int,
        peak_per_device: float | None) -> float | None:
    """``model_flops_per_sec / (n_devices × peak)``; None when peak is."""
    if not peak_per_device or n_devices < 1:
        return None
    return model_flops_per_sec / (n_devices * peak_per_device)


# -- forward-FLOPs formulas (matmul-only, multiply-add = 2) ----------------

def gpt_forward_flops(*, num_layers: int, hidden_dim: int, seq_len: int,
                      vocab_size: int, mlp_ratio: int = 4, batch: int = 1) -> int:
    """Decoder-only transformer forward FLOPs (``models/gpt.py`` dims).

    Per layer and sequence: QKV and out projections ``8·T·D²``, full-T²
    attention scores and values ``4·T²·D``, MLP ``4·r·T·D²``; plus the
    ``lm_head`` vocab projection ``2·T·D·V``."""
    d, t = hidden_dim, seq_len
    per_layer = 8 * t * d * d + 4 * t * t * d + 4 * mlp_ratio * t * d * d
    return batch * (num_layers * per_layer + 2 * t * d * vocab_size)


def resnet_forward_flops(stage_sizes, bottleneck: bool, *, image_size: int,
                         num_classes: int, num_filters: int, batch: int = 1,
                         stem: str = "imagenet") -> int:
    """ResNet forward FLOPs, mirroring ``models/resnet.py``: the stem
    (7×7/2 and a 3×3/2 max-pool, or CIFAR's 3×3/1), per-stage blocks with
    stride 2 at each stage's first block past the first stage, 1×1
    downsample convolutions where the residual's shape changes, and the
    dense head. SAME padding: spatial sizes ceil-divide by the stride."""
    def conv(h_out: int, k: int, cin: int, cout: int) -> int:
        return 2 * h_out * h_out * k * k * cin * cout

    nf = num_filters
    h = image_size
    fl = 0
    if stem == "imagenet":
        h = math.ceil(h / 2)
        fl += conv(h, 7, 3, nf)
        h = math.ceil(h / 2)  # max-pool 3x3/2 SAME
    elif stem == "cifar":
        fl += conv(h, 3, 3, nf)
    else:
        raise ValueError(f"unknown stem {stem!r}")
    cin = nf
    for i, nblocks in enumerate(stage_sizes):
        f = nf * 2 ** i
        out_ch = f * 4 if bottleneck else f
        for j in range(nblocks):
            stride = 2 if (i > 0 and j == 0) else 1
            h_out = math.ceil(h / stride)
            if bottleneck:
                fl += conv(h, 1, cin, f)        # 1x1 at the input's size
                fl += conv(h_out, 3, f, f)      # strided 3x3
                fl += conv(h_out, 1, f, f * 4)
            else:
                fl += conv(h_out, 3, cin, f)    # strided 3x3
                fl += conv(h_out, 3, f, f)
            if stride != 1 or cin != out_ch:
                fl += conv(h_out, 1, cin, out_ch)  # downsample projection
            cin = out_ch
            h = h_out
    fl += 2 * cin * num_classes
    return batch * fl


def vit_forward_flops(*, image_size: int, patch_size: int, hidden_size: int,
                      num_layers: int, mlp_dim: int, num_classes: int,
                      batch: int = 1) -> int:
    """ViT forward FLOPs (JAX ``vit_forward_flops``): the patch-embed conv,
    the encoder blocks over ``(image/patch)² + 1`` tokens (the class
    token), and the head on the class token's row."""
    n = (image_size // patch_size) ** 2
    t, d = n + 1, hidden_size
    fl = 2 * n * patch_size * patch_size * 3 * d
    fl += num_layers * (8 * t * d * d + 4 * t * t * d + 4 * t * d * mlp_dim)
    fl += 2 * d * num_classes
    return batch * fl


def forward_flops(model: Any, *, image_size: int | None = None,
                  seq_len: int | None = None, batch: int = 1) -> int | None:
    """Forward FLOPs of a model instance, from the dims it was built with
    (``TransformerLM``: vocab, width, depth, MLP ratio; ``ResNet``: stage
    sizes, block kind, filters, stem, classes; ``ViT``: patch, width,
    depth, MLP width, classes). None for a model without
    a formula, and for an LM with MoE layers, as in JAX: the routed FLOPs
    depend on the capacity and the dispatch, and a wrong static guess is
    worse than no MFU."""
    from distributed_training_tpu_torch.models.gpt import TransformerLM
    from distributed_training_tpu_torch.models.resnet import BottleneckBlock, ResNet
    from distributed_training_tpu_torch.models.vit import ViT

    if isinstance(model, TransformerLM):
        experts = model.moe_num_experts
        if any(int(e) > 0 for e in (experts if isinstance(experts, (tuple, list))
                                    else (experts,))):
            return None
        if seq_len is None:
            raise ValueError("forward_flops for an LM needs seq_len=")
        return gpt_forward_flops(
            num_layers=model.num_layers, hidden_dim=model.hidden_dim,
            seq_len=seq_len, vocab_size=model.vocab_size,
            mlp_ratio=model.mlp_ratio, batch=batch)
    if isinstance(model, (ResNet, ViT)) and image_size is None:
        raise ValueError("forward_flops for an image model needs image_size=")
    if isinstance(model, ViT):
        return vit_forward_flops(
            image_size=image_size, patch_size=model.patch_size,
            hidden_size=model.hidden_size, num_layers=model.num_layers,
            mlp_dim=model.mlp_dim, num_classes=model.num_classes, batch=batch)
    if isinstance(model, ResNet):
        return resnet_forward_flops(
            model.stage_sizes, model.block_cls is BottleneckBlock,
            image_size=image_size, num_classes=model.num_classes,
            num_filters=model.num_filters, batch=batch, stem=model.stem)
    return None


def train_step_flops(forward: int | None) -> int | None:
    """Model FLOPs of one optimizer step: forward and backward, 3× the
    forward."""
    return None if forward is None else 3 * forward
