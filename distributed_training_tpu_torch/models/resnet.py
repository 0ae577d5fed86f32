"""ResNet family in PyTorch, numerically matching the Flax models of
``distributed_training_tpu/models/resnet.py``.

What it takes to match the Flax model:

- **SAME padding.** Flax pads ``total // 2`` before and the rest after.
  For a stride-2 3×3 conv at an even size that is (0, 1), not PyTorch's
  (1, 1); the 7×7/2 stem at 32 pads (2, 3), and the 3×3/2 SAME max-pool
  pads (0, 1) with −inf. :func:`same_pads` computes the pads from the
  input size, and an asymmetric pad goes through an explicit ``F.pad``.
- **BatchNorm running statistics.** Flax updates ``var`` with the
  *biased* batch variance and keeps ``momentum = 0.9`` of the old value;
  ``torch.nn.BatchNorm2d`` blends in the unbiased variance. So
  :class:`BatchNorm` updates its buffers itself and lets ``F.batch_norm``
  only normalize. The last BN of each block starts with a zero scale.
- **Layout.** The public input is NHWC, as the JAX package's batches are.
  ``permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is an NCHW tensor
  in ``channels_last`` memory, the layout cuDNN prefers, so no copy is
  made; the weights are kept ``channels_last`` too.
- **Names.** Submodules carry the Flax names (``conv_init``,
  ``stage{i}_block{j}``, ``Conv_0``, ``BatchNorm_1``, ``Dense_0``...), so
  ``bridge.py`` maps one tree onto the other by name.
- **Precision.** Parameters are float32; ``dtype`` is the compute type
  (float16 for the fp16 policy). BatchNorm statistics and the logits are
  float32, as in Flax.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# Flax's BatchNorm momentum: the weight of the OLD running value.
BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """Flax/XLA ``padding="SAME"`` for one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0):
    """Returns ``(x, symmetric_pad)``: pads ``x`` explicitly when the SAME
    pad is asymmetric, else leaves it to the op's own ``padding``."""
    ph = same_pads(x.shape[2], kernel, stride)
    pw = same_pads(x.shape[3], kernel, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


class Conv(nn.Module):
    """Bias-free 2D conv with Flax SAME padding; weight is OIHW."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # kaiming_normal(fan_out), Flax's variance_scaling(2, fan_out, normal).
        fan_out = self.weight.shape[0] * self.kernel * self.kernel
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.kernel == 1:
            # A strided 1×1 conv is a subsample and a 1×1 conv (SAME adds
            # no pad). Written so because the CPU (oneDNN) backward of a
            # strided 1×1 channels_last conv crashes at some shapes.
            return F.conv2d(x[:, :, ::self.stride, ::self.stride],
                            self.weight.to(self.dtype))
        x, pad = _pad_same(x, self.kernel, self.stride)
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride,
                        padding=pad)


class BatchNorm(nn.Module):
    """BatchNorm over N, H, W with Flax's running-statistics rule."""

    def __init__(self, channels: int, zero_scale: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.zero_scale, self.dtype = zero_scale, dtype
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.weight.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, BN_EPS)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            BN_EPS)


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int, dtype):
        super().__init__()
        self.Conv_0 = Conv(in_ch, filters, 3, stride, dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype=dtype)
        self.Conv_1 = Conv(filters, filters, 3, 1, dtype)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True, dtype=dtype)
        if stride != 1 or in_ch != filters:
            self.downsample_conv = Conv(in_ch, filters, 1, stride, dtype)
            self.downsample_bn = BatchNorm(filters, dtype=dtype)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        if hasattr(self, "downsample_conv"):
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    """1x1 → 3x3 → 1x1 bottleneck block (ResNet-50/101/152)."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int, dtype):
        super().__init__()
        out = filters * 4
        self.Conv_0 = Conv(in_ch, filters, 1, 1, dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype=dtype)
        self.Conv_1 = Conv(filters, filters, 3, stride, dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype=dtype)
        self.Conv_2 = Conv(filters, out, 1, 1, dtype)
        self.BatchNorm_2 = BatchNorm(out, zero_scale=True, dtype=dtype)
        if stride != 1 or in_ch != out:
            self.downsample_conv = Conv(in_ch, out, 1, stride, dtype)
            self.downsample_bn = BatchNorm(out, dtype=dtype)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if hasattr(self, "downsample_conv"):
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(x + y)


class ResNet(nn.Module):
    """Configurable ResNet; ``forward`` takes NHWC images and returns
    float32 logits.

    ``stem``: 'imagenet' (7x7/2 conv + 3x3/2 max-pool, what torchvision
    applies even to CIFAR in the reference) or 'cifar' (3x3/1, no pool).
    """

    def __init__(self, stage_sizes, block_cls, num_classes: int = 10,
                 num_filters: int = 64, stem: str = "imagenet",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if stem not in ("imagenet", "cifar"):
            raise ValueError(f"unknown stem {stem!r}")
        self.stem, self.dtype = stem, dtype
        if stem == "imagenet":
            self.conv_init = Conv(3, num_filters, 7, 2, dtype)
        else:
            self.conv_init = Conv(3, num_filters, 3, 1, dtype)
        self.bn_init = BatchNorm(num_filters, dtype=dtype)
        in_ch = num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                self.add_module(f"stage{i}_block{j}",
                                block_cls(in_ch, filters, stride, dtype))
                in_ch = filters * block_cls.expansion
        self.Dense_0 = nn.Linear(in_ch, num_classes)
        self.reset_parameters(generator or torch.Generator().manual_seed(0))
        self.to(memory_format=torch.channels_last)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, (Conv, BatchNorm)):
                m.reset_parameters(generator)
        # Flax Dense: variance_scaling(1/3, fan_in, uniform), zero bias.
        bound = math.sqrt(1.0 / self.Dense_0.in_features)
        with torch.no_grad():
            self.Dense_0.weight.uniform_(-bound, bound, generator=generator)
            self.Dense_0.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)          # NHWC → NCHW view, channels_last
        x = F.relu(self.bn_init(self.conv_init(x)))
        if self.stem == "imagenet":
            x, pad = _pad_same(x, 3, 2, value=-math.inf)
            x = F.max_pool2d(x, 3, 2, padding=pad)
        for name, block in self.named_children():
            if name.startswith("stage"):
                x = block(x)
        x = x.mean(dim=(2, 3))
        x = F.linear(x, self.Dense_0.weight.to(self.dtype),
                     self.Dense_0.bias.to(self.dtype))
        return x.float()


STAGE_SIZES = {
    # resnet_micro: 4 stages of 1 block, 8 filters (~12k params) with the
    # full structural surface; it exists for the tests.
    "resnet_micro": ((1, 1, 1, 1), BasicBlock),
    "resnet18": ((2, 2, 2, 2), BasicBlock),
    "resnet34": ((3, 4, 6, 3), BasicBlock),
    "resnet50": ((3, 4, 6, 3), BottleneckBlock),
    "resnet101": ((3, 4, 23, 3), BottleneckBlock),
    "resnet152": ((3, 8, 36, 3), BottleneckBlock),
}


def make_resnet(name: str, **kwargs) -> ResNet:
    sizes, block = STAGE_SIZES[name]
    if name == "resnet_micro":
        kwargs.setdefault("num_filters", 8)
    return ResNet(stage_sizes=sizes, block_cls=block, **kwargs)
