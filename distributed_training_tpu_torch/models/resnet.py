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
- **Precision.** Parameters are float32 (``param_dtype``: bf16 for the
  bench's ``--param-dtype bf16``); ``dtype`` is the compute type (float16
  for the fp16 policy). BatchNorm statistics and the logits are float32
  whatever the two, as in Flax.
- **SyncBN.** The Flax model's ``axis_name`` becomes a process group
  (:func:`set_batchnorm_group`): in training, each :class:`BatchNorm`
  averages its per-channel mean and mean of squares over the ranks with
  one all-reduce, and takes the biased ``var = E[x²] − E[x]²``, clipped at
  0, as Flax computes it across an axis; its backward
  (:class:`_SyncBatchNorm`) all-reduces the two per-channel gradient sums. ``torch.nn.SyncBatchNorm`` is not used: it keeps the unbiased
  running variance and refuses CPU inputs. Without a group (or with
  ``sync_batchnorm=False``) the statistics are the rank's own.
- **Remat** (``remat=True``): each residual block runs under
  ``torch.utils.checkpoint`` (non-reentrant) in training, as Flax's
  ``nn.remat`` per block. The recompute in the backward runs the block's
  batch norms again; JAX's remat is functional, so its running statistics
  tick once, and here too: in the recompute each :class:`BatchNorm`
  normalises with the statistics its first forward computed, updates no
  running statistic and, with a group, makes no second all-reduce.
- **remat_policy="conv"** (Flax's ``save_only_these_names("conv_out")``,
  which implies remat): the checkpoint of each block keeps the outputs of
  its convolutions (``torch.utils.checkpoint``'s selective policy,
  :func:`save_conv_outputs`) and recomputes only the batch norms and
  ReLUs in the backward, under the same recompute rule for BatchNorm.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

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
        if self.stride > 1 and x.shape[2] == x.shape[3] == 1:
            # On a 1×1 image the SAME conv reads only its centre tap (the
            # rest is padding): a 1×1 conv with that tap. Written so because
            # the CPU (oneDNN) bf16 channels_last backward of the padded
            # strided conv returns garbage weight gradients at this size.
            c = self.kernel // 2
            return F.conv2d(x, self.weight[:, :, c:c + 1, c:c + 1].to(self.dtype))
        x, pad = _pad_same(x, self.kernel, self.stride)
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride,
                        padding=pad)


class _SyncBatchNorm(torch.autograd.Function):
    """Training BatchNorm over the batches of every rank of ``group``
    (equal local batches), with its own backward.

    Forward: each rank's per-channel means of x and x² in float32, averaged
    over the ranks by one all-reduce; ``var = E[x²] − E[x]²`` clipped at 0
    (Flax's statistics across an axis); then one normalisation pass. The
    backward is BatchNorm's closed form with the two per-channel gradient
    sums (of dy and of dy·(x − mean)) all-reduced in one call, so each
    rank's dx is the gradient of the sum of every rank's loss, which the
    step's gradient mean turns into that of the global batch's mean loss.
    Returns ``(y, mean, var)``; the statistics are not differentiable.
    ``stats``, the ``(mean, var)`` of an earlier forward on the same input
    (a remat recompute), replaces the statistics pass and its all-reduce.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, group, eps, stats=None):
        world = dist.get_world_size(group)
        if stats is None:
            dims = (0, 2, 3)
            xf = x.float()
            moments = torch.stack([xf.mean(dims), xf.square().mean(dims)])
            dist.all_reduce(moments, group=group)
            mean, mean2 = moments / world
            var = (mean2 - mean.square()).clamp_min(0.0)
        else:
            mean, var = stats
        y = F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps))
        ctx.group, ctx.count = group, x.numel() // x.shape[1] * world
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd = ctx.saved_tensors
        shape = (1, -1, 1, 1)
        dims = (0, 2, 3)
        dyf = dy.float()
        xmu = x.float() - mean.view(shape)
        sums = torch.stack([dyf.sum(dims), (dyf * xmu).sum(dims)])
        grad_weight, grad_bias = sums[1] * invstd, sums[0].clone()
        dist.all_reduce(sums, group=ctx.group)
        mean_dy, mean_dy_xmu = sums / ctx.count
        dx = (dyf - mean_dy.view(shape)
              - xmu * (invstd.square() * mean_dy_xmu).view(shape)) * (invstd * weight).view(shape)
        return dx.to(x.dtype), grad_weight, grad_bias, None, None, None


class BatchNorm(nn.Module):
    """BatchNorm over N, H, W with Flax's running-statistics rule; with a
    process group (``group``), synchronised over its ranks in training.
    Under remat (:func:`remat_block`) the recompute reuses the first
    forward's statistics (``_stats``) and ticks nothing."""

    def __init__(self, channels: int, zero_scale: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.zero_scale, self.dtype = zero_scale, dtype
        self.group = None
        self.recompute = False
        self._stats = None
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
        if self.group is not None:
            return self._sync_forward(x)
        if not self.recompute:
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
                self._tick(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            BN_EPS)

    def _tick(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)

    def _sync_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Statistics over every rank's batch (:class:`_SyncBatchNorm`)."""
        if self.recompute:
            y, _, _ = _SyncBatchNorm.apply(x, self.weight, self.bias, self.group,
                                           BN_EPS, self._stats)
            return y
        y, mean, var = _SyncBatchNorm.apply(x, self.weight, self.bias, self.group, BN_EPS)
        self._tick(mean, var)
        self._stats = (mean, var)
        return y


@contextlib.contextmanager
def _recomputing(block: nn.Module):
    """The block's batch norms in recompute mode while the body runs."""
    norms = [m for m in block.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.recompute = True
    try:
        yield
    finally:
        for m in norms:
            m.recompute = False
            m._stats = None


# The op the selective-checkpoint policy sees for F.conv2d, below
# autograd: aten.convolution.default, on the CPU and on the card (cuDNN's
# own ops run beneath it, out of the policy's sight).
_CONV_OPS = (torch.ops.aten.convolution.default,)
REMAT_POLICIES = (None, "conv")


def save_conv_outputs(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The "conv" policy: keep every convolution's output, recompute the
    rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _CONV_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_block(block: nn.Module, x: torch.Tensor, policy: str | None = None) -> torch.Tensor:
    """``block(x)`` under a non-reentrant checkpoint whose recompute runs
    the batch norms in recompute mode (see the module docstring); with
    ``policy="conv"`` the checkpoint keeps the convolutions' outputs."""
    calls = 0

    def run(x):
        nonlocal calls
        calls += 1
        if calls == 1:
            return block(x)
        with _recomputing(block):
            return block(x)

    if policy == "conv":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       save_conv_outputs)
    else:
        context_fn = torch.utils.checkpoint.noop_context_fn
    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False,
                                             context_fn=context_fn)


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
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 remat_policy: str | None = None,
                 param_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if stem not in ("imagenet", "cifar"):
            raise ValueError(f"unknown stem {stem!r}")
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r} (None | 'conv')")
        self.stem, self.dtype = stem, dtype
        # A policy implies remat, as in the Flax model.
        self.remat, self.remat_policy = remat or remat_policy is not None, remat_policy
        # The Flax module's fields, which the FLOP count reads.
        self.stage_sizes, self.block_cls = tuple(stage_sizes), block_cls
        self.num_classes, self.num_filters = num_classes, num_filters
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
        for p in self.parameters():  # the buffers (BN statistics) stay float32
            p.data = p.data.to(param_dtype)
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
        remat = self.remat and self.training and torch.is_grad_enabled()
        for name, block in self.named_children():
            if name.startswith("stage"):
                x = remat_block(block, x, self.remat_policy) if remat else block(x)
        x = x.mean(dim=(2, 3))
        x = F.linear(x, self.Dense_0.weight.to(self.dtype),
                     self.Dense_0.bias.to(self.dtype))
        return x.float()


def set_batchnorm_group(model: nn.Module, group) -> None:
    """SyncBN: every :class:`BatchNorm` of ``model`` reduces its training
    statistics over ``group`` (None: each rank its own)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


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
