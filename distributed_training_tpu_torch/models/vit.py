"""Vision Transformer (ViT-B/16), numerically matching the Flax model of
``distributed_training_tpu/models/vit.py``.

- **Names and layouts** are the Flax ones, so ``bridge.py`` carries the
  tree as it is: ``patch_embed`` (the ``p × p`` stride-``p`` VALID conv,
  ``kernel`` HWIO), ``cls_token`` ``[1, 1, d]``, ``pos_embed`` ``[1, T, d]``
  (``T`` the patches plus the class token), ``encoder_{i}`` with
  ``LayerNorm_0``, ``attn`` (``query``/``key``/``value`` kernels ``[d, H,
  hd]`` and biases ``[H, hd]``, ``out`` kernel ``[H, hd, d]``),
  ``LayerNorm_1`` and ``MlpBlock_0`` (``fc1``, ``fc2``), then
  ``encoder_norm`` and ``head``.
- **Initial values** follow the Flax initialisers' distributions:
  ``lecun_normal`` kernels (fan-in ``d`` for q/k/v, ``H·hd`` for ``out``,
  ``p·p·3`` for the patch conv), zero biases and class token, ``pos_embed``
  normal with std 0.02, the head zero.
- **Dtypes.** ``dtype`` is the compute dtype: the image is cast to it,
  every product takes its operands in it and adds its bias in it, the
  LayerNorms take their statistics in float32 and return ``dtype``, and
  the logits come out in float32. ``param_dtype`` (the patch conv, the
  class token, ``pos_embed`` and the head, as in Flax; the encoder's
  leaves stay float32) is the parameters' storage dtype.
- **Attention** is Flax's ``dot_product_attention`` in the installed Flax:
  the query divided by ``√hd`` (rounded to ``dtype``), the score einsum,
  the softmax in ``dtype``, the broadcast dropout of the weights (one
  ``[q, k]`` mask for every row and head), the value einsum. It runs on
  ``torch.matmul`` and ``torch.softmax`` as the JAX package runs it outside
  any kernel (no SDPA, whose precision is not this one).
- **Dropout** (``dropout_rate``, training only): after the embedding, on
  the attention weights, after the MLP's GELU and after ``fc2``, with
  masks from the step's ``torch.Generator`` (not JAX's bits). **Remat**:
  each encoder block runs under ``torch.utils.checkpoint`` in training
  (``nn.remat(EncoderBlock)``), its recompute restoring the generator so
  it draws the same masks.
- **Sequence parallelism** (``seq_axis`` on ``mesh``): each block's
  attention is the port's ``RingSelfAttention`` (``qkv``/``out``,
  non-causal, exact), as JAX's ``seq_axis_name`` swaps its
  ``RingSelfAttention`` in; the JAX Trainer never sets it.

**Tensor parallelism** (``parallel/tensor_parallel.py``'s rule table,
``shard_model_`` sets each sharded layer's ``tp``): q/k/v hold this model
rank's heads and ``fc1`` its MLP columns (column-parallel, megatron's *f*
on their input), ``attn/out`` and ``fc2`` its contraction rows
(row-parallel: the partial products summed, *g*, then the bias once), the
head its classes (the logits gathered over the model ranks). The
activations between blocks stay replicated. Under ``tp_overlap`` (JAX's
``replicated_overlap_interceptor``) the column-parallel products run
locally without *f*, each row-parallel sum is a column-mode
``matmul_reducescatter`` ring followed by a ``ring_all_gather``, and the
head is replicated; the step completes the gradients
(``collective_matmul.overlap_finalize_grads``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from distributed_training_tpu_torch.models.gpt import LayerNorm, dropout
from distributed_training_tpu_torch.models.moe import PatchEmbed
from distributed_training_tpu_torch.parallel.collective_matmul import (
    matmul_reducescatter,
    ring_all_gather,
)
from distributed_training_tpu_torch.parallel.ring_attention import (
    RingSelfAttention,
    lecun_normal_,
)
from distributed_training_tpu_torch.parallel.tensor_parallel import (
    copy_to_model,
    gather_from_model,
    reduce_from_model,
)


def _plain_tp(tp) -> bool:
    """The declarative megatron schedule (not the overlap rings)."""
    return tp is not None and not tp.overlap


def _row_matmul(x: torch.Tensor, w: torch.Tensor, tp) -> torch.Tensor:
    """``x @ w`` for a row-parallel ``w`` (this rank's contraction rows),
    summed over the model ranks: one all-reduce, or under ``tp_overlap`` a
    column-mode reduce-scatter ring fused with the partial products, then
    an all-gather ring."""
    if tp is None:
        return x @ w
    if tp.overlap:
        if w.shape[-1] % tp.size:
            raise ValueError(
                f"tp_overlap: hidden dim (= {w.shape[-1]}) must divide by the "
                f"model-axis size {tp.size} (out-proj scatter); pick divisible "
                f"dims or disable tp_overlap")
        return ring_all_gather(matmul_reducescatter(x, w, tp.group, -1), tp.group, -1)
    return reduce_from_model(x @ w, tp)


class Dense(nn.Module):
    """Flax ``Dense`` (kernel ``[in, out]``, zero bias), computed in
    ``dtype``; ``row_parallel`` sums the model ranks' partial products
    before the bias, a column-parallel layer is local (its caller puts
    *f* in front), and ``gather`` makes it a class-parallel output layer
    (*f* on its input, its output all-gathered over the model ranks)."""

    def __init__(self, d_in: int, features: int, *, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, row_parallel: bool = False,
                 gather: bool = False, zero_init: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype, self.row_parallel, self.gather, self.tp = dtype, row_parallel, gather, None
        self.kernel = nn.Parameter(torch.zeros(d_in, features))
        if not zero_init:
            lecun_normal_(self.kernel, d_in, generator)
        self.kernel.data = self.kernel.data.to(param_dtype)
        self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x, k = x.to(dt), self.kernel.to(dt)
        if self.row_parallel:
            return _row_matmul(x, k, self.tp) + self.bias.to(dt)
        gather = self.gather and _plain_tp(self.tp)
        if gather:
            x = copy_to_model(x, self.tp)
        y = x @ k + self.bias.to(dt)
        return gather_from_model(y, self.tp) if gather else y


class HeadsProj(nn.Module):
    """Flax ``DenseGeneral`` to ``(H, hd)`` (``query``, ``key``,
    ``value``): kernel ``[d, H, hd]``, bias ``[H, hd]``; ``[..., d]`` →
    ``[..., H, hd]`` (this model rank's heads under TP)."""

    def __init__(self, d: int, heads: int, head_dim: int, *, dtype: torch.dtype,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype, self.tp = dtype, None
        self.kernel = nn.Parameter(torch.empty(d, heads, head_dim))
        lecun_normal_(self.kernel, d, generator)
        self.bias = nn.Parameter(torch.zeros(heads, head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        d, h, hd = self.kernel.shape
        y = x.to(dt) @ self.kernel.to(dt).reshape(d, h * hd)
        return y.view(*y.shape[:-1], h, hd) + self.bias.to(dt)


class OutProj(nn.Module):
    """Flax ``DenseGeneral`` over the last two axes (``out``): kernel
    ``[H, hd, d]``, bias ``[d]``; row-parallel over the heads."""

    def __init__(self, heads: int, head_dim: int, d: int, *, dtype: torch.dtype,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype, self.tp = dtype, None
        self.kernel = nn.Parameter(torch.empty(heads, head_dim, d))
        lecun_normal_(self.kernel, heads * head_dim, generator)
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h, hd, d = self.kernel.shape
        y = _row_matmul(x.to(dt).reshape(*x.shape[:-2], h * hd),
                        self.kernel.to(dt).reshape(h * hd, d), self.tp)
        return y + self.bias.to(dt)


class MultiHeadDotProductAttention(nn.Module):
    """Flax ``MultiHeadDotProductAttention`` as ``ViT`` uses it (self
    attention, no mask, ``force_fp32_for_softmax`` off)."""

    def __init__(self, d: int, num_heads: int, *, dtype: torch.dtype,
                 dropout_rate: float = 0.0, generator: torch.Generator | None = None):
        super().__init__()
        if d % num_heads:
            raise ValueError(f"Memory dimension ({d}) must be divisible by number "
                             f"of heads ({num_heads}).")
        hd = d // num_heads
        self.dtype, self.dropout_rate = dtype, dropout_rate
        self.query = HeadsProj(d, num_heads, hd, dtype=dtype, generator=generator)
        self.key = HeadsProj(d, num_heads, hd, dtype=dtype, generator=generator)
        self.value = HeadsProj(d, num_heads, hd, dtype=dtype, generator=generator)
        self.out = OutProj(num_heads, hd, d, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        tp = self.query.tp
        if _plain_tp(tp):
            x = copy_to_model(x, tp)
        q, k, v = self.query(x), self.key(x), self.value(x)  # [B, T, H, hd]
        dt = self.dtype
        depth = float(torch.tensor(math.sqrt(q.shape[-1]), dtype=torch.float32).to(dt))
        # Filled on the device, not copied from the host: a CUDA graph of
        # the step can capture it.
        q = q / torch.full((), depth, dtype=dt, device=q.device)
        # '...qhd,...khd->...hqk'
        w = torch.matmul(q.transpose(-3, -2), k.permute(0, 2, 3, 1))
        w = torch.softmax(w, dim=-1)
        rate = self.dropout_rate if train else 0.0
        if rate:
            w = dropout(w, rate, generator, shape=(1, 1, *w.shape[-2:]))
        o = torch.matmul(w, v.transpose(-3, -2)).transpose(-3, -2)  # [B, T, H, hd]
        return self.out(o)


class MlpBlock(nn.Module):
    """``fc1`` → GELU (tanh) → dropout → ``fc2`` → dropout."""

    def __init__(self, d: int, mlp_dim: int, *, dtype: torch.dtype,
                 dropout_rate: float = 0.0, generator: torch.Generator | None = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.fc1 = Dense(d, mlp_dim, dtype=dtype, generator=generator)
        self.fc2 = Dense(mlp_dim, d, dtype=dtype, row_parallel=True, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        tp = self.fc1.tp
        if _plain_tp(tp):
            x = copy_to_model(x, tp)
        rate = self.dropout_rate if train else 0.0
        h = dropout(F.gelu(self.fc1(x), approximate="tanh"), rate, generator, tp=tp)
        return dropout(self.fc2(h), rate, generator)


class EncoderBlock(nn.Module):
    """Pre-LN block: LN → attention → residual → LN → MLP → residual."""

    def __init__(self, d: int, num_heads: int, mlp_dim: int, *, dtype: torch.dtype,
                 dropout_rate: float = 0.0, seq_axis: str | None = None, mesh=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(d, dtype)
        if seq_axis is not None:
            self.attn = RingSelfAttention(d, num_heads, dtype=dtype, causal=False,
                                          attn_impl="exact", axis_name=seq_axis,
                                          mesh=mesh, generator=generator)
        else:
            self.attn = MultiHeadDotProductAttention(d, num_heads, dtype=dtype,
                                                     dropout_rate=dropout_rate,
                                                     generator=generator)
        self.LayerNorm_1 = LayerNorm(d, dtype)
        self.MlpBlock_0 = MlpBlock(d, mlp_dim, dtype=dtype, dropout_rate=dropout_rate,
                                   generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        y = self.LayerNorm_0(x)
        if isinstance(self.attn, RingSelfAttention):
            y = self.attn(y)
        else:
            y = self.attn(y, train, generator)
        x = x + y
        return x + self.MlpBlock_0(self.LayerNorm_1(x), train, generator)


class ViT(nn.Module):
    """ViT with a learnable class token and learned 1D position embeddings:
    NHWC images → float32 logits ``[B, num_classes]``. ``image_size`` fixes
    ``pos_embed``'s length (Flax takes it from the first input)."""

    def __init__(self, num_classes: int = 1000, *, patch_size: int = 16,
                 hidden_size: int = 768, num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, image_size: int = 224,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, dropout_rate: float = 0.0,
                 seq_axis: str | None = None, mesh=None, remat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if seq_axis is not None and mesh is None:
            raise ValueError(f"seq_axis {seq_axis!r} needs the mesh that binds it")
        # The Flax module's fields, which the FLOP count and the TP checks read.
        self.num_classes, self.patch_size, self.hidden_size = num_classes, patch_size, hidden_size
        self.num_layers, self.num_heads, self.mlp_dim = num_layers, num_heads, mlp_dim
        self.dtype, self.dropout_rate, self.remat = dtype, dropout_rate, remat
        self.tp = None
        d = hidden_size
        self.patch_embed = PatchEmbed(patch_size, 3, d, dtype=dtype, generator=generator)
        for p in self.patch_embed.parameters():
            p.data = p.data.to(param_dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, dtype=param_dtype))
        tokens = (image_size // patch_size) ** 2 + 1
        self.pos_embed = nn.Parameter(torch.empty(1, tokens, d))
        with torch.no_grad():
            nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=generator)
        self.pos_embed.data = self.pos_embed.data.to(param_dtype)
        for i in range(num_layers):
            self.add_module(f"encoder_{i}", EncoderBlock(
                d, num_heads, mlp_dim, dtype=dtype, dropout_rate=dropout_rate,
                seq_axis=seq_axis, mesh=mesh, generator=generator))
        self.encoder_norm = LayerNorm(d, dtype)
        self.head = Dense(d, num_classes, dtype=dtype, param_dtype=param_dtype,
                          gather=True, zero_init=True)

    def forward(self, x: torch.Tensor, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
        train = self.training
        rate = self.dropout_rate if train else 0.0
        if rate and generator is None:
            raise ValueError("dropout in training needs the step's generator")
        b, d = x.shape[0], self.hidden_size
        x = self.patch_embed(x.to(self.dtype))
        cls = self.cls_token.to(self.dtype).expand(b, 1, d)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        x = dropout(x, rate, generator)
        remat = self.remat and train and torch.is_grad_enabled()
        for i in range(self.num_layers):
            block = getattr(self, f"encoder_{i}")
            x = (_remat_block(block, x, generator) if remat
                 else block(x, train, generator))
        x = self.encoder_norm(x)[:, 0]
        return self.head(x).float()


def _remat_block(block: EncoderBlock, x: torch.Tensor,
                 generator: torch.Generator | None) -> torch.Tensor:
    """``block(x)`` in training under a non-reentrant checkpoint; the
    recompute starts from the generator state the first forward began
    with, so it draws the same dropout masks."""
    start = generator.get_state() if generator is not None else None

    def run(x):
        if generator is not None:
            generator.set_state(start)
        return block(x, True, generator)

    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)


def make_vit(*, num_classes: int = 1000, dtype: torch.dtype = torch.float32,
             axis_name: str | None = None, seq_axis_name: str | None = None,
             **kwargs) -> ViT:
    """Registry factory (the JAX ``make_vit``'s fields; ``seq_axis_name``
    is ``seq_axis`` and needs ``mesh``); ``axis_name`` (the registry's
    SyncBN slot) is unused: no BatchNorm."""
    del axis_name
    return ViT(num_classes, dtype=dtype, seq_axis=seq_axis_name, **kwargs)
