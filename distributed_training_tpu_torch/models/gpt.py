"""Decoder-only transformer LM (GPT), numerically matching the Flax model
of ``distributed_training_tpu/models/gpt.py`` on its unsharded path.

What it takes to match the Flax model:

- **Names and layouts.** Modules and parameters carry the Flax names
  (``tok_embed.embedding``, ``pos_embed``, ``block{i}.ln1.scale``,
  ``block{i}.attn.qkv.kernel``, ``block{i}.mlp.fc1.kernel``,
  ``ln_f``, ``lm_head``) and the Flax layouts (Dense kernels ``[in,
  out]``), so ``bridge.py`` carries the tree over unchanged.
- **LayerNorm** (:class:`LayerNorm`): ε = 1e-6; mean and the fast
  variance ``E[x²] − E[x]²`` (floored at 0) in float32 whatever the input
  dtype; ``(x − mean)·(rsqrt(var + ε)·scale) + bias``, then cast to the
  compute dtype.
- **Dense** (:class:`Dense`): input and kernel cast to the compute dtype
  before the product, the bias added after, in that dtype.
- **GELU** is the tanh approximation (Flax ``nn.gelu``'s default).
- **Embeddings**: the token table is cast to the compute dtype and then
  gathered; the float32 positional rows are gathered, then cast.
- **The head** runs in ``logits_dtype``.

Parameters are float32; ``dtype`` is the compute dtype. The initial values
follow the Flax initialisers' distributions from a ``torch.Generator``
(not the same numbers as JAX's PRNG: the tests carry weights over with
``bridge.py``).

- **Dropout** (``dropout_rate``): after each block's attention and its
  MLP, in training only, as the Flax block applies it; kept values are
  divided by the keep probability. The masks come from an explicit
  ``torch.Generator`` that the train step passes in (``forward``'s
  ``generator``), so a run's masks depend on its seed, step and rank
  alone (not the same bits as JAX's PRNG).
- **Remat** (``remat``): each :class:`DecoderBlock` runs under
  ``torch.utils.checkpoint`` (non-reentrant) in training, so its
  activations are recomputed in the backward instead of kept. The
  checkpoint restores only the default CPU and CUDA generators, so the
  block restores the explicit generator's state itself before a
  recompute, which then draws the same dropout masks. Attention's forward
  (K2 with ``attn_impl="flash"``) runs again in each recompute.
- ``forward(..., return_hidden=True)`` returns the final-norm hidden
  states instead of the logits: the chunked cross-entropy applies the head
  itself (``train/lm_step.py``).
- The forward's pieces, :func:`embed`, :func:`run_block` and
  :func:`final` (JAX ``make_tok_embed``/``add_pos_embed``, the block,
  ``make_final_norm``/``make_lm_head``), are also what a pipeline stage
  runs (``parallel/pipeline.py``).
- **Sequence parallelism** (``seq_axis`` on ``mesh``, a
  ``runtime.mesh.Mesh``): ``tokens`` is this rank's time chunk, the
  positional embedding reads *global* positions (the chunk's offset on
  the axis plus ``0..T_local-1``, JAX's ``_global_positions``), and every
  block's attention runs the ring over the axis.
- **Tensor parallelism** (``parallel/tensor_parallel.py``'s
  ``shard_model_``, after the whole model is built): the projections, the
  MLP, the embedding and the head hold this rank's shards and run the
  megatron products; under ``tp_overlap`` the embedding's output is cut to
  this rank's time chunk on the way into block 0 (JAX's interceptor does
  the same), the stack runs time-sharded and the logits stay so.

- **MoE** (``moe_num_experts``, :func:`moe_layer_experts`): every
  ``moe_every``-th block's MLP is a ``models/moe.py`` ``MoEMlp`` named
  ``moe_mlp``; ``forward(..., return_aux=True)`` returns the blocks'
  summed, weighted load-balancing loss beside the logits or hidden states
  (Flax sows it into the ``aux_loss`` collection). Under data and expert
  parallelism the layers run over the mesh's groups once
  ``moe.shard_experts_`` has set them (under a sequence axis each shard
  gates its own tokens; under tensor parallelism every model rank runs
  the layer whole).

- **Decode** (``forward(..., cache=...)``, JAX's ``decode=True``): the
  dense KV-cache path of ``inference/``. ``cache`` is a
  ``parallel.ring_attention.KVCache`` from :meth:`TransformerLM.init_cache`
  (``cache_len`` slots, default ``max_len``); each block writes this call's
  K/V into its layer at the cache's index and attends over the whole
  cache, and the call advances the index by its length, in place.
  ``positions`` feeds the positional embedding only and is required (JAX's
  refusal); its rows are clamped to the table, as JAX's gather clamps
  them, so a call past the end comes out NaN (the attention's poison)
  rather than raising. MoE FFNs run position-wise over the call's tokens,
  the gate's capacity from their count, as in JAX. JAX's refusals and
  messages: no positions, ``cache_len`` above ``max_len``, a sequence
  axis, ``kv_dtype`` without the paged cache. A ``KVCache`` whose index is
  a ``[B]`` tensor gives each row its own write head (the serving
  engine's legacy slots); the call advances every head by its length.

- **Paged decode** (``forward(..., cache=pool, pages=PagedKV(...))``,
  JAX's ``pages=`` on the paged clone): the serving engine's default
  cache. ``pool`` is a ``parallel.ring_attention.PagedCache`` from
  :meth:`TransformerLM.init_paged_cache`; ``pages`` routes each row
  through its page table, and ``positions`` must equal
  ``pages.positions`` (the embedding and the pool read the same rows).
  Nothing is advanced: the write heads are the caller's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from distributed_training_tpu_torch.parallel.ring_attention import (
    KVCache,
    PagedCache,
    PagedKV,
    RingSelfAttention,
    lecun_normal_,
)
from distributed_training_tpu_torch.parallel.tensor_parallel import (
    column_matmul,
    row_matmul,
    vocab_parallel_embed,
)

LN_EPS = 1e-6


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm`` over the last dim (see the module docstring)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + LN_EPS) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


class Dense(nn.Module):
    """Flax ``Dense``: kernel ``[in, out]``, ``lecun_normal`` init, zero
    bias; computes in ``dtype``. ``row_parallel`` says which megatron
    product it runs under tensor parallelism (``tp``): row-parallel (a
    contraction shard, the bias after the sum) or column-parallel."""

    def __init__(self, d_in: int, features: int, *,
                 dtype: torch.dtype = torch.float32, use_bias: bool = True,
                 row_parallel: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype, self.row_parallel, self.tp = dtype, row_parallel, None
        self.kernel = nn.Parameter(torch.empty(d_in, features))
        lecun_normal_(self.kernel, d_in, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        matmul = row_matmul if self.row_parallel else column_matmul
        y = matmul(x.to(self.dtype), self.kernel.to(self.dtype), self.tp)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class Embed(nn.Module):
    """Flax ``nn.Embed``: ``embedding`` ``[vocab, D]`` drawn from a normal
    of standard deviation ``1/√D``."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype, self.tp = dtype, None
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))
        with torch.no_grad():
            nn.init.normal_(self.embedding, 0.0, math.sqrt(1.0 / features),
                            generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        q = getattr(self.embedding, "q", None)
        if q is not None:
            # A per-row int8 table (serving/quantize.py): gather the rows
            # and their scales, and dequantize only those (JAX's branch).
            return q[tokens].to(self.dtype) * self.embedding.scale[tokens].to(self.dtype)
        table = self.embedding.to(self.dtype)
        if self.tp is not None:  # vocab-parallel
            return vocab_parallel_embed(tokens, table, self.tp)
        return F.embedding(tokens, table)


class MlpBlock(nn.Module):
    """Position-wise MLP: fc1 → GELU (tanh) → fc2."""

    def __init__(self, hidden_dim: int, mlp_dim: int,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fc1 = Dense(hidden_dim, mlp_dim, dtype=dtype, generator=generator)
        self.fc2 = Dense(mlp_dim, hidden_dim, dtype=dtype, row_parallel=True,
                         generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            shape=None, tp=None) -> torch.Tensor:
    """Flax ``nn.Dropout`` in training: keep each value with probability
    ``1 − rate`` (uniform draws from ``generator`` at or above ``rate``),
    divided by that probability; the rest 0. ``shape`` broadcasts one mask
    (default ``x``'s shape); ``tp`` (a column-parallel output) draws the
    whole layer's mask and keeps this model rank's columns, so every
    layout draws the masks of model 1."""
    if not rate:
        return x
    shape = tuple(x.shape) if shape is None else tuple(shape)
    if tp is not None:
        shape = (*shape[:-1], shape[-1] * tp.size)
    keep = torch.rand(shape, generator=generator, device=x.device) >= rate
    if tp is not None:
        n = shape[-1] // tp.size
        keep = keep[..., tp.index * n:(tp.index + 1) * n]
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


class DecoderBlock(nn.Module):
    """Pre-LN causal block: LN → attention → (dropout) → residual → LN →
    FFN → (dropout) → residual. The FFN is the dense MLP, or with
    ``moe_num_experts > 0`` an ``MoEMlp`` (``moe`` its other arguments);
    ``forward`` returns ``(x, weighted aux loss)``."""

    def __init__(self, hidden_dim: int, num_heads: int, mlp_dim: int, *,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "exact",
                 dropout_rate: float = 0.0, seq_axis: str | None = None,
                 mesh=None, generator: torch.Generator | None = None,
                 moe_num_experts: int = 0, moe: dict | None = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.ln1 = LayerNorm(hidden_dim, dtype)
        self.attn = RingSelfAttention(hidden_dim, num_heads, dtype=dtype,
                                      causal=True, attn_impl=attn_impl,
                                      axis_name=seq_axis, mesh=mesh,
                                      generator=generator)
        self.ln2 = LayerNorm(hidden_dim, dtype)
        if moe_num_experts > 0:
            from distributed_training_tpu_torch.models.moe import MoEMlp

            self.moe_mlp = MoEMlp(hidden_dim, moe_num_experts, mlp_dim, dtype=dtype,
                                  generator=generator, **(moe or {}))
        else:
            self.mlp = MlpBlock(hidden_dim, mlp_dim, dtype, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                cache: KVCache | PagedCache | None = None, layer: int = 0,
                pages: PagedKV | None = None):
        """``cache``: the decode path over the cache's layer ``layer``
        (with ``pages``, the paged pool's)."""
        rate = self.dropout_rate if self.training else 0.0
        if rate and generator is None:
            raise ValueError("dropout in training needs the step's generator")
        x = x + dropout(self.attn(self.ln1(x), cache, layer, pages), rate, generator)
        if hasattr(self, "moe_mlp"):
            y, aux = self.moe_mlp(self.ln2(x), self.training, generator)
        else:
            y, aux = self.mlp(self.ln2(x)), torch.zeros((), device=x.device)
        return x + dropout(y, rate, generator), aux


def moe_layer_experts(num_layers: int, moe_every: int,
                      moe_num_experts) -> dict[int, int]:
    """{layer index: expert count} for the MoE layers of a decoder stack
    (JAX ``moe_layer_experts``): an int is that count at every
    ``moe_every``-th layer; a tuple gives per-MoE-layer counts (length 1
    broadcasts, length = number of MoE layers assigns in order, any other
    length raises)."""
    counts = (tuple(int(c) for c in moe_num_experts)
              if isinstance(moe_num_experts, (tuple, list))
              else (int(moe_num_experts),))
    if moe_every <= 0 or not any(counts):
        return {}
    layers = [i for i in range(num_layers) if i % moe_every == moe_every - 1]
    if len(counts) == 1:
        counts = counts * len(layers)
    if len(counts) != len(layers):
        raise ValueError(
            f"per-layer expert counts {counts} do not match the "
            f"{len(layers)} MoE layers (num_layers={num_layers}, "
            f"moe_every={moe_every}); pass one count or exactly "
            f"{len(layers)}")
    return dict(zip(layers, counts))


def _remat_block(block: DecoderBlock, x: torch.Tensor,
                 generator: torch.Generator | None):
    """``block(x, generator)`` under a non-reentrant checkpoint; the
    recompute starts from the generator state the first forward began
    with, so it draws the same dropout masks (see the module docstring)."""
    start = generator.get_state() if generator is not None else None

    def run(x):
        if generator is not None:
            generator.set_state(start)
        return block(x, generator)

    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)


def run_block(block: DecoderBlock, x: torch.Tensor,
              generator: torch.Generator | None, remat: bool):
    """``block(x, generator)``, under :func:`_remat_block` with ``remat``:
    the per-layer step of the plain stack and of a pipeline stage."""
    return _remat_block(block, x, generator) if remat else block(x, generator)


def embed(model: nn.Module, tokens: torch.Tensor,
          positions: torch.Tensor | None = None) -> torch.Tensor:
    """The stack's input: token embedding plus positional rows (JAX
    ``make_tok_embed`` and ``add_pos_embed``), from ``model``'s
    ``tok_embed``, ``pos_embed``, ``dtype``, ``max_len`` and, with a
    ``seq_axis``, the chunk's *global* positions on ``model.mesh``."""
    if positions is None:
        t, offset = tokens.shape[-1], 0
        if model.seq_axis is not None:
            offset = model.mesh.index(model.seq_axis) * t
            t *= model.mesh.size(model.seq_axis)
        # Gathers past the table would fail here, where JAX clamps
        # them silently: check the (global) length, as JAX does.
        if t > model.max_len:
            raise ValueError(f"sequence length {t} exceeds "
                             f"max_len={model.max_len}")
        positions = offset + torch.arange(tokens.shape[-1],
                                          device=tokens.device)[None, :]
    x = model.tok_embed(tokens)
    return x + model.pos_embed[positions].to(model.dtype)


def final(model: nn.Module, x: torch.Tensor, return_hidden: bool = False) -> torch.Tensor:
    """The final LayerNorm, then the head unless ``return_hidden`` (JAX
    ``make_final_norm`` and ``make_lm_head``)."""
    x = model.ln_f(x)
    return x if return_hidden else model.lm_head(x)


class TransformerLM(nn.Module):
    """GPT-style causal LM: ``tokens`` int ``[B, T]`` (and optional
    ``positions`` ``[B, T]``, default ``0..T-1``, or the chunk's global
    positions with ``seq_axis``) → logits ``[B, T, vocab]`` in
    ``logits_dtype`` (this rank's vocabulary or time shard under tensor
    parallelism)."""

    def __init__(self, vocab_size: int, *, num_layers: int = 4,
                 num_heads: int = 4, hidden_dim: int = 256, mlp_ratio: int = 4,
                 max_len: int = 2048, dtype: torch.dtype = torch.float32,
                 logits_dtype: torch.dtype = torch.float32,
                 head_bias: bool = False, attn_impl: str = "exact",
                 dropout_rate: float = 0.0, remat: bool = False,
                 seq_axis: str | None = None, mesh=None,
                 generator: torch.Generator | None = None,
                 moe_num_experts: int | tuple = 0, moe_every: int = 2,
                 moe: dict | None = None):
        super().__init__()
        if seq_axis is not None and mesh is None:
            raise ValueError(f"seq_axis {seq_axis!r} needs the mesh that binds it")
        self.num_layers, self.max_len, self.dtype = num_layers, max_len, dtype
        self.dropout_rate, self.remat = dropout_rate, remat
        self.seq_axis, self.mesh, self.tp = seq_axis, mesh, None
        # The Flax module's fields, which the FLOP count reads.
        self.vocab_size, self.hidden_dim, self.mlp_ratio = vocab_size, hidden_dim, mlp_ratio
        self.moe_num_experts, self.moe_every = moe_num_experts, moe_every
        experts_by_layer = moe_layer_experts(num_layers, moe_every, moe_num_experts)
        self.noisy_gate_policy = (moe or {}).get("noisy_gate_policy") if experts_by_layer else None
        self.tok_embed = Embed(vocab_size, hidden_dim, dtype, generator)
        self.pos_embed = nn.Parameter(torch.empty(max_len, hidden_dim))
        with torch.no_grad():
            nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=generator)
        for i in range(num_layers):
            self.add_module(f"block{i}", DecoderBlock(
                hidden_dim, num_heads, mlp_ratio * hidden_dim, dtype=dtype,
                attn_impl=attn_impl, dropout_rate=dropout_rate,
                seq_axis=seq_axis, mesh=mesh, generator=generator,
                moe_num_experts=experts_by_layer.get(i, 0), moe=moe))
        self.ln_f = LayerNorm(hidden_dim, dtype)
        self.lm_head = Dense(hidden_dim, vocab_size, dtype=logits_dtype,
                             use_bias=head_bias, generator=generator)

    def init_cache(self, batch: int, cache_len: int | None = None, *,
                   device=None, kv_dtype: str | None = None) -> KVCache:
        """An empty decode cache of ``cache_len`` slots (default
        ``max_len``) for ``batch`` rows, in the compute dtype."""
        cache_len = self.max_len if cache_len is None else int(cache_len)
        self._check_cache_len(cache_len)
        attn = self.block0.attn
        _, _, heads, head_dim = attn.qkv.kernel.shape
        return KVCache.empty(layers=self.num_layers, batch=batch, cache_len=cache_len,
                             heads=heads, head_dim=head_dim, dtype=self.dtype,
                             device=self.pos_embed.device if device is None else device,
                             kv_dtype=kv_dtype)

    def init_paged_cache(self, kv_pages: int, kv_page_size: int, *, device=None,
                         kv_dtype: str | None = None) -> PagedCache:
        """An empty paged pool of ``kv_pages`` physical pages (the null page
        0 included) of ``kv_page_size`` positions, in the compute dtype:
        JAX's ``init_decode_cache`` on the paged clone."""
        attn = self.block0.attn
        _, _, heads, head_dim = attn.qkv.kernel.shape
        return PagedCache.empty(layers=self.num_layers, kv_pages=kv_pages,
                                page_size=kv_page_size, heads=heads, head_dim=head_dim,
                                dtype=self.dtype,
                                device=self.pos_embed.device if device is None else device,
                                kv_dtype=kv_dtype)

    def _check_cache_len(self, cache_len: int) -> None:
        if cache_len > self.max_len:
            # Slots past max_len would decode at clamped positional rows.
            raise ValueError(
                f"cache_len={cache_len} exceeds the positional table "
                f"(max_len={self.max_len})")

    def forward(self, tokens: torch.Tensor,
                positions: torch.Tensor | None = None, *,
                generator: torch.Generator | None = None,
                return_hidden: bool = False, return_aux: bool = False,
                cache: KVCache | PagedCache | None = None,
                pages: PagedKV | None = None):
        """Logits, or with ``return_hidden`` the final-norm hidden states
        ``[B, T, hidden]``; with ``return_aux`` also the MoE layers'
        summed load-balancing loss (a float32 0-d tensor, 0 without MoE).
        ``generator`` draws the dropout masks and the noisy gates' noise in
        training (needed when ``dropout_rate`` > 0). ``cache``: the decode
        path (see the module docstring), which advances ``cache.index``;
        with ``pages`` the paged pool's, which advances nothing."""
        if cache is not None:
            if positions is None:
                raise ValueError(
                    "decode=True requires explicit positions (the pos-embed row "
                    "of each incoming token)")
            if pages is None:
                self._check_cache_len(cache.cache_len)
            # JAX's gather clamps a row past the table; the attention's
            # poison then marks the call.
            positions = positions.clamp(0, self.max_len - 1)
        x = embed(self, tokens, positions)
        if self.tp is not None and self.tp.overlap:
            x = self._time_shard(x)
        remat = (self.remat and self.training and torch.is_grad_enabled()
                 and cache is None)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(self.num_layers):
            block = getattr(self, f"block{i}")
            if cache is not None:
                x, a = block(x, generator, cache, i, pages)
            else:
                x, a = run_block(block, x, generator, remat)
            aux = aux + a
        if cache is not None and pages is None:
            cache.index = cache.index + tokens.shape[1]
        out = final(self, x, return_hidden)
        return (out, aux) if return_aux else out

    def _time_shard(self, x: torch.Tensor) -> torch.Tensor:
        """The stack's entry under ``tp_overlap``: this model rank's time
        chunk of the (replicated) embedding output."""
        n, t = self.tp.size, x.shape[1]
        if t % n:
            raise ValueError(
                f"tp_overlap: per-stage sequence length (= {t}) must divide by "
                f"the model-axis size {n} (time scatter at the stack entry); "
                f"pick divisible dims or disable tp_overlap")
        tl = t // n
        return x[:, self.tp.index * tl:(self.tp.index + 1) * tl]


def make_transformer_lm(*, num_classes: int = 256,
                        dtype: torch.dtype = torch.float32,
                        axis_name: str | None = None,
                        seq_axis: str | None = None, mesh=None,
                        num_layers: int = 4,
                        num_heads: int = 4, hidden_dim: int = 256,
                        mlp_ratio: int = 4, max_len: int = 2048,
                        dropout_rate: float = 0.0, attn_impl: str = "exact",
                        moe_num_experts: int | tuple = 0, moe_every: int = 2,
                        moe_top_k: int = 1, moe_capacity_factor: float = 1.25,
                        moe_min_capacity: int = 0,
                        moe_noisy_gate_policy: str | None = None,
                        moe_mlp_type: str = "standard",
                        remat: bool = False,
                        logits_dtype: torch.dtype = torch.float32,
                        head_bias: bool = False,
                        generator: torch.Generator | None = None) -> TransformerLM:
    """Registry factory, with the JAX factory's arguments and ``mesh`` (the
    ``runtime.mesh.Mesh`` that binds ``seq_axis``). ``num_classes`` is the
    vocabulary size; ``axis_name`` (the registry's SyncBN slot) is unused.
    The JAX ``moe_expert_axis`` has no counterpart: the expert axis comes
    from the mesh (``moe.shard_experts_``), and so does the gate's scope
    under ``seq_axis`` (local to each shard, as in JAX)."""
    del axis_name
    moe = dict(top_k=moe_top_k, capacity_factor=moe_capacity_factor,
               min_capacity=moe_min_capacity, noisy_gate_policy=moe_noisy_gate_policy,
               mlp_type=moe_mlp_type)
    return TransformerLM(
        num_classes, num_layers=num_layers, num_heads=num_heads,
        hidden_dim=hidden_dim, mlp_ratio=mlp_ratio, max_len=max_len,
        dtype=dtype, logits_dtype=logits_dtype, head_bias=head_bias,
        attn_impl=attn_impl, dropout_rate=dropout_rate, remat=remat,
        seq_axis=seq_axis, mesh=mesh, generator=generator,
        moe_num_experts=moe_num_experts, moe_every=moe_every, moe=moe)
