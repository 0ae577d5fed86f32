"""Self-attention of the transformer LM: projections, exact attention,
the flash dispatch, and ring attention over the ``sequence`` axis.

The port of ``distributed_training_tpu/parallel/ring_attention.py``:
:func:`ring_attention` unsharded (the exact ``[T, T]`` softmax, or the
flash kernels K2/K3 with ``impl="flash"``) and over a bound
``axis_name``, the projections :class:`_QKVProj` and :class:`_OutProj`,
:class:`RingSelfAttention`, and the dense KV-cache decode
(:class:`KVCache`, :func:`decode_attend`: JAX's ``_decode_attend``), and
the serving engine's paged decode (:class:`PagedKV`, :class:`PagedCache`,
:func:`paged_decode_attend`: JAX's ``_paged_decode_attend``).

**Decode.** The cache is an explicit object the caller makes
(``TransformerLM.init_cache``) and passes to each forward, which updates
it in place: per layer K and V ``[B, cache_len, H, hd]`` and one write
index for the stack (JAX keeps one ``cache_index`` a layer; they move
together). A call writes its K/V at the index, attends each query over
the whole cache in float32 under the causal mask by global position, and
NaN-poisons the whole call when it runs past the end (a clamped write
would corrupt the history), as JAX does. The product is a plain one, as
in JAX, where decode reaches no Pallas kernel; the index is a host int,
so a decode step never reads the card. The serving engine's legacy
slots give each batch row its own write head (``index`` a ``[B]`` long
tensor on the device: JAX ``vmap``s the one-sequence decode over the
slots, so each has its own ``cache_index``): each row writes at its own
head, is masked by its own positions and poisoned alone when it runs
past the end.

**Paged decode** (the serving engine's default cache): one flat pool per
layer for K and one for V, ``[kv_pages * kv_page_size, H, hd]``, page 0
the null page (:class:`PagedCache`), and per-call routing
(:class:`PagedKV`: each row's page table, each token's position and
validity). A token writes row ``table[b, pos // ps] * ps + pos % ps``,
an invalid one the null page; each query row gathers its own table's
pages into an ``[L, H, hd]`` view (``L = pages_per_slot * ps``) and
attends with the causal mask by global position, the arithmetic of
:func:`decode_attend`, NaN-poisoning a row whose position is past its
table. The pools start zeroed: a masked score is 0 after the softmax,
but 0 × NaN is not, so stale or unwritten rows must hold numbers. With
``kv_dtype="int8"`` the pools hold int8 rows beside float32 per-row,
per-head scales (quantized on the scatter, dequantized in the gather,
the attention in float32), JAX's ``quant`` branch.

**Ring attention** (sequence parallelism): each rank holds one time
chunk of q, k and v, ``[B, H, T_local, hd]``; K/V blocks travel the ring
of the ``sequence`` group (``runtime.mesh.ring_shift``: after ``i`` hops
rank ``j`` holds the block of rank ``(j + i) mod n``), and the rank
accumulates its queries' attention over every block it sees:

- ``impl="exact"``: JAX's float32 online-softmax recurrence
  (:func:`_online_block_update`) on materialised block scores, masked
  causally by *global* positions; rows whose every key is masked come out
  as 0;
- ``impl="flash"``: each hop runs ``flash_attention_lse`` (K2, and K3
  with a nonzero lse cotangent in the backward) on the block, and the
  hops' ``(out, lse)`` pairs merge in float32 with ``logaddexp``
  (:func:`ring_merge`; ``NEG_INF = -1e30`` is finite, so the merge needs
  no guards). Relative to the rank's own chunk a block is the *diagonal*
  (the kernel's own causal mask is exact there), in the *past* (no mask)
  or in the *future* (no kernel runs): :func:`ring_hop`. The choice is a
  Python ``if`` on the rank's and the block's indices.

The backward is autograd's: through the merge, through each hop's
``flash_attention_lse`` and through the ring shift, whose backward is the
reverse hop, as in JAX's autodiff of its ring. :func:`ring_attention_virtual`
runs the same hops and merges for every rank of a ring inside one
process, on one device (the CPU tests and ``chip_smoke.py``'s ring phase).

Parameters keep the Flax names and layouts (``qkv.kernel`` ``[D, 3, H,
hd]``, ``qkv.bias`` ``[3, H, hd]``, ``out.kernel`` ``[H, hd, D]``,
``out.bias`` ``[D]``) and the Flax initialisers: ``lecun_normal`` drawn
on the 2-D ``(fan_in, fan_out)`` flattening, zero biases. Under tensor
parallelism (``parallel/tensor_parallel.py``) they hold this rank's
heads, and the projections run the column- and row-parallel products.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
from torch import nn

from distributed_training_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_lse,
)
from distributed_training_tpu_torch.parallel.tensor_parallel import (
    column_matmul,
    row_matmul,
)
from distributed_training_tpu_torch.runtime.mesh import ring_shift


class KVCache:
    """The dense decode cache of a decoder stack: ``keys[i]`` and
    ``values[i]`` ``[B, cache_len, H, hd]`` for layer ``i``, and the write
    index ``index`` (the number of positions written so far): a host int
    for the whole batch (``Generator``, ``BeamSearcher``), or a ``[B]``
    long tensor, one write head a row (the serving engine's legacy slots).
    The serving engine's default cache is the paged pool,
    :class:`PagedCache`.

    ``kv_dtype`` is the paged pool's storage dtype in JAX, refused here
    with JAX's message: the contiguous cache stores the compute dtype."""

    def __init__(self, keys: list, values: list, index: int | torch.Tensor = 0,
                 kv_dtype: str | None = None):
        if kv_dtype is not None:
            raise ValueError(
                "kv_dtype requires the paged cache (kv_page_size set); "
                "the legacy contiguous path keeps full-precision slots")
        self.keys, self.values = list(keys), list(values)
        self.index = index if isinstance(index, torch.Tensor) else int(index)

    @classmethod
    def empty(cls, *, layers: int, batch: int, cache_len: int, heads: int,
              head_dim: int, dtype: torch.dtype, device=None,
              kv_dtype: str | None = None) -> "KVCache":
        """Zeros at index 0 (JAX's freshly made cache)."""
        shape = (batch, cache_len, heads, head_dim)
        return cls([torch.zeros(shape, dtype=dtype, device=device) for _ in range(layers)],
                   [torch.zeros(shape, dtype=dtype, device=device) for _ in range(layers)],
                   kv_dtype=kv_dtype)

    @property
    def cache_len(self) -> int:
        return self.keys[0].shape[1]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (*self.keys, *self.values))

    def select_rows(self, rows: torch.Tensor) -> None:
        """Keep batch rows ``rows`` (an index tensor, repeats allowed) of
        every layer's K and V: beam search's reorder by parent and its
        K-fold repeat of the prompt's rows."""
        self.keys = [k.index_select(0, rows) for k in self.keys]
        self.values = [v.index_select(0, rows) for v in self.values]


def decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cache: KVCache, layer: int) -> torch.Tensor:
    """JAX's ``_decode_attend`` on ``[B, T_in, H, hd]``: write ``k``/``v``
    into layer ``layer`` of ``cache`` at ``cache.index`` (the caller
    advances the index), attend ``q`` over the whole cache; returns ``[B,
    T_in, H, hd]`` in ``v``'s dtype. A ``[B]`` tensor index is the
    per-row form (:func:`_decode_attend_rows`)."""
    if isinstance(cache.index, torch.Tensor):
        return _decode_attend_rows(q, k, v, cache, layer)
    t_in, hd = q.shape[1], q.shape[-1]
    i0, length = cache.index, cache.cache_len
    # JAX's dynamic_update_slice clamps the start so the write fits; the
    # poison below marks every such call.
    start = max(0, min(i0, length - t_in))
    cache.keys[layer][:, start:start + t_in] = k
    cache.values[layer][:, start:start + t_in] = v
    qh, kh, vh = (t.transpose(1, 2) for t in (q, cache.keys[layer], cache.values[layer]))
    s = torch.einsum("...qd,...kd->...qk", qh.float(), kh.float()) * _host_scale(hd, torch.float32)
    # Queries sit at i0..i0+T_in-1; slots past the write head are zeros,
    # masked with the future.
    qpos = i0 + torch.arange(t_in, device=q.device)
    kpos = torch.arange(length, device=q.device)
    s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
    if i0 + t_in > length:
        # Past the end: the clamped write corrupted history, so the whole
        # call is wrong, in-bounds rows too.
        s = torch.full_like(s, float("nan"))
    p = torch.softmax(s, dim=-1).to(vh.dtype)
    return torch.einsum("...qk,...kd->...qd", p, vh).transpose(1, 2)


def _decode_attend_rows(q, k, v, cache: KVCache, layer: int) -> torch.Tensor:
    """:func:`decode_attend` with one write head a row (``cache.index``
    ``[B]`` on the device): JAX's ``vmap`` of the one-sequence decode over
    the slots. Each row writes at its own head (clamped, as
    ``dynamic_update_slice`` clamps) by an indexed copy, is masked by its
    own positions and NaN-poisoned alone when it runs past the end."""
    b, t_in, _, hd = q.shape
    length = cache.cache_len
    i0 = cache.index.to(q.device)
    start = i0.clamp(0, length - t_in)
    cols = start[:, None] + torch.arange(t_in, device=q.device)
    rows = torch.arange(b, device=q.device)[:, None].expand(b, t_in)
    cache.keys[layer][rows, cols] = k
    cache.values[layer][rows, cols] = v
    qh, kh, vh = (t.transpose(1, 2) for t in (q, cache.keys[layer], cache.values[layer]))
    s = torch.einsum("...qd,...kd->...qk", qh.float(), kh.float()) * _host_scale(hd, torch.float32)
    qpos = i0[:, None] + torch.arange(t_in, device=q.device)          # [B, T_in]
    kpos = torch.arange(length, device=q.device)
    s = s.masked_fill(kpos[None, None, None, :] > qpos[:, None, :, None], float("-inf"))
    s = s.masked_fill((i0 + t_in > length)[:, None, None, None], float("nan"))
    p = torch.softmax(s, dim=-1).to(vh.dtype)
    return torch.einsum("...qk,...kd->...qd", p, vh).transpose(1, 2)


class PagedKV(NamedTuple):
    """Per-call paged routing (JAX's ``PagedKV``): ``table`` long ``[B,
    pages_per_slot]`` each row's logical → physical page map (unallocated
    entries point at the null page 0), ``positions`` long ``[B, T_in]``
    each incoming token's global position, ``valid`` bool ``[B, T_in]``
    the tokens that exist (the others write the null page and their
    outputs are discarded by the caller)."""

    table: torch.Tensor
    positions: torch.Tensor
    valid: torch.Tensor


class PagedCache:
    """The paged KV pool of a decoder stack: per layer one flat K and one
    flat V ``[kv_pages * page_size, H, hd]`` (``kv_pages`` counts the null
    page 0), zero-filled. ``kv_dtype`` is JAX's pool storage dtype:
    ``None`` stores the compute dtype; ``"int8"`` stores int8 pools with
    per-row, per-head float32 scales beside them (``key_scales``,
    ``value_scales`` ``[kv_pages * page_size, H]``), quantized on the
    scatter and dequantized in the gather of the same call; anything
    else is JAX's ``ValueError``. A row's scales sit at the row's own
    index, so they travel with its page through every alias."""

    def __init__(self, keys: list, values: list, page_size: int,
                 key_scales: list | None = None, value_scales: list | None = None):
        self.keys, self.values, self.page_size = list(keys), list(values), int(page_size)
        self.key_scales = None if key_scales is None else list(key_scales)
        self.value_scales = None if value_scales is None else list(value_scales)

    @property
    def kv_dtype(self) -> str | None:
        return None if self.key_scales is None else "int8"

    @classmethod
    def empty(cls, *, layers: int, kv_pages: int, page_size: int, heads: int,
              head_dim: int, dtype: torch.dtype, device=None,
              kv_dtype: str | None = None) -> "PagedCache":
        check_kv_dtype(kv_dtype)
        if kv_pages < 2 or page_size < 1:
            raise ValueError(f"a paged pool needs the null page and one more "
                             f"(kv_pages={kv_pages}) of page_size >= 1 "
                             f"(page_size={page_size})")
        rows = kv_pages * page_size
        shape = (rows, heads, head_dim)
        store = torch.int8 if kv_dtype == "int8" else dtype

        def pools(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=device) for _ in range(layers)]

        if kv_dtype == "int8":
            return cls(pools(shape, store), pools(shape, store), page_size,
                       pools((rows, heads), torch.float32), pools((rows, heads), torch.float32))
        return cls(pools(shape, store), pools(shape, store), page_size)

    @property
    def kv_pages(self) -> int:
        return self.keys[0].shape[0] // self.page_size

    @property
    def nbytes(self) -> int:
        scales = (*self.key_scales, *self.value_scales) if self.key_scales else ()
        return sum(t.numel() * t.element_size() for t in (*self.keys, *self.values, *scales))


def check_kv_dtype(kv_dtype: str | None) -> None:
    """JAX's pool dtypes: None or "int8"; anything else is refused."""
    if kv_dtype not in (None, "int8"):
        raise ValueError(f"kv_dtype must be None or 'int8', got {kv_dtype!r}")


def _quantize_rows(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 of each ``[..., hd]`` row: ``scale = amax / 127``
    over ``hd`` (1.0 for an all-zero row), round to nearest even. A row's
    scale depends on that row alone, so a request's pages do not depend
    on the batch."""
    r32 = rows.float()
    amax = r32.abs().amax(-1)
    scl = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(r32 / scl[..., None]), -127, 127).to(torch.int8)
    return q, scl


def paged_decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        cache: PagedCache, layer: int, pages: PagedKV) -> torch.Tensor:
    """JAX's ``_paged_decode_attend`` on ``[B, T_in, H, hd]``: scatter this
    call's K/V into layer ``layer``'s pool through ``pages``, then attend
    each query row over its own table's gathered view (see the module
    docstring); returns ``[B, T_in, H, hd]`` in ``v``'s dtype. ``T_in``
    is 1 (the decode lane), the prefill chunk, or the speculative verify
    window: each row attends the rows before it written in the same call.
    An int8 pool quantizes the rows on the scatter, dequantizes the
    gathered rows with their scales, and attends in float32."""
    b, t_in, _, hd = q.shape
    ps = cache.page_size
    table, positions, valid = pages
    n_pages = table.shape[1]
    quant = cache.key_scales is not None
    raw = positions // ps
    logical = raw.clamp(max=n_pages - 1)
    phys = table.gather(1, logical) * ps + positions % ps
    # Invalid tokens all write the null page (row < ps): the only place
    # repeated indices land, whose order does not matter. So does a token
    # past its table (JAX's take_along_axis fills its page with INT_MIN,
    # which times a power-of-two page size wraps to the null page); its
    # row is poisoned below.
    write = torch.where(valid & (raw < n_pages), phys, torch.zeros_like(phys)).reshape(-1)
    kp, vp = cache.keys[layer], cache.values[layer]
    k_rows = k.reshape(b * t_in, *k.shape[2:])
    v_rows = v.reshape(b * t_in, *v.shape[2:])
    l_all = n_pages * ps
    gather = (table[:, :, None] * ps + torch.arange(ps, device=table.device)).reshape(b, l_all)
    if quant:
        ks, vs = cache.key_scales[layer], cache.value_scales[layer]
        (kq, k_scl), (vq, v_scl) = _quantize_rows(k_rows), _quantize_rows(v_rows)
        kp[write], vp[write], ks[write], vs[write] = kq, vq, k_scl, v_scl
        kg = kp[gather].float() * ks[gather][..., None]              # [B, L, H, hd]
        vg = vp[gather].float() * vs[gather][..., None]
    else:
        kp[write] = k_rows.to(kp.dtype)
        vp[write] = v_rows.to(vp.dtype)
        kg, vg = kp[gather], vp[gather]                               # [B, L, H, hd]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, kg, vg))
    s = torch.einsum("...qd,...kd->...qk", qh.float(), kh.float()) * _host_scale(hd, torch.float32)
    kpos = torch.arange(l_all, device=q.device)
    s = s.masked_fill(kpos[None, None, None, :] > positions[:, None, :, None], float("-inf"))
    s = s.masked_fill((positions >= l_all)[:, None, :, None], float("nan"))
    p = torch.softmax(s, dim=-1).to(vh.dtype)
    out = torch.einsum("...qk,...kd->...qd", p, vh).transpose(1, 2)
    # The dequantized math ran in float32: hand back the compute dtype.
    return out.to(v.dtype) if quant else out


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Flax ``lecun_normal``: a normal truncated at ±2σ, rescaled so the
    standard deviation is ``1/√fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


@functools.lru_cache(maxsize=None)
def _host_scale(hd: int, dtype: torch.dtype) -> float:
    """``1/√hd`` as JAX computes it in ``dtype`` (the root rounded to the
    dtype, then its reciprocal in the dtype), as a Python float: a scalar
    operand, so multiplying by it copies nothing to the card."""
    root = torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dtype)
    return (1.0 / root).item()


def _scale(q: torch.Tensor) -> float:
    """``1/√hd`` for q's head width and dtype (:func:`_host_scale`)."""
    return _host_scale(q.shape[-1], q.dtype)


def _online_block_update(o, m, l, s, v):
    """One online-softmax step (JAX's ``_online_block_update``): running
    unnormalised ``o`` ``[..., Tq, d]``, row max ``m`` and row sum ``l``
    ``[..., Tq]``, updated by the block's scores ``s`` and values ``v``."""
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    correction = torch.exp(m - m_new)
    l_new = l * correction + p.sum(-1)
    o_new = o * correction[..., None] + torch.einsum("...qk,...kd->...qd", p, v)
    return o_new, m_new, l_new


def hop_kind(my_idx: int, src: int, causal: bool) -> str:
    """Where the block of ring index ``src`` lies for the queries of
    ``my_idx``: ``"full"`` (no mask: not causal), ``"diag"``, ``"past"``
    or ``"future"``."""
    if not causal:
        return "full"
    return "diag" if src == my_idx else "past" if src < my_idx else "future"


def ring_hop(q, k_blk, v_blk, kind: str):
    """One flash hop: ``flash_attention_lse`` on the block, with the causal
    mask on the diagonal; ``None`` for a future block (no kernel runs and
    the merge is skipped, which is what a ``NEG_INF`` lse would merge to)."""
    if kind == "future":
        return None
    return flash_attention_lse(q, k_blk, v_blk, causal=kind == "diag")


def ring_merge(o, lse_acc, out_h, lse_h):
    """Merge one hop's normalised ``(out_h, lse_h)`` into the float32
    accumulators ``(o, lse_acc)``: the online softmax lifted to normalised
    per-hop results."""
    lse_new = torch.logaddexp(lse_acc, lse_h)
    w_acc = torch.exp(lse_acc - lse_new)
    w_h = torch.exp(lse_h - lse_new)
    return o * w_acc[..., None] + out_h.float() * w_h[..., None], lse_new


def _exact_hop(o, m, l, qf, k_blk, v_blk, scale, kind, my_idx, src):
    """One exact hop: the block's float32 scores, masked by global
    positions, through :func:`_online_block_update`."""
    s = torch.einsum("...qd,...kd->...qk", qf, k_blk.float()) * scale
    if kind != "full":
        t, tk = qf.shape[-2], k_blk.shape[-2]
        qpos = my_idx * t + torch.arange(t, device=qf.device)
        kpos = src * t + torch.arange(tk, device=qf.device)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
    return _online_block_update(o, m, l, s, v_blk.float())


class _RankRing:
    """One rank's accumulation over the blocks it visits, for either impl."""

    def __init__(self, q, my_idx: int, causal: bool, impl: str):
        self.q, self.my_idx, self.causal, self.impl = q, my_idx, causal, impl
        self.o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        if impl == "flash":
            self.lse = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32,
                                  device=q.device)
        else:
            self.m = torch.full(q.shape[:-1], float("-inf"), dtype=torch.float32,
                                device=q.device)
            self.l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
            self.qf, self.scale = q.float(), _scale(q)

    def visit(self, k_blk, v_blk, src: int) -> None:
        kind = hop_kind(self.my_idx, src, self.causal)
        if self.impl == "flash":
            hop = ring_hop(self.q, k_blk, v_blk, kind)
            if hop is not None:
                self.o, self.lse = ring_merge(self.o, self.lse, *hop)
        else:
            self.o, self.m, self.l = _exact_hop(
                self.o, self.m, self.l, self.qf, k_blk, v_blk, self.scale, kind,
                self.my_idx, src)

    def result(self, dtype: torch.dtype) -> torch.Tensor:
        if self.impl == "flash":
            return self.o.to(dtype)
        # Fully masked rows have l == 0: their output is 0 (no 0/0).
        out = torch.where(self.l[..., None] > 0,
                          self.o / self.l.clamp_min(1e-30)[..., None],
                          torch.zeros((), device=self.o.device))
        return out.to(dtype)


class _KeepShifts(torch.autograd.Function):
    """Identity on ``out`` that takes the last shifted blocks as inputs too,
    with zero gradients: the ranks' backward then runs every shift's
    reverse hop, as JAX's transposes of its ``ppermute`` chain always run,
    also on a rank whose last blocks lie in its future (no kernel used
    them, and autograd would otherwise prune those hops on that rank
    alone, leaving its neighbours waiting)."""

    @staticmethod
    def forward(ctx, out, *blocks):
        ctx.shapes = [(b.shape, b.dtype, b.device) for b in blocks]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dev) for s, d, dev in ctx.shapes))


def _ring_over_group(q, k, v, *, group, n: int, my_idx: int, causal: bool,
                     impl: str) -> torch.Tensor:
    """The distributed loop: visit the rank's own block, then ``n - 1``
    blocks shifted in over ``group``."""
    acc = _RankRing(q, my_idx, causal, impl)
    k_blk, v_blk = k, v
    for i in range(n):
        acc.visit(k_blk, v_blk, (my_idx + i) % n)
        if i < n - 1:
            k_blk, v_blk = ring_shift(group, k_blk, v_blk)
    out = acc.result(v.dtype)
    if impl == "flash" and hop_kind(my_idx, (my_idx + n - 1) % n, causal) == "future":
        out = _KeepShifts.apply(out, k_blk, v_blk)
    return out


def ring_attention_virtual(q, k, v, n: int, *, causal: bool = False,
                           impl: str = "exact") -> torch.Tensor:
    """Ring attention over ``n`` virtual ranks in one process: ``q, k, v``
    ``[..., T, hd]`` are cut into ``n`` time chunks, and virtual rank
    ``r`` visits the blocks in the ring order rank ``r`` of a real ring
    sees, through the same hop and merge. Differentiable (a block's
    ``dk``/``dv`` sum over the ranks that visited it)."""
    if impl not in ("exact", "flash"):
        raise ValueError(f"unknown ring attention impl {impl!r}")
    qs, ks, vs = (x.chunk(n, dim=-2) for x in (q, k, v))
    outs = []
    for r in range(n):
        acc = _RankRing(qs[r].contiguous(), r, causal, impl)
        for i in range(n):
            src = (r + i) % n
            acc.visit(ks[src].contiguous(), vs[src].contiguous(), src)
        outs.append(acc.result(v.dtype))
    return torch.cat(outs, dim=-2)


def ring_attention(q, k, v, *, axis_name: str | None = None,
                   causal: bool = False, impl: str = "exact",
                   mesh=None) -> torch.Tensor:
    """Attention over ``[B, H, T_local, hd]``.

    ``axis_name`` None: the unsharded path. ``impl="exact"`` materialises
    the scores as the JAX package does: the product in the input dtype
    times ``1/√hd`` (itself in that dtype), the causal mask at the dtype's
    lowest value, softmax in float32, and the probabilities cast to
    ``v``'s dtype. ``impl="flash"`` is
    :func:`~distributed_training_tpu_torch.ops.flash_attention.flash_attention`.

    ``axis_name`` bound: ring attention over that axis of ``mesh`` (a
    ``runtime.mesh.Mesh``; see the module docstring), causal masks on
    global positions.
    """
    if impl not in ("exact", "flash"):
        raise ValueError(f"unknown ring attention impl {impl!r}")
    if axis_name is not None:
        if mesh is None:
            raise ValueError(f"ring attention over axis {axis_name!r} needs the "
                             f"mesh that binds it")
        return _ring_over_group(q, k, v, group=mesh.group(axis_name),
                                n=mesh.size(axis_name),
                                my_idx=mesh.index(axis_name), causal=causal,
                                impl=impl)
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal)
    s = torch.einsum("...qd,...kd->...qk", q, k) * _scale(q)
    if causal:
        t = q.shape[-2]
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(mask, torch.finfo(s.dtype).min)
    p = torch.softmax(s.float(), dim=-1)
    return torch.einsum("...qk,...kd->...qd", p.to(v.dtype), v)


class _QKVProj(nn.Module):
    """QKV projection emitting q, k, v as contiguous ``[B, H, T, hd]``
    tensors (what the flash kernels take); column-parallel under tensor
    parallelism (``tp``: this rank's heads)."""

    def __init__(self, d_in: int, num_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.tp = None
        self.kernel = nn.Parameter(torch.empty(d_in, 3, num_heads, head_dim))
        self.bias = nn.Parameter(torch.zeros(3, num_heads, head_dim))
        lecun_normal_(self.kernel, d_in, generator)

    def forward(self, x: torch.Tensor):
        d_in = x.shape[-1]
        _, _, h, hd = self.kernel.shape
        # One product for q, k and v, then the bias in the compute dtype
        # (two roundings, as the JAX einsum + bias); one copy puts the
        # heads before time.
        y = column_matmul(x.to(self.dtype),
                          self.kernel.to(self.dtype).reshape(d_in, 3 * h * hd), self.tp)
        y = y + self.bias.to(self.dtype).reshape(3 * h * hd)
        b, t = y.shape[:2]
        y = y.view(b, t, 3, h, hd).permute(2, 0, 3, 1, 4).contiguous()
        return y[0], y[1], y[2]


class _OutProj(nn.Module):
    """Output projection consuming ``[B, H, T, hd]``; row-parallel under
    tensor parallelism (the bias added once, after the sum)."""

    def __init__(self, num_heads: int, head_dim: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.tp = None
        self.kernel = nn.Parameter(torch.empty(num_heads, head_dim, features))
        self.bias = nn.Parameter(torch.zeros(features))
        lecun_normal_(self.kernel, num_heads * head_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, t, hd = x.shape
        y = x.to(self.dtype).permute(0, 2, 1, 3).reshape(b, t, h * hd)
        y = row_matmul(y, self.kernel.to(self.dtype).reshape(h * hd, -1), self.tp)
        return y + self.bias.to(self.dtype)


class RingSelfAttention(nn.Module):
    """Multi-head self-attention. ``attn_impl="flash"`` runs the K2/K3
    kernels on the card; with ``axis_name`` bound on ``mesh`` (a
    ``runtime.mesh.Mesh``) the sequence is sharded over that axis and the
    attention runs the ring (see the module docstring)."""

    def __init__(self, hidden_dim: int, num_heads: int, *,
                 dtype: torch.dtype = torch.float32, causal: bool = False,
                 attn_impl: str = "exact", axis_name: str | None = None,
                 mesh=None, generator: torch.Generator | None = None):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError(f"hidden {hidden_dim} not divisible by "
                             f"{num_heads} heads")
        if attn_impl not in ("exact", "flash"):
            raise ValueError(f"unknown ring attention impl {attn_impl!r}")
        if axis_name is not None and mesh is None:
            raise ValueError(f"sequence axis {axis_name!r} needs the mesh that "
                             f"binds it")
        head_dim = hidden_dim // num_heads
        self.causal, self.attn_impl = causal, attn_impl
        self.axis_name, self.mesh = axis_name, mesh
        self.qkv = _QKVProj(hidden_dim, num_heads, head_dim, dtype, generator)
        self.out = _OutProj(num_heads, head_dim, hidden_dim, dtype, generator)

    def forward(self, x: torch.Tensor, cache: KVCache | PagedCache | None = None,
                layer: int = 0, pages: PagedKV | None = None) -> torch.Tensor:
        """With ``cache`` the decode path over its layer ``layer`` (see the
        module docstring): the dense cache, or with ``pages`` the paged
        pool; JAX's refusals."""
        q, k, v = self.qkv(x)
        if cache is not None:
            if self.axis_name is not None:
                raise ValueError(
                    "decode=True is the unsharded inference path; generation "
                    "does not compose with sequence-parallel attention")
            if not self.causal:
                raise ValueError("decode=True only makes sense for causal attention")
            # The cache keeps [B, T, H, hd]; the projections give [B, H, T, hd].
            qkv = [t.transpose(1, 2) for t in (q, k, v)]
            if isinstance(cache, PagedCache) != (pages is not None):
                raise ValueError("a paged pool decodes with pages= (PagedKV) "
                                 "and only a paged pool takes it")
            out = (paged_decode_attend(*qkv, cache, layer, pages) if pages is not None
                   else decode_attend(*qkv, cache, layer))
            return self.out(out.transpose(1, 2))
        out = ring_attention(q, k, v, axis_name=self.axis_name, causal=self.causal,
                             impl=self.attn_impl, mesh=self.mesh)
        return self.out(out)
