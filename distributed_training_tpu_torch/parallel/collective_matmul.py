"""Ring-overlapped collective matmul: all-gather and reduce-scatter fused
with the partial products, for the ``tp_overlap`` schedule.

The port of ``distributed_training_tpu/parallel/collective_matmul.py``.
Each collective of megatron tensor parallelism is cut into ring hops
(``runtime.mesh.shift_next`` / ``shift_prev``, the ports of its
``ppermute`` by ``_perm_next`` / ``_perm_prev``), and each hop's transfer
meets the partial product it unblocks:

- :func:`allgather_matmul` — ``all_gather(x, dim=-2) @ w``: ``n - 1``
  hops pass the input shards round while each one's product fills its
  slice of the output;
- :func:`matmul_reducescatter` — ``reduce_scatter(x @ w)`` over output
  rows (``scatter_dim=-2``) or columns (``-1``): a partial accumulator
  travels the ring and each rank adds the chunk it is missing;
- :func:`ring_all_gather` — the unfused all-gather whose transpose is a
  ring reduce-scatter.

Each is a ``torch.autograd.Function`` whose backward is the dual ring, as
JAX's custom VJPs are: the transpose of the overlapped all-gather is an
overlapped reduce-scatter, and the weight gradient runs the gather ring
again with each visiting shard's ``xᵀ·dy``. The rings run over a process
group (the ``model`` axis's); without one (``None``, or one rank) each is
a plain product. The hops here are blocking sends and receives: the
overlap of transfer and product that these rings exist for is not
measured on one card (there is no second rank to ring with).

:func:`overlap_finalize_grads` completes the gradients of the overlap
schedule (the time-sharded activations leave each rank a part of every
replicated leaf's gradient).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from distributed_training_tpu_torch.runtime.mesh import shift_next, shift_prev


def _ring(group) -> tuple[int, int]:
    """``(n, index)`` of this rank on ``group`` (``(1, 0)`` without one)."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _flat2(a: torch.Tensor) -> torch.Tensor:
    """``[..., M, K] -> [prod(...)·M, K]``."""
    return a.reshape(-1, a.shape[-1])


def _next(t: torch.Tensor, group) -> torch.Tensor:
    return shift_next([t], group)[0]


# -- allgather_matmul -----------------------------------------------------------

def _allgather_matmul_impl(x, w, group):
    """``y[..., src·t:(src+1)·t, :] = x_src @ w`` over the ring."""
    n, i0 = _ring(group)
    if n == 1:
        return x @ w
    t = x.shape[-2]
    y = x.new_empty((*x.shape[:-2], n * t, w.shape[-1]),
                    dtype=torch.result_type(x, w))
    xb = x
    for i in range(n):
        src = (i0 + i) % n
        y[..., src * t:(src + 1) * t, :] = xb @ w
        if i < n - 1:
            xb = _next(xb, group)
    return y


def _gather_xt_dy_ring(x, dy, group):
    """``dw = all_gather(x)ᵀ @ dy``, rotating ``x`` round the ring."""
    n, i0 = _ring(group)
    t = x.shape[-2]
    dw = None
    xb = x
    for i in range(n):
        src = (i0 + i) % n
        part = _flat2(xb).T @ _flat2(dy[..., src * t:(src + 1) * t, :])
        dw = part if dw is None else dw + part
        if i < n - 1:
            xb = _next(xb, group)
    return dw


class _AllgatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        ctx.group = group
        return _allgather_matmul_impl(x, w, group)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = _matmul_reducescatter_impl(dy, w.T, ctx.group, -2)
        dw = _gather_xt_dy_ring(x, dy, ctx.group)
        return dx.to(x.dtype), dw.to(w.dtype), None


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, group=None) -> torch.Tensor:
    """``all_gather(x, dim=-2) @ w`` with the gather cut into ring hops.

    ``x`` ``[..., t, K]`` is this rank's shard of an activation sharded on
    dim -2 over ``group``; ``w`` ``[K, N]`` stays local (a column shard).
    Returns the full-rows product ``[..., n·t, N]``."""
    if x.dim() < 2 or w.dim() != 2:
        raise ValueError(
            f"allgather_matmul wants x[..., t, K] and w[K, N]; got "
            f"x.ndim={x.dim()}, w.ndim={w.dim()}")
    if x.shape[-1] != w.shape[0]:
        raise ValueError(
            f"contraction mismatch: x[..., {x.shape[-1]}] @ w[{w.shape[0]}, :]")
    return _AllgatherMatmul.apply(x, w, group)


# -- matmul_reducescatter -------------------------------------------------------

def _rs_chunk(x, w, c, t, nc, scatter_dim):
    """This rank's partial product for scatter chunk ``c``."""
    if scatter_dim == -2:
        return x[..., c * t:(c + 1) * t, :] @ w
    return x @ w[:, c * nc:(c + 1) * nc]


def _matmul_reducescatter_impl(x, w, group, scatter_dim):
    """``reduce_scatter(x @ w, scatter_dim)``: the accumulator moves one
    rank on (+1) a hop; rank ``j`` adds its part of chunk
    ``(j - s - 1) mod n`` at hop ``s`` and its own chunk last."""
    n, i0 = _ring(group)
    if n == 1:
        return x @ w
    if scatter_dim == -2 and x.shape[-2] % n:
        raise ValueError(
            f"matmul_reducescatter: rows dim {x.shape[-2]} must divide by "
            f"the model axis size {n} (the ring would silently drop the "
            f"remainder rows)")
    if scatter_dim == -1 and w.shape[-1] % n:
        raise ValueError(
            f"matmul_reducescatter: output cols {w.shape[-1]} must divide "
            f"by the model axis size {n} (the ring would silently drop the "
            f"remainder columns)")
    t = x.shape[-2] // n if scatter_dim == -2 else 0
    nc = w.shape[-1] // n if scatter_dim == -1 else 0
    acc = None
    for s in range(n - 1):
        part = _rs_chunk(x, w, (i0 - s - 1) % n, t, nc, scatter_dim)
        acc = part if acc is None else acc + part
        acc = shift_prev([acc], group)[0]
    return acc + _rs_chunk(x, w, i0, t, nc, scatter_dim)


def _gather_dy_bwd_ring(x, w, dy, group, scatter_dim):
    """The backward of :func:`matmul_reducescatter`: ``dy`` travels the
    ring and each visiting chunk feeds both ``dx`` and ``dw``."""
    n, i0 = _ring(group)
    dx = torch.zeros(x.shape, dtype=torch.result_type(dy, w), device=x.device)
    dw = torch.zeros(w.shape, dtype=torch.result_type(x, dy), device=w.device)
    t = x.shape[-2] // n if scatter_dim == -2 else 0
    nc = w.shape[-1] // n if scatter_dim == -1 else 0
    dyb = dy
    for i in range(n):
        src = (i0 + i) % n
        if scatter_dim == -2:
            dx[..., src * t:(src + 1) * t, :] = dyb @ w.T
            dw += _flat2(x[..., src * t:(src + 1) * t, :]).T @ _flat2(dyb)
        else:
            dx += dyb @ w[:, src * nc:(src + 1) * nc].T
            dw[:, src * nc:(src + 1) * nc] = _flat2(x).T @ _flat2(dyb)
        if i < n - 1:
            dyb = _next(dyb, group)
    return dx, dw


class _MatmulReducescatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group, scatter_dim):
        ctx.save_for_backward(x, w)
        ctx.group, ctx.scatter_dim = group, scatter_dim
        return _matmul_reducescatter_impl(x, w, group, scatter_dim)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _gather_dy_bwd_ring(x, w, dy.contiguous(), ctx.group,
                                     ctx.scatter_dim)
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def matmul_reducescatter(x: torch.Tensor, w: torch.Tensor, group=None,
                         scatter_dim: int = -2) -> torch.Tensor:
    """``reduce_scatter(x @ w, scatter_dim)`` with the reduction cut into
    ring hops. ``x`` ``[..., T, K]`` holds this rank's partial data (its
    contraction shard), ``w`` ``[K, N]`` the local row shard. Returns this
    rank's fully reduced row chunk ``[..., T/n, N]`` (``scatter_dim=-2``)
    or column chunk ``[..., T, N/n]`` (``-1``)."""
    if x.dim() < 2 or w.dim() != 2:
        raise ValueError(
            f"matmul_reducescatter wants x[..., T, K] and w[K, N]; got "
            f"x.ndim={x.dim()}, w.ndim={w.dim()}")
    if x.shape[-1] != w.shape[0]:
        raise ValueError(
            f"contraction mismatch: x[..., {x.shape[-1]}] @ w[{w.shape[0]}, :]")
    if scatter_dim not in (-2, -1):
        raise ValueError(f"scatter_dim must be -2 (rows) or -1 (cols), "
                         f"got {scatter_dim}")
    return _MatmulReducescatter.apply(x, w, group, scatter_dim)


# -- ring all-gather --------------------------------------------------------------

def _ring_all_gather_impl(x, group, dim):
    n, i0 = _ring(group)
    if n == 1:
        return x
    parts = [None] * n
    xb = x
    for i in range(n):
        parts[(i0 + i) % n] = xb
        if i < n - 1:
            xb = _next(xb, group)
    return torch.cat(parts, dim)


def _ring_reduce_scatter_impl(x, group, dim):
    """``Σ_rank x``, scattered over ``dim`` (each rank keeps its chunk)."""
    n, i0 = _ring(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(
            f"ring reduce-scatter: dim {dim} sized {x.shape[dim]} must "
            f"divide by the model axis size {n}")
    chunks = x.chunk(n, dim)
    acc = None
    for s in range(n - 1):
        part = chunks[(i0 - s - 1) % n]
        acc = part if acc is None else acc + part
        acc = shift_prev([acc.contiguous()], group)[0]
    return acc + chunks[i0]


class _RingAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _ring_all_gather_impl(x, group, dim)

    @staticmethod
    def backward(ctx, dy):
        return _ring_reduce_scatter_impl(dy.contiguous(), ctx.group, ctx.dim), None, None


def ring_all_gather(x: torch.Tensor, group=None, dim: int = -1) -> torch.Tensor:
    """All-gather over ``dim`` as a chain of ring hops; its backward is a
    ring reduce-scatter."""
    return _RingAllGather.apply(x, group, int(dim))


# -- gradients of the overlap schedule --------------------------------------------

@torch.no_grad()
def overlap_finalize_grads(grads: dict[str, torch.Tensor], tp) -> dict[str, torch.Tensor]:
    """Per-leaf gradient completion for the ring-overlapped schedule
    (``tp`` a ``tensor_parallel.TensorParallel`` with ``overlap``).

    A leaf sharded over ``model`` already holds, through the rings'
    backward, every model rank's contribution: it needs only the 1/tp of
    the mean over the model ranks' time chunks. A replicated leaf holds
    only this rank's part, so it is averaged over the model ranks (one
    all-reduce for all of them). The data-family mean follows."""
    out = dict(grads)
    replicated = [n for n in grads if tp.dim(n) is None]
    for n in grads:
        if tp.dim(n) is not None:
            out[n] = grads[n] / tp.size
    if replicated:
        flat = torch.cat([grads[n].reshape(-1) for n in replicated])
        dist.all_reduce(flat, group=tp.group)
        flat /= tp.size
        for n, f in zip(replicated, flat.split([grads[n].numel() for n in replicated])):
            out[n] = f.view(grads[n].shape)
    return out
