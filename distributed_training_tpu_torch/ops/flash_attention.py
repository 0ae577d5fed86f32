"""Flash attention: the CUDA kernels' wrappers, their plain PyTorch
versions, launch counters, and the differentiable public ops.

The port of ``distributed_training_tpu/ops/flash_attention.py``. Two
kernels live in ``csrc/flash_attention.cu`` and two in
``csrc/flash_attention_split.cu`` (see the notes there for their design
and what bounds them):

- K2, :func:`flash_fwd` (the TPU's ``_flash_fwd``): ``out`` and a float32
  ``lse`` of shape ``[BH, T]``, one value per row;
- K3, :func:`flash_bwd` (the TPU's fused ``_flash_bwd``): ``dq, dk, dv``.
  ``delta = rowsum(dO·out) − g_lse`` is a plain tensor op before the
  launch, as in the JAX ``_bwd_prologue``;
- K4, the split backward (the TPU's ``_flash_bwd_split``):
  :func:`flash_bwd_dq` (K4a, the TPU's ``_dq_kernel``) and
  :func:`flash_bwd_dkv` (K4b, ``_dkv_kernel``), both from one ``delta``,
  launched in turn by :func:`flash_bwd_split`.

The kernels take float32, bfloat16 and float16 (the 16-bit types on the
tensor cores) at head dims 32, 64, 128 and 256, and at any multiple of 64
above 256 (kernels that stream ``d`` in slabs of 64 columns). Each wrapper
zero-pads any other ``d`` up to the next of those and slices its outputs
back: a zero column adds nothing to a score, to ``out`` or to
a gradient, and the scores keep the true ``d``'s scale
(:func:`softmax_scale`), so the result is the unpadded one.

Each wrapper takes its kernel for CUDA tensors and its plain version
(:func:`flash_attention_reference`, :func:`flash_attention_bwd_reference`,
:func:`flash_attention_dq_reference`, :func:`flash_attention_dkv_reference`)
for CPU tensors, and for nothing else: a CUDA tensor the kernel cannot
take raises. Each wrapper's ``launches`` counts its kernel's launches.

Two module switches keep the JAX package's names and meaning, so that a
test or a tool flips both packages the same way; the model path never sets
them. ``_USE_SPLIT_BWD`` sends the autograd backward to the split kernels.
``_USE_EXP2`` makes every kernel and every plain version take its softmax
exponentials as ``2**x`` with log2(e) folded into the score scale, the
stored ``lse`` staying a natural log.

:func:`flash_attention` and :func:`flash_attention_lse` keep the JAX
signature and layout ``[..., T, d]`` and its admissibility rule: the
block arguments (and the JAX package's auto defaults) go through
:func:`_block`, so the port accepts and rejects exactly the sequence
lengths the JAX package does. The CUDA tiles are the kernel's own (64 × 64,
any T); the block arguments are validated, not used as tile sizes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from distributed_training_tpu_torch.ops import cuda_build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)
# Above HEAD_DIMS[-1] the kernels take any multiple of this.
WIDE_HEAD_DIM_STEP = 64
# The kernels' dtype argument (csrc/flash_tiles.cuh, FLASH_DISPATCH).
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
LOG2E = 1.4426950408889634

# A/B switches of the flash kernel bench's --split-bwd and --exp2 (read
# when a kernel or plain version runs; see the module docstring).
_USE_SPLIT_BWD = False
_USE_EXP2 = False


def _block(t: int, requested: int) -> int:
    """Largest admissible block ≤ ``requested`` for a length-``t``
    sequence: ``t`` itself when it fits, else a 128-multiple dividing it
    (the JAX package's Mosaic tiling rule, kept so that both packages take
    the same ``t``)."""
    if t <= requested:
        return t
    if t % requested == 0:
        return requested
    for b in range(min(requested, t) // 128 * 128, 0, -128):
        if t % b == 0:
            return b
    raise ValueError(
        f"sequence length {t} is not divisible by block {requested} nor by "
        f"any 128-multiple below it; pad the sequence to a multiple of 128")


def softmax_scale(d: int) -> float:
    """``1/√d`` as the float32 the kernels multiply by."""
    return float(np.float32(1.0 / (d ** 0.5)))


def _score_scale(d: int) -> float:
    """The float32 the scores are scaled by, as the kernels compute it:
    ``1/√d``, times log2(e) under ``_USE_EXP2``."""
    scale = np.float32(softmax_scale(d))
    return float(scale * np.float32(LOG2E)) if _USE_EXP2 else float(scale)


def _causal_mask(t: int, device) -> torch.Tensor:
    return torch.ones((t, t), dtype=torch.bool, device=device).triu(1)


def _scores(q, k, causal: bool) -> torch.Tensor:
    """Materialised float32 scores, scaled by :func:`_score_scale` and
    masked with ``NEG_INF``."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _score_scale(q.shape[-1])
    if causal:
        s = s.masked_fill(_causal_mask(q.shape[-2], q.device), NEG_INF)
    return s


# -- plain versions -----------------------------------------------------------

def flash_attention_reference(q, k, v, *, causal: bool):
    """Plain attention over ``[BH, T, d]``: ``(out, lse)``.

    Materialised float32 scores scaled by ``1/√d``, masked with
    ``NEG_INF``, float32 softmax; ``out`` in the input dtype, ``lse``
    float32 ``[BH, T]``. Under ``_USE_EXP2`` the softmax runs in the log2
    domain as the kernels' does: ``lse = (m + log2 Σ 2**(s − m)) / log2 e``.
    """
    s = _scores(q, k, causal)
    if _USE_EXP2:
        m = s.amax(-1, keepdim=True)
        lse2 = m + torch.log2(torch.exp2(s - m).sum(-1, keepdim=True))
        p = torch.exp2(s - lse2)
        lse = (lse2 / LOG2E).squeeze(-1)
    else:
        lse = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[..., None])
    return torch.matmul(p, v.float()).to(q.dtype), lse


def _delta(g, out, g_lse=None) -> torch.Tensor:
    """``rowsum(g·out) − g_lse`` in float32 (the JAX ``_bwd_prologue``)."""
    delta = (g.float() * out.float()).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta


def _probs_and_dscores(q, k, v, g, lse, delta, causal: bool):
    """``p`` recomputed from the saved natural-log ``lse`` (under
    ``_USE_EXP2`` as ``2**(s·log2e − lse·log2e)``) and
    ``dS = p·(dO vᵀ − delta)``, float32 ``[BH, T, T]``."""
    s = _scores(q, k, causal)
    if _USE_EXP2:
        p = torch.exp2(s - lse.float()[..., None] * LOG2E)
    else:
        p = torch.exp(s - lse.float()[..., None])
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def _dq(ds, q, k):
    return (torch.matmul(ds, k.float()) * softmax_scale(q.shape[-1])).to(q.dtype)


def _dkv(p, ds, q, k, v, g):
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * softmax_scale(q.shape[-1])
    dv = torch.matmul(p.transpose(-1, -2), g.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, out, lse, g, g_lse=None, *,
                                  causal: bool):
    """Plain gradients of attention over ``[BH, T, d]``, in closed form
    from the saved ``out`` and ``lse``: ``(dq, dk, dv)`` in the input
    dtypes. ``g_lse`` is the cotangent of ``lse`` (None for zero)."""
    p, ds = _probs_and_dscores(q, k, v, g, lse, _delta(g, out, g_lse), causal)
    return (_dq(ds, q, k), *_dkv(p, ds, q, k, v, g))


def flash_attention_dq_reference(q, k, v, g, lse, delta, *, causal: bool):
    """Plain version of K4a: ``dq`` from the saved ``lse`` and the
    backward's ``delta`` (:func:`_delta`), in q's dtype."""
    return _dq(_probs_and_dscores(q, k, v, g, lse, delta, causal)[1], q, k)


def flash_attention_dkv_reference(q, k, v, g, lse, delta, *, causal: bool):
    """Plain version of K4b: ``(dk, dv)`` as
    :func:`flash_attention_dq_reference` takes them."""
    p, ds = _probs_and_dscores(q, k, v, g, lse, delta, causal)
    return _dkv(p, ds, q, k, v, g)


# -- kernel wrappers ----------------------------------------------------------

def _all_cpu(tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def padded_head_dim(d: int) -> int:
    """The head dim a kernel runs ``d`` at: the least of :data:`HEAD_DIMS`
    not below it, or above 256 the least multiple of
    :data:`WIDE_HEAD_DIM_STEP` not below it."""
    if d < 1:
        raise ValueError(f"flash attention: head dim must be at least 1, got {d}")
    for size in HEAD_DIMS:
        if d <= size:
            return size
    return -(-d // WIDE_HEAD_DIM_STEP) * WIDE_HEAD_DIM_STEP


def _kernel_head_dim(d: int) -> bool:
    return d in HEAD_DIMS or (d > HEAD_DIMS[-1] and d % WIDE_HEAD_DIM_STEP == 0)


def _pad_d(x: torch.Tensor, size: int) -> torch.Tensor:
    """``x`` ``[..., d]`` zero-padded to ``size`` on its last axis."""
    return x if x.shape[-1] == size else F.pad(x, (0, size - x.shape[-1]))


def _check_for_kernel(name: str, tensors, floats=()) -> None:
    """Raise unless the kernel can take these tensors: ``tensors`` are
    ``[BH, T, d]`` of one float32, bfloat16 or float16 dtype with ``d`` in
    :data:`HEAD_DIMS` or a multiple of 64 above them (the wrappers pad to
    one), ``floats`` are float32 ``[BH, T]``; all contiguous, 16-byte
    aligned, on one CUDA device."""
    ref = tensors[0]
    if ref.dim() != 3 or not _kernel_head_dim(ref.shape[-1]):
        raise ValueError(f"{name}: the kernel takes [BH, T, d] with d in "
                         f"{HEAD_DIMS} or a multiple of {WIDE_HEAD_DIM_STEP} "
                         f"above them, got {tuple(ref.shape)}")
    if ref.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: the kernel takes float32, bfloat16 or "
                         f"float16, got {ref.dtype}")
    for t, shape, dtype in ([(t, ref.shape, ref.dtype) for t in tensors]
                            + [(t, ref.shape[:2], torch.float32) for t in floats]):
        if t.device.type != "cuda" or t.device != ref.device:
            raise ValueError(f"{name}: tensors must all be on the CPU or all "
                             f"on one CUDA device, got {t.device} and {ref.device}")
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {tuple(shape)} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and "
                             f"16-byte aligned")


def _lib():
    lib = cuda_build.load("flash_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_fwd.restype = i32
    lib.flash_fwd.argtypes = [ptr] * 5 + [i32] * 6 + [ctypes.c_float, ptr]
    lib.flash_bwd.restype = i32
    lib.flash_bwd.argtypes = [ptr] * 9 + [i32] * 6 + [ctypes.c_float, ptr]
    return lib


def _split_lib():
    lib = cuda_build.load("flash_attention_split")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_bwd_dq.restype = i32
    lib.flash_bwd_dq.argtypes = [ptr] * 7 + [i32] * 6 + [ctypes.c_float, ptr]
    lib.flash_bwd_dkv.restype = i32
    lib.flash_bwd_dkv.argtypes = [ptr] * 8 + [i32] * 6 + [ctypes.c_float, ptr]
    return lib


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _kernel_args(name: str, tensors, floats=()):
    """``tensors`` (``[BH, T, d]``) padded to the kernel's head dim and
    checked with ``floats``; returns them, the true ``d``, the padded one
    and the dtype code."""
    d = tensors[0].shape[-1]
    size = padded_head_dim(d)
    tensors = [_pad_d(t, size) for t in tensors]
    _check_for_kernel(name, tensors, floats)
    return tensors, d, size, _DTYPE_CODES[tensors[0].dtype]


def _unpad(x: torch.Tensor, d: int) -> torch.Tensor:
    return x if x.shape[-1] == d else x[..., :d].contiguous()


def flash_fwd(q, k, v, *, causal: bool):
    """K2: ``(out, lse)`` for ``[BH, T, d]`` inputs (see the module
    docstring)."""
    if _all_cpu((q, k, v)):
        return flash_attention_reference(q, k, v, causal=causal)
    (q, k, v), d, size, code = _kernel_args("flash_fwd", (q, k, v))
    bh, t, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _lib().flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, t, size, code, int(causal), int(_USE_EXP2),
            softmax_scale(d), _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_fwd.launches += 1
    return _unpad(out, d), lse


def flash_bwd(q, k, v, out, lse, g, g_lse=None, *, causal: bool):
    """K3: ``(dq, dk, dv)`` from the forward's ``out`` and ``lse`` and the
    output cotangent ``g`` (and ``lse``'s, ``g_lse``)."""
    if _all_cpu((q, k, v, out, lse, g)):
        return flash_attention_bwd_reference(q, k, v, out, lse, g, g_lse,
                                             causal=causal)
    delta = _delta(g, out, g_lse)
    (q, k, v, g), d, size, code = _kernel_args("flash_bwd", (q, k, v, g),
                                               (lse, delta))
    bh, t, _ = q.shape
    dq_acc = torch.zeros((bh, t, size), dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _lib().flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), bh, t, size, code, int(causal),
            int(_USE_EXP2), softmax_scale(d), _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_bwd kernel launch failed: CUDA error {err}")
    flash_bwd.launches += 1
    return _unpad(dq_acc, d).to(q.dtype), _unpad(dk, d), _unpad(dv, d)


def flash_bwd_dq(q, k, v, g, lse, delta, *, causal: bool):
    """K4a: ``dq`` from the forward's ``lse``, the output cotangent ``g``
    and the backward's ``delta``; written once, no atomics, so the same bit
    for bit from run to run."""
    if _all_cpu((q, k, v, g, lse, delta)):
        return flash_attention_dq_reference(q, k, v, g, lse, delta, causal=causal)
    (q, k, v, g), d, size, code = _kernel_args("flash_bwd_dq", (q, k, v, g),
                                               (lse, delta))
    bh, t, _ = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _split_lib().flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, t, size,
            code, int(causal), int(_USE_EXP2), softmax_scale(d),
            _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: CUDA error {err}")
    flash_bwd_dq.launches += 1
    return _unpad(dq, d)


def flash_bwd_dkv(q, k, v, g, lse, delta, *, causal: bool):
    """K4b: ``(dk, dv)``, taking what :func:`flash_bwd_dq` takes."""
    if _all_cpu((q, k, v, g, lse, delta)):
        return flash_attention_dkv_reference(q, k, v, g, lse, delta, causal=causal)
    (q, k, v, g), d, size, code = _kernel_args("flash_bwd_dkv", (q, k, v, g),
                                               (lse, delta))
    bh, t, _ = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _split_lib().flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, t, size, code, int(causal), int(_USE_EXP2), softmax_scale(d),
            _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: CUDA error {err}")
    flash_bwd_dkv.launches += 1
    return _unpad(dk, d), _unpad(dv, d)


def flash_bwd_split(q, k, v, out, lse, g, g_lse=None, *, causal: bool):
    """K4: ``(dq, dk, dv)`` as :func:`flash_bwd` gives them, from K4a and
    K4b in turn, with ``delta`` computed once for both."""
    delta = _delta(g, out, g_lse)
    dq = flash_bwd_dq(q, k, v, g, lse, delta, causal=causal)
    return (dq, *flash_bwd_dkv(q, k, v, g, lse, delta, causal=causal))


flash_fwd.launches = 0
flash_bwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


# -- differentiable ops -------------------------------------------------------

def _forward(ctx, q, k, v, causal, bwd_blocks):
    out, lse = flash_fwd(q, k, v, causal=causal)
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.bwd_blocks = causal, bwd_blocks
    return out, lse


def _backward(ctx, g, g_lse=None):
    q, k, v, out, lse = ctx.saved_tensors
    for b in ctx.bwd_blocks:  # admissible as in JAX, checked when it runs
        _block(q.shape[-2], b)
    if g_lse is not None:
        g_lse = g_lse.contiguous()
    bwd = flash_bwd_split if _USE_SPLIT_BWD else flash_bwd
    dq, dk, dv = bwd(q, k, v, out, lse, g.contiguous(), g_lse, causal=ctx.causal)
    return dq, dk, dv, None, None, None


class _FlashCore(torch.autograd.Function):
    """Attention whose forward is K2 and whose backward is K3 (K4 under
    ``_USE_SPLIT_BWD``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, bwd_block_q, bwd_block_k):
        return _forward(ctx, q, k, v, causal, (bwd_block_q, bwd_block_k))[0]

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, g)


class _FlashCoreLse(torch.autograd.Function):
    """Like :class:`_FlashCore`, with ``lse`` a differentiable output too
    (its cotangent folds into delta)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, bwd_block_q, bwd_block_k):
        return _forward(ctx, q, k, v, causal, (bwd_block_q, bwd_block_k))

    @staticmethod
    def backward(ctx, g, g_lse):
        return _backward(ctx, g, g_lse)


def check_seq_len(t: int) -> None:
    """Raise :func:`_block`'s ``ValueError`` unless a length-``t`` sequence
    fits the auto blocks of :func:`flash_attention` (forward and backward),
    which is what the JAX wrapper takes."""
    for requested in (1024, 2048, 512):
        _block(t, min(t, requested))


def _flat_args(q, k, v, block_q, block_k, bwd_block_q, bwd_block_k):
    """Shape check, the JAX auto block rule, the forward blocks'
    admissibility, and ``[..., T, d]`` flattened to contiguous
    ``[BH, T, d]``."""
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    t, d = q.shape[-2:]
    block_q = min(t, 1024) if block_q is None else block_q
    block_k = min(t, 2048) if block_k is None else block_k
    bwd_block_q = min(t, 512) if bwd_block_q is None else bwd_block_q
    bwd_block_k = min(t, 2048) if bwd_block_k is None else bwd_block_k
    _block(t, block_q)
    _block(t, block_k)
    flat = [x.reshape(-1, t, d).contiguous() for x in (q, k, v)]
    return (*flat, bwd_block_q, bwd_block_k)


def flash_attention(q, k, v, *, causal: bool = False,
                    block_q: int | None = None, block_k: int | None = None,
                    bwd_block_q: int | None = None,
                    bwd_block_k: int | None = None) -> torch.Tensor:
    """Blockwise attention over ``[..., T, d]`` (any leading dims):
    ``softmax(q kᵀ/√d [causally masked]) v`` without the ``[T, T]`` scores
    in device memory. Block arguments as in the JAX package (validated,
    see the module docstring)."""
    *flat, bbq, bbk = _flat_args(q, k, v, block_q, block_k, bwd_block_q,
                                 bwd_block_k)
    out = _FlashCore.apply(*flat, causal, bbq, bbk)
    return out.reshape(q.shape)


def flash_attention_lse(q, k, v, *, causal: bool = False,
                        block_q: int | None = None, block_k: int | None = None,
                        bwd_block_q: int | None = None,
                        bwd_block_k: int | None = None):
    """Like :func:`flash_attention`, returning ``(out, lse)`` with ``lse``
    (``[..., T]``, float32) differentiable: the ring-attention hop
    primitive."""
    *flat, bbq, bbk = _flat_args(q, k, v, block_q, block_k, bwd_block_q,
                                 bwd_block_k)
    out, lse = _FlashCoreLse.apply(*flat, causal, bbq, bbk)
    return out.reshape(q.shape), lse.reshape(q.shape[:-1])
