"""The LM train and eval steps: one device, data parallelism with ZeRO
stages 0–3, and the sequence and tensor strategies.

The port of ``distributed_training_tpu/train/lm_step.py``: forward, the
cross-entropy, backward with gradient accumulation, the gradient
exchange, the loss-scale hooks and the optimizer commit. Metrics stay on
the device as 0-d tensors and carry the JAX step's keys
(:func:`_lm_metrics`); the fp32 and bf16 steps make no host read.

The cross-entropy takes one of three forms, as in the JAX package:

- the fused CE (:func:`_fused_ce_rows`) over the whole ``[B, T, vocab]``
  logits, the default;
- the chunked CE (``ce_chunk``, :func:`chunked_ce_and_accuracy`): the head
  runs on ``[B, C, D]`` slices of the hidden states, each slice's CE and
  accuracy reduced to float32 scalars under a checkpoint, so neither pass
  holds the whole logits (for long context and large vocabularies);
- the saved-probabilities CE (``ce_save_probs``, :class:`_SavedProbsCE`):
  the forward saves the bf16 softmax and the backward is ``(p − onehot)·g``
  from it.

Under tensor parallelism the logits are this model rank's vocabulary
shard, and each form runs as the **vocab-parallel CE**
(:class:`_VocabParallelCE`): the row maximum over the shards, then the sum
of exponentials, then the target's logit by a masked pick, each one
all-reduce over ``model``; its backward is local (``softmax − onehot``
on the rank's columns). Top-1 stays tie-inclusive against the global
maximum.

The strategy is the model's (the mesh and the tensor-parallel context it
was built with), as the JAX trainer's follows from the mesh:

- data parallelism (the state's ``zero``) is the image step's
  (``train/step.py``): each rank runs its equal slice of the global batch,
  the gradients are all-reduced (stages 0–1) or reduce-scattered (2–3) as
  a mean over the group, the update runs on the rank's shard, and the
  metrics are averaged over the group, so the step equals the JAX step on
  the global batch;
- under the ``fsdp`` mesh axis the group is ``data × fsdp`` (× ``sequence``)
  and the parameters are shards between steps (``parallel/zero.py``); the
  fsdp ranks of a data index run the same rows, so the exchange's mean
  over the group is the data ranks' mean, as JAX's pmean of equal values;
- the sequence strategy (the model's ``seq_axis``; JAX
  ``make_lm_train_step``): the batch is the rank's rows and time chunk,
  attention runs the ring, and the group of the state's ``zero`` is
  ``data × sequence`` (``_GRAD_AXES``), over which the gradients and
  metrics are averaged and ZeRO partitions;
- tensor parallelism (JAX ``make_tp_lm_train_step``, the same step
  here): the model holds this model rank's shards, the group is the
  rank's ``data`` (× ``sequence``) group, and every model rank computes
  the same loss;
- ``tp_overlap`` (JAX ``_lm_grads_body`` with ``tp_overlap``): the logits
  come out time-sharded over ``model``, so the step slices the targets to
  match, completes the gradients with ``overlap_finalize_grads`` and
  averages the metrics over ``model`` too.

Gradient accumulation cuts the rank's batch into contiguous microbatches
in every strategy; where JAX accumulates under GSPMD (tensor/dp without
``tp_overlap``) the LM trainer's loader orders each rank's rows so that
microbatch *m* is its share of JAX's (``data/pipeline.py::process_rows``),
and the sequence and overlap strategies keep the shard-local order of
JAX's shard_map steps. Dropout masks
come from a generator seeded by the run's seed, the step and the shard
(the JAX step's ``fold_in`` of ``sequence × data``, and ``model`` under
``tp_overlap``; model ranks of the plain TP step draw the same masks).

With MoE layers the objective is CE + the layers' weighted
load-balancing loss (the model's ``return_aux``), on every CE path; the
metrics report ``loss`` (the objective), ``aux_loss`` and ``perplexity``
``exp(CE)`` apart, as JAX's ``_lm_metrics`` does. Under data and expert
parallelism the gate counts over the data group (``models/moe.py``), so the
data group's mean of the ranks' losses is the global batch's; under the
sequence strategy each shard gates its own tokens and its aux loss is
averaged with the CE over ``data × sequence``, as in JAX's step; under
tensor parallelism every model rank computes the MoE layers whole.

The pipeline step (:func:`make_pp_lm_train_step`, JAX's
``make_pp_lm_train_step``) is this step on a ``parallel.pipeline.PipelinedLM``:
one forward and one backward over the model's ``M·accum`` microbatches
(accumulation multiplies the microbatches, DeepSpeed's pipeline
semantics), the embeddings' gradient summed over ``pipe``
(``PipelinedLM.pipe_grads``), then the exchange over the stage's replica
group and one update. Its CE runs on the broadcast output of the last
stage; under SP×PP the chunked CE takes JAX's chunk over the full
``seq_len``, on this shard's time chunk in pieces of ``gcd(ce_chunk,
T_local)`` (the same sum). ZeRO 3 raises JAX's error.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from distributed_training_tpu_torch.parallel.collective_matmul import (
    overlap_finalize_grads,
)
from distributed_training_tpu_torch.parallel.tensor_parallel import copy_to_model
from distributed_training_tpu_torch.runtime.mesh import AXIS_DATA, AXIS_SEQUENCE
from distributed_training_tpu_torch.parallel.zero import check_cpu_offload
from distributed_training_tpu_torch.train.optim import global_norm
from distributed_training_tpu_torch.train.precision import commit_gradients
from distributed_training_tpu_torch.train.step import dropout_generator
from distributed_training_tpu_torch.train.train_state import TrainState

LOGITS_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def parse_logits_dtype(name: str) -> torch.dtype:
    """Config string → dtype of the head; unknown spellings raise."""
    if name not in LOGITS_DTYPES:
        raise ValueError(f"logits_dtype must be one of {sorted(LOGITS_DTYPES)}, "
                         f"got {name!r}")
    return LOGITS_DTYPES[name]


def make_lm_batch(tokens):
    """Next-token split: ``tokens[:, :-1]`` in, ``tokens[:, 1:]`` target."""
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}


def _fused_ce_rows(logits: torch.Tensor, targets: torch.Tensor,
                   with_correct: bool = False):
    """Per-row cross-entropy (``[..., vocab]`` logits → ``[...]`` float32)
    as ``logsumexp − label logit``.

    As in the JAX package: the row max and the label gather read the
    logits in their stored dtype, only the sum of exponentials is taken
    in float32, and the max carries no gradient. ``with_correct`` also
    returns top-1 correctness as ``label logit >= row max``: tie-inclusive
    (it counts a label that ties another index's maximum as correct).
    """
    m = logits.detach().amax(-1, keepdim=True).float()
    lse = torch.log(torch.exp(logits.float() - m).sum(-1)) + m[..., 0]
    lab = logits.gather(-1, targets[..., None].long())[..., 0].float()
    rows = lse - lab
    if not with_correct:
        return rows
    return rows, (lab.detach() >= m[..., 0]).float()


def _fused_softmax_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy (the eval loss)."""
    return _fused_ce_rows(logits, targets).mean()


class _SavedProbsCE(torch.autograd.Function):
    """CE rows whose backward reads saved bf16 probabilities (the JAX
    ``_saved_probs_vjp``): the forward computes the rows and correctness as
    :func:`_fused_ce_rows` does and saves ``p = softmax(logits)`` in bf16;
    the backward is ``dlogits = (p − onehot)·g`` in float32, cast to the
    logits' dtype. Only the gradient sees the bf16 rounding of ``p``."""

    @staticmethod
    def forward(ctx, logits, targets):
        m = logits.amax(-1, keepdim=True).float()
        ex = torch.exp(logits.float() - m)
        s = ex.sum(-1)
        lse = torch.log(s) + m[..., 0]
        lab = logits.gather(-1, targets[..., None].long())[..., 0].float()
        p = (ex / s[..., None]).to(torch.bfloat16)
        ctx.save_for_backward(p, targets)
        ctx.logits_dtype = logits.dtype
        correct = (lab >= m[..., 0]).float()
        ctx.mark_non_differentiable(correct)
        return lse - lab, correct

    @staticmethod
    def backward(ctx, g_rows, _g_correct):
        p, targets = ctx.saved_tensors
        dlogits = p.float()
        dlogits.scatter_add_(-1, targets[..., None].long(),
                             torch.full(targets.shape + (1,), -1.0,
                                        device=p.device))
        return (dlogits * g_rows[..., None]).to(ctx.logits_dtype), None


class _VocabParallelCE(torch.autograd.Function):
    """CE rows and tie-inclusive correctness over vocab-sharded logits
    (``[..., V/tp]``, this model rank's columns, from ``index · V/tp``).

    As :func:`_fused_ce_rows` computes them over whole logits: the row
    maximum in the stored dtype (all-reduced MAX), the float32 sum of
    exponentials (all-reduced), the target's logit picked on the rank that
    holds it (all-reduced); rows ``lse − label logit``, correct where the
    label logit reaches the global maximum. The backward is local:
    ``(softmax − onehot)·g`` on the rank's columns, the softmax from the
    saved logits and lse, or with ``save_probs`` from the bf16
    probabilities the forward kept (:class:`_SavedProbsCE`'s trade)."""

    @staticmethod
    def forward(ctx, logits, targets, group, index, save_probs):
        vl = logits.shape[-1]
        m = logits.amax(-1).float()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        ex = torch.exp(logits.float() - m[..., None])
        s = ex.sum(-1)
        dist.all_reduce(s, group=group)
        lse = torch.log(s) + m
        local = targets.long() - index * vl
        mine = (local >= 0) & (local < vl)
        local = local.clamp(0, vl - 1)
        lab = logits.gather(-1, local[..., None])[..., 0].float()
        lab = torch.where(mine, lab, torch.zeros_like(lab))
        dist.all_reduce(lab, group=group)
        correct = (lab >= m).float()
        ctx.mark_non_differentiable(correct)
        ctx.logits_dtype, ctx.save_probs = logits.dtype, save_probs
        if save_probs:
            ctx.save_for_backward((ex / s[..., None]).to(torch.bfloat16), local, mine)
        else:
            ctx.save_for_backward(logits, lse, local, mine)
        return lse - lab, correct

    @staticmethod
    def backward(ctx, g_rows, _g_correct):
        if ctx.save_probs:
            p, local, mine = ctx.saved_tensors
            p = p.float()
        else:
            logits, lse, local, mine = ctx.saved_tensors
            p = torch.exp(logits.float() - lse[..., None])
        p.scatter_add_(-1, local[..., None], -mine.float()[..., None])
        return (p * g_rows[..., None]).to(ctx.logits_dtype), None, None, None, None


def _ce_rows_and_correct(logits, targets, accuracy_metric: bool,
                         save_probs: bool, tp=None):
    """The fused CE (default) or the saved-probabilities CE, vocab-parallel
    over ``tp``'s model ranks when the logits are a vocabulary shard;
    returns ``(rows, correct-or-None)``."""
    if tp is not None:
        rows, correct = _VocabParallelCE.apply(logits, targets, tp.group, tp.index,
                                               save_probs)
        return rows, (correct if accuracy_metric else None)
    if save_probs:
        rows, correct = _SavedProbsCE.apply(logits, targets)
        return rows, (correct if accuracy_metric else None)
    if accuracy_metric:
        return _fused_ce_rows(logits, targets, with_correct=True)
    return _fused_ce_rows(logits, targets), None


def chunked_ce_and_accuracy(hidden: torch.Tensor, head, targets: torch.Tensor,
                            chunk: int, accuracy_metric: bool = True,
                            logits_dtype: torch.dtype = torch.float32):
    """CE and token accuracy without the ``[B, T, vocab]`` logits.

    ``hidden`` is ``[B, T, D]`` (the model's ``return_hidden`` output),
    ``head`` the model's ``lm_head`` (``kernel`` ``[D, vocab]``, optional
    ``bias``). Over ``T / chunk`` slices in order, the head runs on one
    ``[B, chunk, D]`` slice in ``logits_dtype`` (its bias added in that
    dtype), and the slice's CE and correct count are reduced to float32
    sums under a checkpoint, so the backward recomputes the slice's
    logits too; the sums are divided by ``B·T`` at the end, as the JAX
    scan does. ``chunk`` must divide ``T``.
    """
    b, t, _ = hidden.shape
    if t % chunk:
        raise ValueError(f"ce_chunk {chunk} must divide sequence length {t}")
    tp = head.tp  # a vocab-parallel head: this rank's columns
    hidden = copy_to_model(hidden, tp)
    w = head.kernel.to(logits_dtype)
    bias = head.bias.to(logits_dtype) if head.bias is not None else None

    def body(hc, tc):
        logits = hc.to(logits_dtype) @ w
        if bias is not None:
            logits = logits + bias
        rows, correct = _ce_rows_and_correct(logits, tc, accuracy_metric,
                                             save_probs=False, tp=tp)
        acc = (correct.sum() if accuracy_metric
               else torch.zeros((), dtype=torch.float32, device=hc.device))
        return rows.sum(), acc

    ce_sum = acc_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, t, chunk):
        ce, acc = torch.utils.checkpoint.checkpoint(
            body, hidden[:, c0:c0 + chunk], targets[:, c0:c0 + chunk],
            use_reentrant=False)
        ce_sum, acc_sum = ce_sum + ce, acc_sum + acc
    denom = float(b * t)
    return ce_sum / denom, (acc_sum / denom if accuracy_metric else None)


def _check_ce_options(ce_chunk, ce_save_probs, logits_dtype=torch.float32):
    """The JAX package's rule: the chunked CE recomputes each chunk's
    logits, which would discard saved probabilities, so the two levers
    are refused together; saved probabilities under bf16 logits work but
    were measured slower there, so that pair warns."""
    if ce_chunk and ce_save_probs:
        raise ValueError(
            "ce_save_probs does not compose with ce_chunk (the chunked CE "
            "rematerializes each chunk's logits, discarding saved probs) — "
            "use ce_chunk for long-context memory or ce_save_probs for "
            "fp32-logits throughput, not both")
    if ce_save_probs and logits_dtype == torch.bfloat16:
        warnings.warn(
            "ce_save_probs under bf16 logits is a measured throughput "
            "LOSS (123.7k vs 125.2k tok/s at GPT-2-small B16 T1024; "
            "BASELINE.md round 5) — its win is fp32 logits only",
            stacklevel=3)


def _lm_loss_and_grads(model: torch.nn.Module, loss_scale, tokens, targets,
                       generator=None, ce_chunk: int | None = None,
                       accuracy_metric: bool = True,
                       logits_dtype: torch.dtype = torch.float32,
                       ce_save_probs: bool = False):
    """Forward, CE (+ the MoE aux loss) and backward of one (micro)batch.
    The gradient of the scaled loss is added into the parameters'
    ``.grad``. Returns ``(ce, aux, accuracy)`` as 0-d tensors
    (``accuracy`` None when off)."""
    if ce_chunk:
        hidden, aux = model(tokens, generator=generator, return_hidden=True,
                            return_aux=True)
        ce, accuracy = chunked_ce_and_accuracy(
            hidden, model.lm_head, targets, ce_chunk,
            accuracy_metric=accuracy_metric, logits_dtype=logits_dtype)
    else:
        logits, aux = model(tokens, generator=generator, return_aux=True)
        rows, correct = _ce_rows_and_correct(
            logits, targets, accuracy_metric, ce_save_probs, model.lm_head.tp)
        ce = rows.mean()
        accuracy = correct.mean() if accuracy_metric else None
    loss_scale.scale_loss(ce + aux).backward()
    return ce.detach(), aux.detach(), (accuracy.detach() if accuracy_metric else None)


def _lm_metrics(state: TrainState, ce, aux, accuracy, finite: bool) -> dict:
    """The LM metrics contract: ``loss`` (CE + aux), ``aux_loss``,
    ``accuracy`` (absent when the metric is off), ``perplexity``
    (``exp(CE)``), ``loss_scale`` and ``grads_finite``."""
    out = {
        "loss": (ce + aux).float(),
        "aux_loss": aux.float(),
        "accuracy": accuracy,
        "perplexity": torch.exp(ce).float(),
        "loss_scale": state.loss_scale.scale,
        "grads_finite": 1.0 if finite else 0.0,
    }
    if accuracy is None:
        del out["accuracy"]
    return out


def _seq_size(model) -> int:
    """The ranks the model's sequence is sharded over (1 without)."""
    return model.mesh.size(model.seq_axis) if model.seq_axis is not None else 1


def _shard_fold(model, rank: int) -> int:
    """The shard index the dropout generator folds in: the JAX step's
    ``sequence × data`` (× ``model`` under ``tp_overlap``) on a mesh, the
    data rank without one."""
    mesh, tp = model.mesh, model.tp
    if mesh is None:
        return rank
    fold = mesh.index(AXIS_SEQUENCE) * mesh.size(AXIS_DATA) + mesh.index(AXIS_DATA)
    if tp is not None and tp.overlap:
        fold = fold * tp.size + tp.index
    return fold


def _overlap_targets(targets: torch.Tensor, tp) -> torch.Tensor:
    """Under ``tp_overlap`` the logits are this model rank's time chunk:
    the targets' matching chunk (JAX slices them in its body)."""
    t = targets.shape[1]
    if t % tp.size:
        raise ValueError(
            f"tp_overlap: the per-sequence-shard length (= {t}) must divide "
            f"by the model-axis size {tp.size} (the overlap schedule "
            f"time-shards activations over `model`); pick a divisible seq_len "
            f"or disable tp_overlap")
    tl = t // tp.size
    return targets[:, tp.index * tl:(tp.index + 1) * tl]


def mean_over_model(tensors: list[torch.Tensor], tp) -> list[torch.Tensor]:
    """Each tensor averaged over the model ranks (one all-reduce)."""
    flat = torch.stack(tensors)
    dist.all_reduce(flat, group=tp.group)
    return list((flat / tp.size).unbind())


def make_lm_train_step(*, zero_stage: int = 0, grad_accum_steps: int = 1,
                       accuracy_metric: bool = True,
                       max_len: int | None = None,
                       ce_chunk: int | None = None, ce_save_probs: bool = False,
                       logits_dtype: torch.dtype = torch.float32,
                       seed: int = 0, pipeline: bool = False,
                       grad_norm_metric: bool = False) -> Callable:
    """Build ``step(state, batch) -> metrics`` for batches
    ``{'tokens', 'targets'}`` of ``[B, T]`` integers: the rank's rows, and
    under the sequence strategy its time chunk.

    The strategy is the state's model's (see the module docstring).
    ``zero_stage`` must be the stage of ``state.zero`` (a mismatch
    raises). ``grad_accum_steps > 1``: the batch is the rank's effective
    batch, cut into that many contiguous microbatches; their gradients are
    summed, then averaged, and one optimizer update follows. ``ce_chunk``
    and ``ce_save_probs`` select the CE (see the module docstring;
    together they raise). ``max_len`` bounds the global sequence length.
    ``pipeline``: the model is a ``PipelinedLM`` (use
    :func:`make_pp_lm_train_step`). ``grad_norm_metric`` adds
    ``grad_norm``, the global norm of the averaged, unscaled gradients (each
    model, expert, pipe and fsdp shard counted once), on the device.
    """
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    _check_ce_options(ce_chunk, ce_save_probs, logits_dtype)

    def step(state: TrainState, batch: dict) -> dict:
        zero = state.zero
        if zero.stage != zero_stage:
            raise ValueError(f"the step was built for zero stage {zero_stage}, "
                             f"the state is partitioned for {zero.stage}")
        model = state.model
        tokens, targets = batch["tokens"], batch["targets"]
        t_global = tokens.shape[1] * _seq_size(model)
        if max_len is not None and t_global > max_len:
            raise ValueError(f"global sequence length {t_global} exceeds "
                             f"the positional table max_len={max_len}")
        if tokens.shape[0] % grad_accum_steps:
            raise ValueError(f"batch dim {tokens.shape[0]} not divisible by "
                             f"gradient_accumulation_steps={grad_accum_steps}")
        overlap = model.tp if model.tp is not None and model.tp.overlap else None
        if overlap is not None:
            targets = _overlap_targets(targets, overlap)
        model.train()
        state.gather_params()
        for p in model.parameters():
            p.grad = None
        gen = dropout_generator(model, seed, state.step, _shard_fold(model, zero.rank),
                                tokens.device, state.capturable)
        ces, auxs, accs = [], [], []
        chunk = math.gcd(ce_chunk, targets.shape[1]) if pipeline and ce_chunk else ce_chunk
        for tk, tg in zip(tokens.chunk(grad_accum_steps),
                          targets.chunk(grad_accum_steps)):
            ce, aux, acc = _lm_loss_and_grads(
                model, state.loss_scale, tk, tg, gen, chunk,
                accuracy_metric, logits_dtype, ce_save_probs)
            ces.append(ce)
            auxs.append(aux)
            accs.append(acc)
        names = [n for n, _ in model.named_parameters()]
        grads = [p.grad for p in model.parameters()]
        for p in model.parameters():
            p.grad = None
        if pipeline:
            grads = model.pipe_grads(names, grads)
        if grad_accum_steps > 1:
            grads = [g / grad_accum_steps for g in grads]
        if overlap is not None:
            done = overlap_finalize_grads(dict(zip(names, grads)), overlap)
            grads = [done[n] for n in names]
        grads = zero.exchange_grads(grads)
        state.release_params()
        grads = state.loss_scale.unscale_grads(dict(zip(names, grads)))
        finite = commit_gradients(state, grads)
        local = [torch.stack(ces).mean(), torch.stack(auxs).mean()]
        if accuracy_metric:
            local.append(torch.stack(accs).mean())
        local = zero.all_reduce_mean(local)
        if overlap is not None:
            local = mean_over_model(local, overlap)
        ce, aux, *acc = local
        metrics = _lm_metrics(state, ce, aux, acc[0] if acc else None, finite)
        if grad_norm_metric:
            metrics["grad_norm"] = global_norm(list(grads.values()), zero, names)
        return metrics

    return step


def make_pp_lm_train_step(*, zero_stage: int = 0, cpu_offload: bool = False,
                          **kw) -> Callable:
    """The pipeline step (see the module docstring) for a state whose model
    is a ``PipelinedLM``; ``kw`` as :func:`make_lm_train_step`'s, without
    ``grad_accum_steps`` (the model's microbatches hold the accumulation).
    ZeRO 3 raises JAX's ``NotImplementedError``; ``cpu_offload`` goes
    through the ZeRO check."""
    if zero_stage >= 3:
        raise NotImplementedError(
            "zero stage 3 does not compose with the pipeline strategy "
            "(data-sharded params would be all-gathered every pipeline "
            "tick; DeepSpeed's pipeline engine refuses ZeRO-3 for the same "
            "reason) — use stage 1/2, or the tensor/dp or sequence "
            "strategies for stage 3")
    check_cpu_offload(cpu_offload, zero_stage)
    return make_lm_train_step(zero_stage=zero_stage, pipeline=True, **kw)


def make_lm_eval_fn(ce_chunk: int | None = None,
                    logits_dtype: torch.dtype = torch.float32,
                    pipeline: bool = False) -> Callable:
    """Build ``eval_loss(model, batch) -> mean token CE`` (a 0-d tensor of
    the rank's shard of the batch), through the chunked CE when
    ``ce_chunk`` is set, as the JAX trainer's eval does. The sequence
    strategy evaluates through the sharded forward (the ring), as JAX's
    ``make_lm_eval_fn``; tensor parallelism through the vocab-parallel CE;
    ``tp_overlap`` on this model rank's time chunk (the caller averages
    over the model ranks as over the replica group); ``pipeline`` (a
    ``PipelinedLM``) through the schedule, the chunked CE as in the
    pipeline step."""

    @torch.no_grad()
    def eval_loss(model: torch.nn.Module, batch: dict) -> torch.Tensor:
        model.eval()
        targets = batch["targets"]
        if model.tp is not None and model.tp.overlap:
            targets = _overlap_targets(targets, model.tp)
        if ce_chunk:
            hidden = model(batch["tokens"], return_hidden=True)
            chunk = math.gcd(ce_chunk, targets.shape[1]) if pipeline else ce_chunk
            return chunked_ce_and_accuracy(hidden, model.lm_head, targets,
                                           chunk, accuracy_metric=False,
                                           logits_dtype=logits_dtype)[0]
        rows, _ = _ce_rows_and_correct(model(batch["tokens"]), targets, False,
                                       False, model.lm_head.tp)
        return rows.mean()

    return eval_loss
