"""One rank of the port's data-parallel runs that
``tests/test_torch_distributed.py`` (:func:`run`, the image step) and
``tests/test_torch_lm_distributed.py`` (:func:`run_lm`, the LM step and
``LMTrainer``) hold against the JAX package.

Started by the tests in ``spawn``ed processes (two ranks, gloo on the
CPU): it imports torch and the port only, never JAX. It reads
``<out>/job.pt`` (the initial weights, the batches, the trainer run's
config) and writes every scenario's results to ``<out>/results_<rank>.pt``,
or the traceback to ``<out>/error_<rank>.txt``.
"""

from __future__ import annotations

import os
import traceback

import numpy as np
import torch

# Hyperparameters of the scenarios: test_torch_step.py's, Adam's eps 1e-4
# so that a near-zero gradient does not turn rounding into an lr-sized step.
OPT = dict(name="hybrid_adam", lr=1e-3, eps=1e-4, weight_decay=1e-3,
           grad_clip_norm=5.0)
# The deepspeed preset's Adam (config.from_plugin): beta1 0.8, weight decay
# 3e-7, clip at 1.0; eps as above.
DS_OPT = dict(name="hybrid_adam", lr=1e-3, betas=(0.8, 0.999), eps=1e-4,
              weight_decay=3e-7, grad_clip_norm=1.0)
# lamb with the parameter EMA at stage 2: the trust ratio needs each whole
# tensor's norm from the ranks' shards, and the EMAs (of the parameters and
# of the BatchNorm statistics) are partitioned as the moments are.
LAMB_OPT = dict(name="lamb", lr=1e-3, eps=1e-4, weight_decay=1e-3,
                grad_clip_norm=5.0, ema_decay=0.9)
# (name, zero stage, SyncBN, cpu_offload, optimizer)
TRAIN_SCENARIOS = (
    ("sync_s0", 0, True, False, OPT),
    ("sync_s1", 1, True, False, OPT),
    ("sync_s2", 2, True, False, OPT),
    ("sync_s3", 3, True, False, OPT),
    ("local_bn", 0, False, False, OPT),
    ("ds_clip", 2, True, False, DS_OPT),
    ("ds_clip_offload", 2, True, True, DS_OPT),
    ("lamb_s2", 2, True, False, LAMB_OPT),
)
CKPT_GLOBAL_BATCH = 16


def _state(model_sd, stage, sync_bn, offload, opt, group, dtype="fp32"):
    from distributed_training_tpu_torch.config import OptimizerConfig, PrecisionConfig
    from distributed_training_tpu_torch.models import get_model
    from distributed_training_tpu_torch.models.resnet import set_batchnorm_group
    from distributed_training_tpu_torch.parallel.zero import Zero
    from distributed_training_tpu_torch.train.optim import make_optimizer
    from distributed_training_tpu_torch.train.precision import LossScaleState
    from distributed_training_tpu_torch.train.train_state import TrainState

    model = get_model("resnet_micro")
    model.load_state_dict(model_sd)
    set_batchnorm_group(model, group if sync_bn else None)
    return TrainState.create(model, make_optimizer(OptimizerConfig(**opt)),
                             LossScaleState.create(PrecisionConfig(dtype=dtype)),
                             Zero(stage, group, offload))


def _train(job, rank, world, group):
    from distributed_training_tpu_torch.train.step import make_train_step

    out = {}
    for name, stage, sync_bn, offload, opt in TRAIN_SCENARIOS:
        state = _state(job["model"], stage, sync_bn, offload, opt, group)
        step = make_train_step(zero_stage=stage, local_bn=not sync_bn)
        metrics = []
        for batch in job["batches"]:
            n = len(batch["label"]) // world
            local = {k: torch.from_numpy(v[rank * n:(rank + 1) * n]) for k, v in batch.items()}
            metrics.append({k: float(v) for k, v in step(state, local).items()})
        master = state.master_params()
        moment_bytes = sum(t.numel() * t.element_size()
                           for d in (state.opt_state.mu, state.opt_state.nu) for t in d.values())
        param_bytes = (sum(t.numel() * t.element_size() for t in master.values())
                       if state.shards is not None else
                       sum(p.numel() * p.element_size() for p in state.model.parameters()))
        sd = state.state_dict()
        out[name] = {"state": sd, "metrics": metrics, "moment_bytes": moment_bytes,
                     "param_bytes": param_bytes,
                     "moments_pinned_or_host": all(
                         t.device.type == "cpu" for t in state.opt_state.mu.values()),
                     "step": state.step}
    return out


def _fp16_skip(job, rank, world, group):
    """fp16 at stage 2: an inf in one gradient element that lands in rank
    1's shard only; both ranks must skip the step and keep equal scales."""
    state = _state(job["model"], 2, True, False, OPT, group, dtype="fp16")
    zero = state.zero
    params = state.params()
    grads = [torch.full(p.shape, 1e-3) for p in params.values()]
    first = next(iter(params.values()))
    c = zero.chunk(first.numel())
    if rank == 0:
        grads[0].view(-1)[c] = float("inf")  # element c: the first of rank 1's shard
    shards = zero.reduce_scatter_mean(grads)
    local_finite = bool(torch.isfinite(shards[0]).all())
    before = {n: p.clone() for n, p in state.master_params().items()}
    from distributed_training_tpu_torch.train.precision import commit_gradients

    committed = commit_gradients(state, dict(zip(params, shards)))
    unchanged = all(torch.equal(before[n], p) for n, p in state.master_params().items())
    return {"fp16_skip": {"local_finite": local_finite, "committed": committed,
                          "unchanged": unchanged, "step": state.step,
                          "scale": state.loss_scale.scale,
                          "hysteresis_left": state.loss_scale.hysteresis_left}}


def _eval(job, rank, world, group):
    from distributed_training_tpu_torch.train.step import make_eval_step

    state = _state(job["model"], 1, True, False, OPT, group)
    batch = job["eval"]
    n = len(batch["label"]) // world
    local = {k: torch.from_numpy(v[rank * n:(rank + 1) * n]) for k, v in batch.items()}
    c1, c5, cnt = make_eval_step()(state, local)
    return {"eval": {"counts": [float(c1), float(c5), float(cnt)]}}


def _checkpoint(job, rank, world, group):
    """One epoch of the Trainer at world 2, ZeRO stage 2, saved."""
    from distributed_training_tpu_torch import Trainer

    cfg = job["ckpt_cfg"]
    t = Trainer(cfg, device="cpu")
    t.fit()
    return {"ckpt": {"world": t.world_size, "steps": t.state.step,
                     "moment_numel": sum(m.numel() for m in t.state.opt_state.mu.values())}}


def _coordinator(job, rank, world, group):
    """Rank 0's scalar wins a broadcast; ``priority_execution`` runs rank
    0's body before the others' (each appends to a shared file)."""
    from distributed_training_tpu_torch.runtime.coordinator import Coordinator

    coord = Coordinator()
    order = os.path.join(job["dir"], "priority_order.txt")
    with coord.priority_execution():
        with open(order, "a") as fh:
            fh.write(f"{rank}\n")
    coord.barrier()
    with open(order) as fh:
        seen = [int(x) for x in fh.read().split()]
    return {"coord": {"index": coord.process_index, "count": coord.process_count,
                      "master": coord.is_master(), "order": seen,
                      "scalar": coord.broadcast_scalar(1.5 + rank)}}


# The LM scenarios: (name, zero stage, options of the step, remat).
LM_SCENARIOS = (
    ("s0", 0, {}, False),
    ("s1", 1, {}, False),
    ("s2", 2, {}, False),
    ("s3", 3, {}, False),
    ("s2_chunk", 2, {"ce_chunk": 8}, False),
    ("s3_remat", 3, {}, True),
)
LM_KW = dict(num_classes=64, num_layers=2, num_heads=2, hidden_dim=32, max_len=32)


def _lm_steps(job, rank, world, group):
    """Each LM scenario's steps on this rank's halves of the global batches."""
    from distributed_training_tpu_torch.config import OptimizerConfig, PrecisionConfig
    from distributed_training_tpu_torch.models import get_model
    from distributed_training_tpu_torch.parallel.zero import Zero
    from distributed_training_tpu_torch.train.lm_step import make_lm_train_step
    from distributed_training_tpu_torch.train.optim import make_optimizer
    from distributed_training_tpu_torch.train.precision import LossScaleState
    from distributed_training_tpu_torch.train.train_state import TrainState

    out = {}
    for name, stage, options, remat in LM_SCENARIOS:
        model = get_model("transformer_lm", remat=remat, **LM_KW)
        model.load_state_dict(job["model"])
        state = TrainState.create(model, make_optimizer(OptimizerConfig(**OPT)),
                                  LossScaleState.create(PrecisionConfig()),
                                  Zero(stage, group))
        step = make_lm_train_step(zero_stage=stage, max_len=LM_KW["max_len"], **options)
        metrics = []
        for batch in job["batches"]:
            n = len(batch["tokens"]) // world
            local = {k: torch.from_numpy(np.ascontiguousarray(v[rank * n:(rank + 1) * n]))
                     for k, v in batch.items()}
            metrics.append({k: float(v) for k, v in step(state, local).items()})
        out[name] = {"state": state.state_dict(), "metrics": metrics, "step": state.step}
    return out


def _lm_trainer(job, rank, world, group):
    """``LMTrainer.fit()`` at world 2 (ZeRO stage 2): the rank's slice of
    each batch, eval averaged over the ranks, a save."""
    from distributed_training_tpu_torch import LMTrainer

    t = LMTrainer(job["trainer_cfg"], device="cpu")
    result = t.fit()
    return {"trainer": {"result": result, "world": t.world_size,
                        "model": t.state.state_dict()["model"]}}


def _run_parts(rank, world, init_file, out_dir, parts):
    torch.set_num_threads(1)
    from distributed_training_tpu_torch.runtime import distributed

    try:
        group = distributed.initialize_distributed(
            init_method=f"file://{init_file}", world_size=world, rank=rank,
            device="cpu", timeout_s=60)
        job = torch.load(os.path.join(out_dir, "job.pt"), weights_only=False)
        results = {}
        for part in parts:
            results.update(part(job, rank, world, group))
        torch.save(results, os.path.join(out_dir, f"results_{rank}.pt"))
        distributed.shutdown_distributed()
    except BaseException:
        with open(os.path.join(out_dir, f"error_{rank}.txt"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def run(rank: int, world: int, init_file: str, out_dir: str) -> None:
    _run_parts(rank, world, init_file, out_dir,
               (_train, _fp16_skip, _eval, _checkpoint, _coordinator))


def run_lm(rank: int, world: int, init_file: str, out_dir: str) -> None:
    _run_parts(rank, world, init_file, out_dir, (_lm_steps, _lm_trainer))


def global_batches(n_steps: int, batch: int = 8, size: int = 64, seed: int = 0):
    """The train batches every run sees (numpy, NHWC float32)."""
    rng = np.random.RandomState(seed)
    return [{"image": rng.rand(batch, size, size, 3).astype(np.float32),
             "label": rng.randint(0, 10, batch).astype(np.int32)}
            for _ in range(n_steps)]
