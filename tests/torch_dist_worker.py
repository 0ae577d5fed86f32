"""One rank of the port's multi-rank runs that
``tests/test_torch_distributed.py`` (:func:`run`, the image step),
``tests/test_torch_lm_distributed.py`` (:func:`run_lm`, the LM step and
``LMTrainer``) and the sequence- and tensor-parallel tests
(:func:`run_named`: ring attention, the LM step on a mesh, the pipeline
step, checkpoints, ``LMTrainer``, the GPT CLI, the image ``Trainer``'s
``fit``) hold against the JAX package, and the collective accounting
(``tests/test_torch_collectives.py``).

Started by the tests in ``spawn``ed processes (two or four ranks, gloo on
the CPU): it imports torch and the port only, never JAX. It reads
``<out>/job.pt`` (the initial weights, the batches, the trainer run's
config) and writes every scenario's results to ``<out>/results_<rank>.pt``,
or the traceback to ``<out>/error_<rank>.txt``.
"""

from __future__ import annotations

import math
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
    shards = zero.exchange_grads(grads)
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


def _mesh(sizes: dict):
    from distributed_training_tpu_torch.config import MeshSpec
    from distributed_training_tpu_torch.runtime.mesh import Mesh

    return Mesh(MeshSpec(**sizes))


def _local_batch(batch: dict, mesh) -> dict:
    """This rank's rows (its data shard) and time chunk (its sequence
    shard) of a global ``[B, T]`` batch (of its rows alone for a batch of
    images or labels)."""
    nd, d = mesh.size("data"), mesh.index("data")
    ns, q = mesh.size("sequence"), mesh.index("sequence")
    out = {}
    for k, v in batch.items():
        rows = v.shape[0] // nd
        v = v[d * rows:(d + 1) * rows]
        if v.ndim == 2:
            t = v.shape[1] // ns
            v = v[:, q * t:(q + 1) * t]
        out[k] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def _ring(job, rank, world, group):
    """Ring attention over a sequence axis of the world's size: each case's
    output chunk and the chunk's gradients of ``Σ out · g``."""
    from distributed_training_tpu_torch.parallel.ring_attention import ring_attention

    mesh = _mesh({"data": 1, "sequence": world})
    out = {}
    for name, (impl, causal, arrays) in job["ring_cases"].items():
        q, k, v, g = (torch.from_numpy(a).chunk(world, dim=-2)[rank].contiguous()
                      for a in arrays)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        o = ring_attention(q, k, v, axis_name="sequence", causal=causal, impl=impl,
                           mesh=mesh)
        (o * g).sum().backward()
        out[name] = {"out": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    return {"ring": out}


def _lm_mesh_steps(job, rank, world, group):
    """Each mesh scenario: the LM step on this rank's shard of the global
    batches (the model sharded by the rule table under tensor
    parallelism), the whole state after the steps, each step's metrics and
    the sharded eval's CE."""
    from distributed_training_tpu_torch.config import OptimizerConfig, PrecisionConfig
    from distributed_training_tpu_torch.models import get_model
    from distributed_training_tpu_torch.parallel.tensor_parallel import (
        TensorParallel,
        shard_model_,
    )
    from distributed_training_tpu_torch.parallel.zero import Zero
    from distributed_training_tpu_torch.train.lm_step import (
        make_lm_eval_fn,
        make_lm_train_step,
        mean_over_model,
    )
    from distributed_training_tpu_torch.train.optim import make_optimizer
    from distributed_training_tpu_torch.train.precision import LossScaleState
    from distributed_training_tpu_torch.train.train_state import TrainState

    meshes, out = {}, {}
    for name, sc in job["mesh_scenarios"].items():
        key = tuple(sorted(sc["mesh"].items()))
        if key not in meshes:  # every rank opens the same groups in turn
            meshes[key] = _mesh(sc["mesh"])
        mesh = meshes[key]
        seq = mesh.size("sequence")
        model = get_model("transformer_lm", seq_axis="sequence" if seq > 1 else None,
                          mesh=mesh, **job["lm_kw"], **sc.get("model", {}))
        model.load_state_dict(job["model"])
        tp = TensorParallel.from_mesh(mesh, overlap=sc.get("overlap", False))
        shard_model_(model, tp)
        state = TrainState.create(model, make_optimizer(OptimizerConfig(**sc["opt"])),
                                  LossScaleState.create(PrecisionConfig()),
                                  Zero(sc["stage"], mesh.group("data", "sequence"), tp=tp))
        step = make_lm_train_step(zero_stage=sc["stage"], max_len=job["lm_kw"]["max_len"],
                                  **sc.get("step", {}))
        metrics = [{k: float(v) for k, v in step(state, _local_batch(b, mesh)).items()}
                   for b in job["batches"]]
        res = {"state": state.state_dict(), "metrics": metrics, "step": state.step,
               "local_numel": sum(p.numel() for p in model.parameters())}
        if sc.get("eval"):
            state.gather_params()
            ce = make_lm_eval_fn(sc.get("step", {}).get("ce_chunk"))(
                model, _local_batch(job["eval"], mesh))
            state.release_params()
            ce = state.zero.all_reduce_mean([ce])[0]
            if tp is not None and tp.overlap:
                ce = mean_over_model([ce], tp)[0]
            res["eval"] = float(ce)
        if sc.get("save"):
            from distributed_training_tpu_torch import checkpoint as ckpt_lib

            ckpt_lib.save_checkpoint(os.path.join(job["dir"], name), 0, state)
        if sc.get("restore"):
            from distributed_training_tpu_torch import checkpoint as ckpt_lib

            ckpt_lib.restore_checkpoint(sc["restore"], 0, state)
            res["restored"] = state.state_dict()
        out[name] = res
    return {"mesh": out}


def _overlap_primitives(job, rank, world, group):
    """The ring collective matmuls over the world (the model axis): each
    case's output piece and this rank's gradients of its shards of x and
    w, for the loss ``Σ out · co`` summed over the ranks (a replicated
    output counts once: each rank takes 1/world of it)."""
    from distributed_training_tpu_torch.parallel.collective_matmul import (
        allgather_matmul,
        matmul_reducescatter,
        ring_all_gather,
    )

    x0, w0, co = (torch.from_numpy(a) for a in job["xw"])
    out = {}
    for name in ("allgather", "rs_rows", "rs_cols"):
        if name == "allgather":  # x rows sharded, w columns
            x, w = x0.chunk(world, -2)[rank], w0.chunk(world, -1)[rank]
        else:  # the contraction sharded: x columns, w rows
            x, w = x0.chunk(world, -1)[rank], w0.chunk(world, -2)[rank]
        x, w = x.contiguous().requires_grad_(), w.contiguous().requires_grad_()
        if name == "allgather":
            y = allgather_matmul(x, w, group)
            loss = (y * co.chunk(world, -1)[rank]).sum()
        elif name == "rs_rows":
            y = matmul_reducescatter(x, w, group, -2)
            loss = (y * co.chunk(world, -2)[rank]).sum()
        else:
            y = ring_all_gather(matmul_reducescatter(x, w, group, -1), group, -1)
            loss = (y * co).sum() / world
        loss.backward()
        out[name] = {"y": y.detach(), "dx": x.grad, "dw": w.grad}
    return {"primitives": out}


def _moe_steps(job, rank, world, group):
    """Each MoE scenario of ``job["moe_scenarios"]``: the LM step (``kind``
    "lm") or the image step ("image") on this rank's rows (and time chunk)
    of the global batches, on a mesh of data, sequence, model and expert
    axes (the experts cut to this rank's block, the rest by the TP rule
    table), from the whole initial weights; the whole state after the
    steps and each step's metrics; a save or a restore when asked."""
    from distributed_training_tpu_torch import checkpoint as ckpt_lib
    from distributed_training_tpu_torch.config import OptimizerConfig, PrecisionConfig
    from distributed_training_tpu_torch.models import get_model
    from distributed_training_tpu_torch.models.moe import MoEContext, shard_experts_
    from distributed_training_tpu_torch.parallel.tensor_parallel import (
        ExpertParallel,
        TensorParallel,
        shard_model_,
    )
    from distributed_training_tpu_torch.parallel.zero import Zero
    from distributed_training_tpu_torch.train.lm_step import make_lm_train_step
    from distributed_training_tpu_torch.train.optim import make_optimizer
    from distributed_training_tpu_torch.train.precision import LossScaleState
    from distributed_training_tpu_torch.train.step import make_train_step
    from distributed_training_tpu_torch.train.train_state import TrainState

    meshes, out = {}, {}
    for name, sc in job["moe_scenarios"].items():
        key = tuple(sorted(sc["mesh"].items()))
        if key not in meshes:  # every rank opens the same groups in turn
            meshes[key] = _mesh(sc["mesh"])
        mesh = meshes[key]
        lm = sc["kind"] == "lm"
        seq = {"seq_axis": "sequence", "mesh": mesh} if mesh.size("sequence") > 1 else {}
        model = get_model("transformer_lm" if lm else "moe_mlp",
                          **job[f"{sc['kind']}_kw"], **seq)
        model.load_state_dict(job[f"{sc['kind']}_model"])
        tp = TensorParallel.from_mesh(mesh)
        shard_model_(model, tp)
        shard_experts_(model, MoEContext.from_mesh(mesh))
        state = TrainState.create(model, make_optimizer(OptimizerConfig(**sc["opt"])),
                                  LossScaleState.create(PrecisionConfig()),
                                  Zero(sc["stage"], mesh.group("data", "sequence"), tp=tp,
                                       ep=ExpertParallel.from_mesh(mesh)))
        if sc.get("restore"):
            ckpt_lib.restore_checkpoint(sc["restore"], 0, state)
            out[name] = {"restored": state.state_dict()}
            continue
        accum = sc.get("accum", 1)
        step = (make_lm_train_step(zero_stage=sc["stage"], max_len=job["lm_kw"]["max_len"],
                                   grad_accum_steps=accum)
                if lm else make_train_step(zero_stage=sc["stage"], grad_accum_steps=accum))
        metrics = [{k: float(v) for k, v in step(state, _local_batch(b, mesh)).items()}
                   for b in job[f"{sc['kind']}_batches"]]
        out[name] = {"state": state.state_dict(), "metrics": metrics, "step": state.step,
                     "local_experts": next(p.shape[0] for n, p in model.named_parameters()
                                           if n.endswith("experts.w1"))}
        if sc.get("save"):
            ckpt_lib.save_checkpoint(os.path.join(job["dir"], name), 0, state)
    return {"moe": out}


def _trainer_steps(job, rank, world, group):
    """Each config of ``job["trainer_steps"]``: the image ``Trainer`` or
    ``LMTrainer`` built over the mesh as a user builds it (its models cut
    to ``job["model_kw"][name]`` through the registry), its state loaded
    from the whole initial weights, then ``steps`` train steps on the
    batches of its own train loader (this rank's rows, in the order the
    trainer gives them); the whole state, each step's metrics, and the
    first batch's rows as this rank saw them. A config that the trainer
    refuses returns the exception's type and message instead."""
    from distributed_training_tpu_torch import LMTrainer, Trainer
    from distributed_training_tpu_torch.train import lm_trainer, trainer

    out = {}
    for name, sc in job["trainer_steps"].items():
        cfg = sc["cfg"]
        cut = sc.get("model_kw", {})
        originals = (trainer.get_model, lm_trainer.get_model)
        trainer.get_model = lambda n, _g=originals[0], **kw: _g(n, **{**kw, **cut})
        lm_trainer.get_model = lambda n, _g=originals[1], **kw: _g(n, **{**kw, **cut})
        try:
            cls = LMTrainer if cfg.model == "transformer_lm" else Trainer
            try:
                t = cls(cfg, device="cpu")
            except (NotImplementedError, ValueError) as e:
                out[name] = {"raised": (type(e).__name__, str(e))}
                continue
        finally:
            trainer.get_model, lm_trainer.get_model = originals
        sd = t.state.state_dict()
        sd["model"] = {**sd["model"], **sc["weights"]}
        t.state.load_state_dict(sd)
        loader = t.make_loaders()[0]
        loader.set_epoch(0)
        metrics, first = [], None
        for i, batch in enumerate(loader):
            if i == sc["steps"]:
                break
            if first is None:
                first = batch
            metrics.append({k: float(v) for k, v in
                            t.train_step(t.state, t.place(batch)).items()})
        st = t.state
        held = {"params": sum(p.numel() for p in (st.shards or st.params()).values()),
                "whole": sum(math.prod(shape) for shape, _ in st.layouts.values()),
                **{k: sum(v.numel() for v in st.opt_state.slots[k].values())
                   for k in ("mu", "nu") if k in st.opt_state.slots}}
        out[name] = {"state": t.state.state_dict(), "metrics": metrics,
                     "step": t.state.step, "first": first, "held": held}
        if sc.get("save"):
            from distributed_training_tpu_torch import checkpoint as ckpt_lib

            ckpt_lib.save_checkpoint(os.path.join(job["dir"], name), 0, t.state)
    return {"trainer_steps": out}


def _trainer_fit(job, rank, world, group):
    """Each config of ``job["trainer_fit"]``: the image ``Trainer`` built
    as a user builds it, its model loaded from the whole initial weights,
    then ``fit()``; every train step's metrics (read on the host) and
    what ``fit()`` returns."""
    from distributed_training_tpu_torch import Trainer

    out = {}
    for name, sc in job["trainer_fit"].items():
        t = Trainer(sc["cfg"], device="cpu")
        sd = t.state.state_dict()
        sd["model"] = {**sd["model"], **sc["weights"]}
        t.state.load_state_dict(sd)
        steps, inner = [], t.train_step

        def recorded(state, batch, _inner=inner, _steps=steps):
            metrics = _inner(state, batch)
            _steps.append({k: float(v) for k, v in metrics.items()})
            return metrics

        t.train_step = recorded
        result = t.fit()
        out[name] = {"metrics": steps, "result": result,
                     "mesh": None if t.mesh is None else dict(t.mesh.sizes),
                     "model": t.state.state_dict()["model"]}
    return {"trainer_fit": out}


def _vit_ring(job, rank, world, group):
    """ViT with ``seq_axis`` over a sequence axis of the world's size: each
    rank its rows of ``job["vit_x"]``, whose tokens are its chunk of the
    sequence the ring attends over; its logits and the whole gradient of
    ``Σ logits · g`` (summed over the ranks)."""
    import torch.distributed as dist

    from distributed_training_tpu_torch.models import get_model

    mesh = _mesh({"data": 1, "sequence": world})
    model = get_model("vit_b16", seq_axis_name="sequence", mesh=mesh, **job["vit_ring_kw"])
    model.load_state_dict(job["vit_ring_model"])
    model.train()
    x, g = (torch.from_numpy(a).chunk(world)[rank] for a in (job["vit_x"], job["vit_g"]))
    logits = model(x)
    (logits * g).sum().backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    for t in grads.values():
        dist.all_reduce(t, group=group)
    return {"vit_ring": {"logits": logits.detach(), "grads": grads}}


def _lm_trainer_mesh(job, rank, world, group):
    """``LMTrainer.fit()`` of each config of ``job["trainer_cfgs"]``."""
    from distributed_training_tpu_torch import LMTrainer

    out = {}
    for name, cfg in job["trainer_cfgs"].items():
        t = LMTrainer(cfg, device="cpu")
        out[name] = {"result": t.fit(), "world": t.world_size, "strategy": t.strategy,
                     "model": t.state.state_dict()["model"]}
    return {"trainer": out}


def _cli_and_bench(job, rank, world, group):
    """The GPT CLI (``gpt/torch_cuda/train.py``) for each of
    ``job["cli_argv"]``, then the port bench's LM leg for each of
    ``job["bench_argv"]`` with its GPT cut to ``job["bench_model"]``."""
    import importlib.util

    from distributed_training_tpu_torch import bench, models

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "port_gpt_cli", os.path.join(root, "gpt", "torch_cuda", "train.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)  # the worker imports no JAX: not torch_lm_mesh
    out = {"cli": [cli.main(argv) for argv in job.get("cli_argv", [])]}
    get_model = models.get_model
    models.get_model = lambda name, **kw: get_model(name, **{**kw, **job["bench_model"]})
    os.environ["WORLD_SIZE"] = str(world)
    try:
        out["bench"] = [bench.main(argv)[0] for argv in job.get("bench_argv", [])]
    finally:
        models.get_model = get_model
        del os.environ["WORLD_SIZE"]
    return out


def _bench_legs(job, rank, world, group):
    """The port bench over the ranks (``WORLD_SIZE`` set, the group open),
    its models cut by ``job["bench_model"]`` (by model name): the image and
    LM legs of ``job["bench_legs"]`` (their argv) as ``image_step`` and
    ``lm_step`` set them up, ``job["bench_steps"]`` steps each, every
    step's loss and the whole model after them; then ``bench.main`` for
    each of ``job["bench_lines"]``, what it returned and the JSON lines it
    printed on this rank."""
    import contextlib
    import io
    import json

    from distributed_training_tpu_torch import bench, models

    get_model, cut = models.get_model, job["bench_model"]
    models.get_model = lambda name, **kw: get_model(name, **{**kw, **cut.get(name, {})})
    os.environ["WORLD_SIZE"] = str(world)
    device = torch.device("cpu")
    setups = {"image": bench.image_step, "lm": bench.lm_step}
    out = {}
    try:
        for leg, argv in job["bench_legs"].items():
            args = bench.build_parser().parse_args(argv)
            _, state, step, batch = setups[leg](args, device)
            losses = [float(step(state, batch)["loss"]) for _ in range(job["bench_steps"])]
            out[leg] = {"losses": losses, "model": state.state_dict()["model"],
                        "rows": len(next(iter(batch.values())))}
        out["lines"] = []
        for argv in job["bench_lines"]:
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                returned = bench.main(argv)
            out["lines"].append({"returned": returned, "printed": [
                json.loads(x) for x in printed.getvalue().splitlines() if x.startswith("{")]})
    finally:
        models.get_model = get_model
        del os.environ["WORLD_SIZE"]
    return {"bench_legs": out}


def _tp_clip_host_lists(job, rank, world, group):
    """A tensor-parallel GPT (data 1 × model ``world``, ZeRO 1) whose step
    clips its gradients to a norm that binds and reports ``grad_norm``:
    one step, then a second with ``torch.tensor`` wrapped, every call of it
    whose data is a Python list or tuple recorded (a host copy, which a CUDA
    graph's capture refuses), and both steps' metrics."""
    from distributed_training_tpu_torch.config import OptimizerConfig, PrecisionConfig
    from distributed_training_tpu_torch.models import get_model
    from distributed_training_tpu_torch.parallel.tensor_parallel import (
        TensorParallel,
        shard_model_,
    )
    from distributed_training_tpu_torch.parallel.zero import Zero
    from distributed_training_tpu_torch.train.lm_step import make_lm_batch, make_lm_train_step
    from distributed_training_tpu_torch.train.optim import make_optimizer
    from distributed_training_tpu_torch.train.precision import LossScaleState
    from distributed_training_tpu_torch.train.train_state import TrainState

    mesh = _mesh({"data": 1, "model": world})
    model = get_model("transformer_lm", generator=torch.Generator().manual_seed(0), **LM_KW)
    tp = TensorParallel.from_mesh(mesh)
    shard_model_(model, tp)
    state = TrainState.create(
        model, make_optimizer(OptimizerConfig(**{**OPT, "grad_clip_norm": 0.05})),
        LossScaleState.create(PrecisionConfig()), Zero(1, mesh.group("data", "sequence"), tp=tp))
    step = make_lm_train_step(zero_stage=1, max_len=LM_KW["max_len"], grad_norm_metric=True)
    toks = np.random.RandomState(3).randint(0, LM_KW["num_classes"], (2, 17)).astype(np.int32)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in make_lm_batch(toks).items()}
    metrics = [{k: float(v) for k, v in step(state, batch).items()}]
    real, lists = torch.tensor, []

    def recorded(data, *args, **kwargs):
        if isinstance(data, (list, tuple)):
            lists.append(repr(data)[:200])
        return real(data, *args, **kwargs)

    torch.tensor = recorded
    try:
        metrics.append({k: float(v) for k, v in step(state, batch).items()})
    finally:
        torch.tensor = real
    return {"tp_clip": {"metrics": metrics, "lists": lists,
                        "masks": len(state.zero._masks)}}


def _teardown_cycles(job, rank, world, group):
    """``job["teardown_cycles"]`` times: the straggler exchange's gloo group
    opened beside a default group that is not gloo (its backend read as
    NCCL's, as on the card), one exchange over it, then
    ``shutdown_distributed``; each cycle after the first opens the default
    group again on a new store first. Each cycle's rows. The last shutdown
    is the rank's last act before it exits, as at the end of
    :func:`_flight_world`."""
    import numpy as np
    import torch.distributed as dist

    from distributed_training_tpu_torch.observability import aggregate
    from distributed_training_tpu_torch.runtime import distributed

    rows = []
    for cycle in range(job["teardown_cycles"]):
        if cycle:
            distributed.initialize_distributed(
                init_method=f"file://{job['dir']}/store_cycle{cycle}", world_size=world,
                rank=rank, device="cpu", timeout_s=60)
        real = dist.get_backend
        dist.get_backend = lambda group=None: "nccl"
        try:
            host = aggregate.host_group()
        finally:
            dist.get_backend = real
        rows.append(aggregate.gather_payloads(np.full(2, float(rank)), world, group=host))
        distributed.shutdown_distributed()
    return {"teardown": rows}


def _pp_steps(job, rank, world, group):
    """Each pipeline scenario of ``job["pp_scenarios"]``: the pipeline step
    on this rank's rows (and time chunk) of the global batches, this rank's
    stage of the whole initial weights (cut by the rule table under a model
    axis, its experts under an expert axis); the whole state after the
    steps (every stage gathered, in layer order) and each step's metrics; a
    save when asked."""
    from distributed_training_tpu_torch import checkpoint as ckpt_lib
    from distributed_training_tpu_torch.config import OptimizerConfig, PrecisionConfig
    from distributed_training_tpu_torch.models import get_model
    from distributed_training_tpu_torch.models.moe import MoEContext, shard_experts_
    from distributed_training_tpu_torch.parallel.pipeline import PipelinedLM
    from distributed_training_tpu_torch.parallel.tensor_parallel import (
        ExpertParallel,
        TensorParallel,
        shard_model_,
    )
    from distributed_training_tpu_torch.parallel.zero import Zero
    from distributed_training_tpu_torch.train.lm_step import make_pp_lm_train_step
    from distributed_training_tpu_torch.train.optim import make_optimizer
    from distributed_training_tpu_torch.train.precision import LossScaleState
    from distributed_training_tpu_torch.train.train_state import TrainState

    meshes, out = {}, {}
    for name, sc in job["pp_scenarios"].items():
        key = tuple(sorted(sc["mesh"].items()))
        if key not in meshes:  # every rank opens the same groups in turn
            meshes[key] = _mesh(sc["mesh"])
        mesh = meshes[key]
        kw = job[f"{sc['model']}_kw"]
        seq = {"seq_axis": "sequence", "mesh": mesh} if mesh.size("sequence") > 1 else {}
        model = get_model("transformer_lm", **kw, **seq)
        model.load_state_dict(job[f"{sc['model']}_model"])
        model = PipelinedLM(model, num_microbatches=sc["micro"],
                            virtual_stages=sc.get("virtual", 1), mesh=mesh)
        tp = TensorParallel.from_mesh(mesh)
        shard_model_(model, tp)
        shard_experts_(model, MoEContext.for_pipeline(mesh))
        state = TrainState.create(model, make_optimizer(OptimizerConfig(**sc["opt"])),
                                  LossScaleState.create(PrecisionConfig()),
                                  Zero(sc["stage"], mesh.group("data", "sequence"), tp=tp,
                                       ep=ExpertParallel.from_mesh(mesh), pp=model.stage))
        step = make_pp_lm_train_step(zero_stage=sc["stage"], max_len=kw["max_len"],
                                     **sc.get("step", {}))
        metrics = [{k: float(v) for k, v in step(state, _local_batch(b, mesh)).items()}
                   for b in job[f"{sc['model']}_batches"]]
        out[name] = {"state": state.state_dict(), "metrics": metrics, "step": state.step,
                     "layers": model.layers(model.stage.index)}
        if sc.get("save"):
            ckpt_lib.save_checkpoint(os.path.join(job["dir"], name), 0, state)
    return {"pp": out}


def _pp_cli(job, rank, world, group):
    """The GPT CLI's trainer (``gpt/torch_cuda/train.py``'s
    ``build_trainer``) for each of ``job["pp_cli"]``: ``fit()``'s result
    and the whole model after it; for each of ``job["pp_refused"]`` the
    exception's type and message."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "port_gpt_cli", os.path.join(root, "gpt", "torch_cuda", "train.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    runs = []
    for argv in job["pp_cli"]:
        t = cli.build_trainer(argv)
        runs.append({"result": t.fit(), "strategy": t.strategy,
                     "bubble": t.model.bubble_fraction,
                     "model": t.state.state_dict()["model"]})
    refused = []
    for argv in job["pp_refused"]:
        try:
            cli.build_trainer(argv)
            refused.append(None)
        except (NotImplementedError, ValueError) as e:
            refused.append((type(e).__name__, str(e)))
    return {"pp_cli": runs, "pp_refused": refused}


def _flight_world(job, rank, world, group):
    """Each config of ``job["flight_cfgs"]``: ``fit()`` with the flight
    instruments at their defaults, then the cross-rank summary the last
    flush exchanged (over gloo) and the recorder's step count; rank 0
    dumps the record to the config's ``dump``."""
    from distributed_training_tpu_torch import LMTrainer, Trainer

    out = {}
    for name, sc in job["flight_cfgs"].items():
        cfg = sc["cfg"]
        t = (LMTrainer if cfg.model == "transformer_lm" else Trainer)(cfg, device="cpu")
        t.fit()
        if rank == 0:
            t.obs.dump(sc["dump"])
        out[name] = {"hosts": t.obs.host_summary,
                     "recorded": t.obs.recorder._count,
                     "flushes": t.obs.recorder.flushes}
    # Both ranks past their last exchange before either tears its group down.
    torch.distributed.barrier()
    return {"flight": out, "host_group": _host_group_reuse()}


def _chaos_world(job, rank, world, group):
    """Chaos across the ranks (``job["chaos_cfg"]`` a micro LM config):
    a slow step every 2nd step on rank 1 alone, traced (each rank writes
    its ``trace_p<rank>.json``), and the cross-rank summary that names the
    straggler; then a SIGTERM kill at step 2 on every rank, its save, the
    run resumed at the same world, and the uninterrupted run, each rank's
    final state."""
    import dataclasses

    from distributed_training_tpu_torch import LMTrainer
    from distributed_training_tpu_torch.config import (
        ChaosConfig,
        CheckpointConfig,
        ObservabilityConfig,
        TraceConfig,
    )

    cfg, root = job["chaos_cfg"], job["chaos_dir"]

    def ckpt(name):
        return dataclasses.replace(cfg.checkpoint, directory=os.path.join(root, name))

    slow = LMTrainer(cfg.replace(
        checkpoint=ckpt("slow"),
        chaos=ChaosConfig(slow_step_every=2, slow_step_ms=60.0, slow_step_host=1),
        observability=ObservabilityConfig(trace=TraceConfig(enabled=True))), device="cpu")
    slow.fit()
    out = {"hosts": slow.obs.host_summary, "trace_path": slow.obs.trace_path,
           "slow_steps": slow.chaos.counters["slow_steps"]}
    runs = {}
    for name, chaos in (("base", ChaosConfig()), ("killed", ChaosConfig(kill_at_step=2)),
                        ("resumed", ChaosConfig())):
        t = LMTrainer(cfg.replace(checkpoint=ckpt("base" if name == "base" else "kill"),
                                  chaos=chaos), device="cpu")
        runs[name] = {"result": t.fit(), "state": t.state.state_dict()}
    torch.distributed.barrier()
    return {"chaos": {**out, "runs": runs}}


def _host_group_reuse() -> dict:
    """``aggregate.host_group`` under a default group that is not gloo (its
    backend read as NCCL's): the gloo group it opens beside it, the same
    object at a second call (a second trainer of the process), and an
    exchange over it."""
    import numpy as np
    import torch.distributed as dist

    from distributed_training_tpu_torch.observability import aggregate

    real = dist.get_backend
    dist.get_backend = lambda group=None: "nccl"
    try:
        first, second = aggregate.host_group(), aggregate.host_group()
    finally:
        dist.get_backend = real
    rank = dist.get_rank()
    rows = aggregate.gather_payloads(np.full(3, float(rank)), 2, group=first)
    return {"same": first is second, "world": first is dist.group.WORLD,
            "size": dist.get_world_size(first), "rows": rows}


def _collective_counter(job, rank, world, group):
    """``utils/collectives.count_collectives`` on a group of ranks 0 and 1
    (every rank opens it): each counted function called once with known
    shapes, an async all-reduce read right after it is issued, a nested
    call, and the functions after a normal exit and after an exception."""
    import torch.distributed as dist

    from distributed_training_tpu_torch.utils.collectives import count_collectives

    pair = dist.new_group([0, 1])
    if rank > 1:
        return {}
    originals = {n: getattr(dist, n) for n in ("all_reduce", "all_gather",
                                               "all_gather_into_tensor",
                                               "reduce_scatter_tensor", "broadcast",
                                               "batch_isend_irecv")}
    peer = 1 - rank
    with count_collectives() as acct:
        dist.all_reduce(torch.ones(3, 5), group=pair)
        dist.all_gather([torch.empty(4) for _ in range(2)], torch.ones(4), group=pair)
        dist.all_gather_into_tensor(torch.empty(12), torch.ones(6), group=pair)
        dist.reduce_scatter_tensor(torch.empty(3, dtype=torch.float64),
                                   torch.ones(6, dtype=torch.float64), group=pair)
        dist.broadcast(torch.ones(7, dtype=torch.int32), src=0, group=pair)
        recv = [torch.empty(2), torch.empty(3, dtype=torch.int64)]
        ops = [dist.P2POp(dist.isend, torch.ones(2), peer, pair),
               dist.P2POp(dist.irecv, recv[0], peer, pair),
               dist.P2POp(dist.isend, torch.ones(3, dtype=torch.int64), peer, pair),
               dist.P2POp(dist.irecv, recv[1], peer, pair)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        before = {k: dict(v) for k, v in acct.items()}
        work = dist.all_reduce(torch.ones(2), group=pair, async_op=True)
        issued = dict(acct["all-reduce"])
        work.wait()
    calls = {k: dict(v) for k, v in acct.items()}
    restored = all(getattr(dist, n) is f for n, f in originals.items())

    # A counted function that calls another: counted once, as the outer kind.
    real = dist.all_gather_into_tensor

    def gathers_after_a_reduce(out, inp, group=None, async_op=False):
        dist.all_reduce(torch.ones(1), group=group)
        return real(out, inp, group=group, async_op=async_op)

    dist.all_gather_into_tensor = gathers_after_a_reduce
    try:
        with count_collectives() as acct:
            dist.all_gather_into_tensor(torch.empty(4), torch.ones(2), group=pair)
        nested = {k: dict(v) for k, v in acct.items()}
    finally:
        dist.all_gather_into_tensor = real
    try:
        with count_collectives():
            dist.all_reduce(torch.ones(1), group=pair)
            raise ValueError("inside the block")
    except ValueError:
        pass
    after_raise = all(getattr(dist, n) is f for n, f in originals.items())
    return {"counter": {"calls": calls, "before_async": before, "issued": issued,
                        "received": [t.tolist() for t in recv], "restored": restored,
                        "nested": nested, "restored_after_raise": after_raise}}


def _accounting_rows(job, rank, world, group):
    """Every row of ``tools/collective_accounting.py`` over this world."""
    from distributed_training_tpu_torch.tools.collective_accounting import run_rows

    return {"rows": run_rows(world, None, torch.device("cpu"))}


def _world1_expectation(job, rank, world, group):
    """Last part of a run: the group closes; rank 0 opens a gloo group of
    one rank and, for each of ``chip_smoke.py``'s DP presets at micro width
    (``resnet_micro``, 4 images) and its GPT CLI ZeRO 2 run at micro width
    (``job["gpt_argv"]``), one step's collectives beside
    ``chip_smoke.expected_dp_collectives``."""
    import dataclasses

    from distributed_training_tpu_torch import Trainer
    from distributed_training_tpu_torch.runtime import distributed
    from distributed_training_tpu_torch.utils.collectives import step_collectives

    distributed.shutdown_distributed()
    if rank != 0:
        return {}
    import chip_smoke

    distributed.initialize_distributed(
        init_method=f"file://{os.path.join(job['dir'], 'store_world1')}", world_size=1,
        rank=0, device="cpu", timeout_s=60)
    trainers = []
    for plugin in chip_smoke.DP_PRESETS:
        cfg = chip_smoke._dp_config(plugin, os.path.join(job["dir"], plugin))
        trainers.append((plugin, Trainer(cfg.replace(
            model="resnet_micro",
            data=dataclasses.replace(cfg.data, batch_size=4, max_steps_per_epoch=1)),
            device="cpu")))
    trainers.append(("gpt_cli", chip_smoke._gpt_cli_module().build_trainer(
        [*job["gpt_argv"], "-c", os.path.join(job["dir"], "gpt")])))
    out = {}
    for name, t in trainers:
        loader = t.make_loaders()[0]
        loader.set_epoch(0)
        batch = t.place(next(iter(loader)))
        out[name] = {"stage": t.state.zero.stage, "world": t.state.zero.world,
                     "want": chip_smoke.expected_dp_collectives(t),
                     "got": step_collectives(t.train_step, t.state, batch)}
    return {"world1": out}


def run_named(rank: int, world: int, init_file: str, out_dir: str, names: tuple) -> None:
    """The parts named (functions of this module) on this rank."""
    _run_parts(rank, world, init_file, out_dir, tuple(globals()[n] for n in names))


def spawn(out_dir, world: int, names: tuple, timeout_s: float = 150.0):
    """Start ``world`` ranks of :func:`run_named` (a ``file://`` store in
    ``out_dir``); returns a function that joins them, raises on a hung or
    failed rank, and returns every rank's results."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run_named,
                         args=(r, world, os.path.join(str(out_dir), "store"), str(out_dir),
                               names))
             for r in range(world)]
    for p in procs:
        p.start()

    def join():
        for p in procs:
            p.join(timeout_s)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
        errors = [open(os.path.join(str(out_dir), f)).read()
                  for f in sorted(os.listdir(str(out_dir))) if f.startswith("error_")]
        if hung or errors or any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"{len(hung)} rank(s) hung, exit codes "
                               f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
        return [torch.load(os.path.join(str(out_dir), f"results_{r}.pt"),
                           weights_only=False) for r in range(world)]

    return join


def global_batches(n_steps: int, batch: int = 8, size: int = 64, seed: int = 0):
    """The train batches every run sees (numpy, NHWC float32)."""
    rng = np.random.RandomState(seed)
    return [{"image": rng.rand(batch, size, size, 3).astype(np.float32),
             "label": rng.randint(0, 10, batch).astype(np.int32)}
            for _ in range(n_steps)]
