"""The Trainer: epoch loop, eval, the ``target_acc`` gate, checkpointing,
on one device or data-parallel over a process group with ZeRO 0–3.

The port of ``distributed_training_tpu/train/trainer.py``.
``Trainer(cfg).fit()`` returns the JAX trainer's keys: ``final_acc``,
``preempted``, ``last_metrics`` and ``steps`` (committed updates).

It runs on the card unless ``device="cpu"`` is passed, and raises when
there is no card and no such request. Data parallelism: the Trainer opens
the process group from the launcher's environment
(``runtime.distributed.initialize_distributed``; ``torchrun`` sets it), or
joins the one already open, and takes from it the world size, the rank's
slice of every batch and, on the card, its device (``cuda:LOCAL_RANK``).
Without a group it runs alone, at world 1. Rank 0 alone prints and writes
checkpoints.

What both trainers share (:class:`Engine`), as the JAX trainers' ``_fit``
wires it:

- a SIGTERM guard (``runtime/preemption.py``): the step loop breaks at
  the signal (under a group, at the next log-interval flush, where the
  ranks agree on the flag), and with ``checkpoint.save_on_preemption`` a
  synchronous save records where in its epoch training stopped, so an
  ``auto_resume`` run trains no batch twice; ``fit()`` then returns
  ``preempted=True``;
- ``checkpoint.async_save``: saves go through the background writer
  (``resilience/async_ckpt.py``), which the run drains before ``fit()``
  returns;
- the metric sinks (``tensorboard_dir``, ``metrics_jsonl``;
  ``utils/metrics_io.py``), written at each log-interval flush and after
  each eval;
- ``wall_clock_breakdown`` (``utils/profiling.py``'s ``WallClock``:
  data, step, log, eval and ckpt, printed per epoch) and ``profile_dir``
  (a ``torch.profiler`` trace of the run);
- the flight instruments (``cfg.observability``, on by default as in
  JAX; ``observability/hooks.py``): one host timestamp a step, and at
  each meter flush MFU, the allocator's memory counters, the flight
  recorder, the cross-rank straggler view and the anomaly detector,
  whose trigger dumps the record and the batch under
  ``<checkpoint.directory>/flight``, traces the next steps and then
  raises or goes on; a crash dumps the record too. The wall clock runs on
  host time for them whenever the recorder is on;
- the span trace (``observability.trace.enabled``;
  ``observability/trace.py``), opened as the JAX trainers open it:
  ``<dir or the flight directory>/trace/trace.json`` (``trace_p<rank>.json``
  on several ranks), written at the run's end and on a crash, with the
  wall clock's phases (data, step, log, eval, ckpt) as spans on the
  ``train`` track, the async writer's on ``ckpt-writer`` and the chaos
  injections on ``chaos``. Spans read host time only: a ``step`` span
  times the step's dispatch, as in JAX, and never synchronises the card;
- the live exporter (``observability.metrics_port``; rank 0 only):
  ``/metrics``, ``/healthz`` and ``/vars`` from a thread, over host values
  the meter's flush already fetched;
- chaos (``cfg.chaos``; ``resilience/chaos.py``): when active, a
  ``ChaosMonkey`` at JAX's points: after each step's metric push (slow
  steps, the kill at a step: SIGTERM goes through the preemption guard,
  SIGKILL saves nothing), after each save (rank 0; in the async writer's
  thread with ``async_save``) and, installed for ``fit()``, in the
  loaders' reads; its counters go into the flight dump's
  ``resilience.chaos_faults``;
- ``remat``, passed to the model (and the image Trainer's
  ``remat_policy`` argument, to the ResNet);
- ``data.prefetch``: with ``prefetch ≥ 1`` a worker thread loads each
  batch and copies it to the device that many batches ahead
  (``data/prefetch.py``: pinned staging and a copy stream of its own on
  the card), for training, precise-BN and eval; at 0 each batch is
  loaded and copied in the loop, under the wall clock's ``data`` phase.

The ``fsdp`` mesh axis shards the parameters and the optimizer state
(``parallel/zero.py``, JAX ``zero_stage_axes``) and splits the batch
with ``data``: rank ``d·F + f`` takes that block of every global batch
(JAX's ``batch_sharding``), SyncBN counts over both axes, and the
gradients are averaged over them. The local-BN step splits the training
batch over ``data`` alone, as JAX's shard_map step does (the fsdp ranks
of a data index then train on the same rows); eval splits over both.

The image Trainer runs the ``moe_*`` models (``models/moe.py``) with
``cfg.moe``'s knobs, as the JAX Trainer wires them: the mesh
(``cfg.mesh``, ``runtime/mesh.py``) may then carry an ``expert`` axis,
whose ranks hold the same rows and shard the experts; the gate is global
over the data group, the batch is ``batch_size`` a rank over every rank
(the JAX Trainer's per-chip rule) split over the data axis, and ZeRO runs
over the data group. ``moe.enabled`` on another model raises, as in JAX.

The image models run on no ``sequence`` or ``pipe`` axis of their own,
and the models without MoE layers on no ``expert`` axis: as in JAX, whose
``Trainer`` builds its mesh from every ``MeshSpec`` axis, shards the batch
over ``data × fsdp`` alone and counts every rank in the global batch, the
step is replicated over them (the ranks of a ``(data, fsdp)`` index train
on the same rows and keep the same state).

The ``vit_*`` models (``models/vit.py``) take a ``model`` axis: megatron
tensor parallelism by the rule table (``parallel/tensor_parallel.py``),
the batch split over the data axis only, ZeRO over the data group, and
with ``tp_overlap`` the ring-overlapped schedule of JAX's
``replicated_overlap_interceptor`` (at ``model == 1`` the plain step, as
in JAX). A ``model`` axis on another model raises JAX's
``NotImplementedError``.

Gradient accumulation follows the JAX step that runs: under its GSPMD
step (SyncBN, BN-free models, plain TP) microbatch *m* is a contiguous
block of the global batch split over the data ranks, and the loaders give
each rank its shares of the blocks in order
(``data/pipeline.py::process_rows``); the local-BN step and
``tp_overlap`` accumulate shard-locally, as JAX's shard_map steps do.

The image Trainer adds precise-BN (``eval_precise_bn_batches``): before
an eval that reads the live BatchNorm statistics, they are re-estimated
from that many training batches with the current weights, as the mean of
the batches' own statistics.
"""

from __future__ import annotations

import contextlib
import itertools
import os

import torch

from distributed_training_tpu_torch import checkpoint as ckpt_lib
from distributed_training_tpu_torch.config import (
    TrainConfig,
    effective_batch_sizes,
    resolve_data_axis,
)
from distributed_training_tpu_torch.data.pipeline import (
    SkipBatches,
    build_dataloaders,
    to_device,
)
from distributed_training_tpu_torch.data.prefetch import prefetch_to_device
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.models.moe import MoEContext, shard_experts_
from distributed_training_tpu_torch.models.resnet import (
    BN_MOMENTUM,
    BatchNorm,
    set_batchnorm_group,
)
from distributed_training_tpu_torch.parallel.tensor_parallel import (
    ExpertParallel,
    TensorParallel,
    shard_model_,
)
from distributed_training_tpu_torch.observability.anomaly import AnomalyError
from distributed_training_tpu_torch.observability.flops import (
    forward_flops,
    train_step_flops,
)
from distributed_training_tpu_torch.observability import trace as trace_lib
from distributed_training_tpu_torch.observability.hooks import TrainObservability
from distributed_training_tpu_torch.parallel.zero import Zero
from distributed_training_tpu_torch.resilience import chaos as chaos_lib
from distributed_training_tpu_torch.resilience import retry as retry_lib
from distributed_training_tpu_torch.resilience.async_ckpt import AsyncCheckpointWriter
from distributed_training_tpu_torch.runtime.coordinator import Coordinator
from distributed_training_tpu_torch.runtime.distributed import (
    initialize_distributed,
    local_device,
)
from distributed_training_tpu_torch.runtime.mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_SEQUENCE,
    Mesh,
)
from distributed_training_tpu_torch.runtime.preemption import PreemptionGuard
from distributed_training_tpu_torch.train.optim import make_optimizer
from distributed_training_tpu_torch.train.precision import LossScaleState, Policy
from distributed_training_tpu_torch.train.step import (
    _input_images,
    make_eval_step,
    make_train_step,
)
from distributed_training_tpu_torch.train.train_state import TrainState, param_count
from distributed_training_tpu_torch.utils.device import set_fp32_math
from distributed_training_tpu_torch.utils.metrics_io import MetricsWriter
from distributed_training_tpu_torch.utils.profiling import WallClock, trace


def check_tp_model(cfg: TrainConfig, model, tp_size: int) -> None:
    """The JAX Trainer's checks of a ``model`` axis: only the ``vit_*``
    models have rules in the table, and their sharded dims must divide
    (``hidden_size`` under ``tp_overlap``, whose rings scatter it, else the
    class-parallel head's ``num_classes``), with its messages."""
    if tp_size <= 1:
        return
    if not cfg.model.startswith("vit"):
        raise NotImplementedError(
            f"a model mesh axis of {tp_size} is only wired for "
            f"the vit_* models (parallel/tensor_parallel.py rule "
            f"table); {cfg.model!r} would replicate over it")
    checks = [("num_heads", model.num_heads), ("mlp_dim", model.mlp_dim)]
    checks.append(("hidden_size", model.hidden_size) if cfg.tp_overlap
                  else ("num_classes", cfg.data.num_classes))
    for what, n in checks:
        if n % tp_size:
            raise ValueError(
                f"tensor parallelism size {tp_size} must "
                f"divide {what} (= {n})")


class MetricMeter:
    """Keeps the device metrics of the last steps and reads the newest
    every ``log_interval`` steps; ``history`` holds every read."""

    def __init__(self, log_interval: int = 100):
        self.log_interval = max(1, log_interval)
        self._pending: list[tuple[int, dict]] = []
        self.last: dict[str, float] = {}
        self.history: list[dict[str, float]] = []

    @property
    def pending(self) -> bool:
        """Whether steps were pushed since the last read."""
        return bool(self._pending)

    def push(self, step: int, metrics: dict) -> bool:
        self._pending.append((step, metrics))
        if len(self._pending) >= self.log_interval:
            self.flush()
            return True
        return False

    def flush(self) -> dict[str, float]:
        if not self._pending:
            return self.last
        step, metrics = self._pending[-1]
        self._pending.clear()
        self.last = {k: float(v) for k, v in metrics.items()}
        self.last["step"] = step
        self.history.append(self.last)
        return self.last


class Engine:
    """The run machinery both trainers share (see the module docstring).
    A subclass sets ``cfg``, ``coord``, ``device``, ``state``, ``meter``,
    ``train_step`` and calls :meth:`_init_run`; it provides the print tags
    ``tag`` and ``epoch_tag``, and may map each loader batch on the host
    first (:meth:`host_batch`)."""

    def _init_run(self, step_flops: int | None = None) -> None:
        """``step_flops``: the model FLOPs of one optimizer step (the
        effective global batch's), for the flight instruments' MFU."""
        cfg = self.cfg
        obs = cfg.observability
        rank, world = self.coord.process_index, self.coord.world_size
        # Forensics land next to the run's durable artifacts by default.
        dump_dir = obs.dump_dir or os.path.join(cfg.checkpoint.directory, "flight")
        # None unless trace.enabled: then no span is ever made.
        self.trace, trace_path = trace_lib.session_for_run(
            obs.trace, default_dir=dump_dir, rank=rank, world=world)
        # The clock runs whenever the flight recorder or the trace does, on
        # host time alone; it synchronises the card at its phase
        # boundaries only for wall_clock_breakdown, whose report it prints.
        self.clock = WallClock(
            cfg.wall_clock_breakdown or obs.flight_recorder or self.trace is not None,
            device=self.device if cfg.wall_clock_breakdown else None, trace=self.trace)
        self.metrics_writer = MetricsWriter(cfg.tensorboard_dir, cfg.metrics_jsonl,
                                            enabled=self.coord.is_master())
        self.chaos = (chaos_lib.ChaosMonkey(cfg.chaos, process_index=rank, trace=self.trace)
                      if cfg.chaos.active else None)
        self._ckpt_writer = (AsyncCheckpointWriter(
            post_save=self.chaos.after_checkpoint_save if self.chaos else None,
            printer=self.coord.print, trace=self.trace)
            if cfg.checkpoint.async_save else None)
        self._sync_saves = 0
        self._guard: PreemptionGuard | None = None
        self._global_step = 0
        self._epoch_step = 0
        self.obs = TrainObservability(
            obs, step_flops=step_flops, n_devices=world,
            clock=self.clock, is_master=self.coord.is_master(),
            printer=self.coord.print, dump_dir=dump_dir,
            extra_provider=self._resilience_snapshot,
            trace=self.trace, trace_path=trace_path,
            num_processes=world, device=self.device)

    def _resilience_snapshot(self) -> dict:
        """The flight dump's ``resilience`` section: saves committed and
        failed, I/O retries and, with chaos, its faults."""
        c = {"io_retries": retry_lib.total_retries(),
             "saves_committed": self._sync_saves, "saves_failed": 0}
        if self._ckpt_writer is not None:
            c["saves_committed"] += self._ckpt_writer.counters["saves_committed"]
            c["saves_failed"] = self._ckpt_writer.counters["saves_failed"]
        if self.chaos is not None:
            c["chaos_faults"] = dict(self.chaos.counters)
        return {"resilience": c}

    # -- data -----------------------------------------------------------------
    def host_batch(self, batch: dict) -> dict:
        """A loader batch as the step takes it, still on the host."""
        return batch

    def place(self, batch: dict) -> dict:
        """A loader batch on the device, copied now."""
        return to_device(self.host_batch(batch), self.device)

    def _batches(self, loader):
        """The loader's batches on the device: prefetched
        ``data.prefetch`` ahead on a worker thread, or at 0 placed one by
        one as they are drawn. A generator; close it to stop the worker."""
        if self.cfg.data.prefetch < 1:
            return (self.place(b) for b in loader)
        return iter(prefetch_to_device(loader, self.device, self.cfg.data.prefetch,
                                       host=self.host_batch))

    # -- checkpoints ----------------------------------------------------------
    def _save_ckpt(self, epoch: int, *, sync: bool = False, **kw) -> None:
        """One save through the configured path: the background writer
        (snapshot now, persist later; ``sync=True`` durable before return,
        the preemption contract) or a synchronous save."""
        d = self.cfg.checkpoint.directory
        if self._ckpt_writer is not None:
            self._ckpt_writer.save(d, epoch, self.state, sync=sync, **kw)
        else:
            path = ckpt_lib.save_checkpoint(d, epoch, self.state, **kw)
            self._sync_saves += 1
            # Rank 0 wrote the save, and every rank has passed its barrier.
            if self.chaos is not None and self.coord.is_master():
                self.chaos.after_checkpoint_save(path, epoch)

    def _prune_ckpts(self) -> None:
        """Retention sweep (rank 0), after any save in flight."""
        if not self.coord.is_master():
            return
        d, keep = self.cfg.checkpoint.directory, self.cfg.checkpoint.keep
        if self._ckpt_writer is not None:
            self._ckpt_writer.prune(d, keep)
        else:
            ckpt_lib.prune_checkpoints(d, keep)

    # -- train ----------------------------------------------------------------
    def train_epoch(self, epoch: int, loader, skip_steps: int = 0) -> dict:
        """One epoch; ``skip_steps`` drops that many leading batches of the
        epoch's deterministic shuffle (step-accurate resume). Breaks early
        when the preemption guard says so."""
        loader.set_epoch(epoch)
        if skip_steps:
            self.coord.print(f"[{self.tag}] resuming epoch {epoch} at step {skip_steps}")
            loader = SkipBatches(loader, skip_steps)
        self._epoch_step = skip_steps
        self.obs.on_epoch()  # the boundary's pause is no straggler step
        batches = self._batches(loader)
        batch = None
        try:
            while True:
                # Prefetched, this phase is the wait for the worker.
                with self.clock.phase("data"):
                    nxt = next(batches, None)
                if nxt is None:
                    break
                batch = nxt
                with self.clock.phase("step"):
                    metrics = self.train_step(self.state, batch)
                with self.clock.phase("log"):
                    self._global_step += 1
                    self._epoch_step += 1
                    fetched = self.meter.push(self._global_step, metrics)
                    # Chaos before the recorder's timestamp: a slow step's
                    # stall lands in this step's interval, as a real one's.
                    if self.chaos is not None:
                        self.chaos.on_step(self._global_step)
                    self.obs.on_step(self._global_step)
                    if fetched:
                        extras = self.obs.on_flush(self.meter.last, batch=batch)
                        self.metrics_writer.write(self.meter.last["step"],
                                                  {**self.meter.last, **extras})
                if self._guard is not None and self._guard.should_stop(at_sync_point=fetched):
                    break
        finally:
            batches.close()
        if self.meter.pending:
            flushed = self.meter.flush()
            extras = self.obs.on_flush(flushed, batch=batch)
            self.metrics_writer.write(flushed["step"], {**flushed, **extras})
        self.coord.print(f"[{self.epoch_tag}] epoch {epoch + 1}: "
                         + " ".join(f"{k}={v:.4g}" for k, v in self.meter.last.items()))
        if self.cfg.wall_clock_breakdown:
            self.coord.print(f"[wall_clock] {self.clock.report()}")
        return self.meter.last

    # -- full run -------------------------------------------------------------
    def fit(self) -> dict:
        if self.chaos is not None:
            # The loaders poll the process-wide registration; this fit only.
            chaos_lib.install(self.chaos)
        try:
            result = self._fit()
            # A deferred anomaly raise whose trace window the run's end
            # cut short surfaces here (its forensics were written).
            self.obs.close()
            return result
        except AnomalyError:
            raise
        except BaseException:
            # The flight record before the exception flies.
            self.obs.on_crash()
            raise
        finally:
            if self.chaos is not None:
                chaos_lib.uninstall()
            if self._ckpt_writer is not None:
                # A background failure was counted and printed; it must not
                # mask this run's outcome or exception.
                self._ckpt_writer.close(raise_on_error=False)
            self.obs.close(raise_pending=False)
            self.metrics_writer.close()

    def _run_epochs(self, train_loader, evaluate) -> tuple:
        """Resume, then the epochs of train, eval (``evaluate(epoch)``, every
        ``eval_every`` epochs) and saves, under the preemption guard and
        the profiler trace. Returns ``(last eval, the epoch it followed,
        preempted)``."""
        cfg = self.cfg
        start_epoch = start_step = 0
        resume = ckpt_lib.resolve_resume(cfg.checkpoint,
                                         quarantine=self.coord.is_master())
        if resume >= 0:
            start_epoch, start_step = ckpt_lib.restore_checkpoint(
                cfg.checkpoint.directory, resume, self.state)
            # The metric sinks continue the restored step axis.
            self._global_step = self.state.step
            self.coord.print(f"[{self.tag}] resumed at epoch {start_epoch}"
                             + (f" step {start_step}" if start_step else ""))
        result, result_epoch, preempted = None, -1, False
        with trace(cfg.profile_dir), PreemptionGuard() as guard:
            self._guard = guard
            for epoch in range(start_epoch, cfg.num_epochs):
                self.train_epoch(epoch, train_loader,
                                 skip_steps=start_step if epoch == start_epoch else 0)
                if guard.should_stop():
                    # Preempted mid-epoch: the save resumes this epoch after
                    # the batches it trained. A signal in the epoch's last
                    # log interval lets the epoch complete; that save rolls
                    # over to the next epoch.
                    preempted = True
                    if cfg.checkpoint.save_on_preemption:
                        done = self._epoch_step >= len(train_loader)
                        next_ep = epoch + 1 if done else epoch
                        estep = 0 if done else self._epoch_step
                        with self.clock.phase("ckpt"):
                            self._save_ckpt(epoch, sync=True, next_epoch=next_ep,
                                            epoch_step=estep)
                        self.coord.print(
                            f"[{self.tag}] SIGTERM: saved preemption checkpoint "
                            f"(resumes at epoch {next_ep} step {estep})")
                    break
                if cfg.eval_every and (epoch + 1) % cfg.eval_every == 0:
                    with self.clock.phase("eval"):
                        result = evaluate(epoch)
                    result_epoch = epoch + 1
                if cfg.checkpoint.interval and (epoch + 1) % cfg.checkpoint.interval == 0:
                    with self.clock.phase("ckpt"):
                        self._save_ckpt(epoch)
                        self._prune_ckpts()
        self._guard = None
        if self._ckpt_writer is not None:
            # The run's saves are durable before fit() reports done.
            self._ckpt_writer.wait(raise_on_error=False)
        return result, result_epoch, preempted


class Trainer(Engine):
    """End-to-end training engine, data-parallel over the default process
    group when one is open (see the module docstring)."""

    tag, epoch_tag = "trainer", "train"

    def __init__(self, cfg: TrainConfig, device: str | torch.device | None = None, *,
                 remat_policy: str | None = None):
        """``remat_policy`` goes to the ResNet (``"conv"``: each block saves
        only its conv outputs); the JAX ``TrainConfig`` has no field for it,
        so it is an argument here."""
        if cfg.moe.enabled and not cfg.model.startswith("moe"):
            raise NotImplementedError(
                f"MoE is only wired into the moe_* models (models/moe.py); "
                f"model {cfg.model!r} would silently train dense")
        self.cfg = cfg
        group = initialize_distributed(device=device)
        self.coord = Coordinator()
        self.device = local_device(device)
        set_fp32_math()
        self.world_size = resolve_data_axis(cfg.mesh, self.coord.world_size)
        policy = Policy.from_config(cfg.precision)
        gen = torch.Generator().manual_seed(cfg.seed)
        # This rank's slice of each global batch: its data shard's.
        self.mesh, ep, self.tp, fsdp, inner = None, None, None, None, None
        self._shard = dict(process_index=self.coord.process_index,
                           process_count=self.coord.process_count)
        self._train_shard = self._shard
        if cfg.model.startswith("moe") or any(
                getattr(cfg.mesh, a) != 1
                for a in ("model", "fsdp", "sequence", "pipe", "expert")):
            # Ranks that are not all data ranks: the expert axis of the MoE
            # models, the model axis of ViT (checked below), the fsdp axis,
            # and the sequence and pipe axes, and the expert axis of a model
            # without MoE layers, over which the step is replicated. The
            # batch splits over data × fsdp alone (JAX's batch_sharding);
            # the pipe and expert ranks reduce within their own
            # data × fsdp × sequence group, the sequence ranks' identical
            # gradients average to the same mean.
            self.mesh = Mesh(cfg.mesh)
            group = self.mesh.group(AXIS_DATA, AXIS_FSDP, AXIS_SEQUENCE)
            fsdp = self.mesh.group(AXIS_FSDP)
            inner = self.mesh.group(AXIS_DATA, AXIS_SEQUENCE)
            self._shard = self._train_shard = dict(
                process_index=self.mesh.replica_index,
                process_count=self.mesh.data_size)
        tp_size = self.mesh.size(AXIS_MODEL) if self.mesh is not None else 1
        if cfg.model.startswith("moe"):
            # The JAX Trainer passes remat only when set (this model has
            # none, so it raises), and the MoE knobs; the expert axis comes
            # from the mesh.
            model_kwargs = dict(
                num_experts=tuple(cfg.moe.num_experts), top_k=cfg.moe.top_k,
                capacity_factor=cfg.moe.capacity_factor,
                min_capacity=cfg.moe.min_capacity,
                noisy_gate_policy=cfg.moe.noisy_gate_policy,
                mlp_type=cfg.moe.mlp_type, **({"remat": True} if cfg.remat else {}))
            ep = ExpertParallel.from_mesh(self.mesh)
        elif cfg.model.startswith("vit"):
            # pos_embed's length comes from the image size (Flax takes it
            # from the init input).
            model_kwargs = dict(image_size=cfg.data.image_size,
                                **({"remat": True} if cfg.remat else {}))
        else:
            model_kwargs = dict(remat=cfg.remat, remat_policy=remat_policy)
        model = get_model(cfg.model, num_classes=cfg.data.num_classes,
                          dtype=policy.compute_dtype, generator=gen, **model_kwargs)
        check_tp_model(cfg, model, tp_size)
        if tp_size > 1:
            self.tp = TensorParallel.from_mesh(self.mesh, overlap=cfg.tp_overlap)
            shard_model_(model, self.tp)
        shard_experts_(model, MoEContext.from_mesh(self.mesh, batch_over_fsdp=True))
        self.model = model.to(self.device)
        has_bn = any(isinstance(m, BatchNorm) for m in self.model.modules())
        local_bn = not cfg.sync_batchnorm and has_bn
        if local_bn and cfg.zero.stage != 0:
            raise NotImplementedError(
                "sync_batchnorm=False uses the explicit DP step, which has no "
                "ZeRO sharding; use zero stage 0 with local BN")
        if local_bn and cfg.zero.cpu_offload:
            raise NotImplementedError(
                "cpu_offload rides the ZeRO optimizer-state partition, which "
                "the local-BN step does not have")
        set_batchnorm_group(self.model, None if local_bn else group)
        if local_bn and self.mesh is not None:
            # JAX's local-BN step is a shard_map over data alone: the fsdp
            # ranks of a data index train on the same rows (eval still
            # splits over data × fsdp).
            self._train_shard = dict(process_index=self.mesh.index(AXIS_DATA),
                                     process_count=self.mesh.size(AXIS_DATA))
        n_params = param_count(self.model, ep, self.tp)
        self.tx = make_optimizer(cfg.optimizer, cfg.scheduler, self.world_size)
        self.state = TrainState.create(
            self.model, self.tx, LossScaleState.create(cfg.precision),
            Zero(cfg.zero.stage, group, cfg.zero.cpu_offload, tp=self.tp, ep=ep,
                 fsdp=fsdp, inner=inner))
        # batch_size is per rank: under a data × expert (or model) mesh every
        # rank adds its batch to the global one, as the JAX Trainer counts chips.
        self.train_gbs, self.eval_gbs, self.grad_accum = effective_batch_sizes(
            cfg, self.coord.world_size if self.mesh is not None else self.world_size,
            allow_derive=True)
        # JAX's microbatch order where it accumulates under GSPMD; the
        # local-BN and tp_overlap steps accumulate shard-locally.
        overlap = self.tp is not None and self.tp.overlap
        self._microbatches = 1 if local_bn or overlap else self.grad_accum
        self.input_affine = input_affine = (
            (2.0 / 255.0, -1.0) if cfg.data.augment == "normalize_only"
            else (1.0 / 255.0, 0.0))
        self.train_step = make_train_step(
            zero_stage=cfg.zero.stage, grad_accum_steps=self.grad_accum,
            label_smoothing=cfg.label_smoothing, input_affine=input_affine,
            local_bn=local_bn and group is not None, seed=cfg.seed,
            grad_norm_metric=cfg.observability.grad_norm)
        self.eval_step = make_eval_step(input_affine=input_affine)
        self.meter = MetricMeter(cfg.log_interval)
        self.last_eval: dict[str, float] = {}
        self._init_run(train_step_flops(forward_flops(
            self.model, image_size=cfg.data.image_size, batch=self.train_gbs)))
        self.coord.print(
            f"[trainer] model={cfg.model} params={n_params:,} "
            f"device={self.device} plugin={cfg.plugin} "
            f"dtype={cfg.precision.dtype} optimizer={cfg.optimizer.name}"
            + (f" world={self.world_size} zero={cfg.zero.stage}"
               + (" cpu_offload" if cfg.zero.cpu_offload else "")
               + ("" if group is None or not has_bn
                  else " local_bn" if local_bn else " sync_bn")
               if group is not None or cfg.zero.stage else "")
            + (f" mesh={ {a: n for a, n in self.mesh.sizes.items() if n > 1} }"
               if self.mesh is not None and self.mesh.world > 1 else "")
            + (" tp-overlap" if overlap else "")
            + (f" grad_accum={self.grad_accum}" if self.grad_accum > 1 else ""))

    def make_loaders(self):
        kw = dict(seed=self.cfg.seed, global_batch_size=self.train_gbs,
                  eval_global_batch_size=self.eval_gbs,
                  microbatches=self._microbatches)
        train, evals = build_dataloaders(self.cfg, **kw, **self._train_shard)
        if self._train_shard is not self._shard:
            evals = build_dataloaders(self.cfg, **kw, **self._shard)[1]
        return train, evals

    def uses_ema(self) -> bool:
        """Eval reads the EMA of the parameters and of the BatchNorm
        statistics (``optimizer.ema_decay`` with ``eval_with_ema``)."""
        return self.cfg.optimizer.ema_decay is not None and self.cfg.eval_with_ema

    @torch.no_grad()
    def refresh_batch_stats(self, train_loader, num_batches: int) -> None:
        """Precise-BN (the JAX ``_refresh_batch_stats``): the running
        statistics re-estimated with the current parameters as the mean of
        the first ``num_batches`` training batches' own statistics. Each
        batch's train-mode forward ticks the statistics once from zero,
        giving ``(1 − momentum) · stat``, which is divided back out as the
        JAX trainer does; the optimizer is not involved. Every rank runs
        its slice; SyncBN makes the statistics global."""
        model, stats = self.model, self.state.stats()
        acc, n = None, 0
        self.state.gather_params()
        model.train()
        for batch in self._batches(itertools.islice(iter(train_loader), num_batches)):
            for b in stats.values():
                b.zero_()
            model(_input_images(batch, self.input_affine))
            ticked = {k: b / (1.0 - BN_MOMENTUM) for k, b in stats.items()}
            acc = ticked if acc is None else {k: acc[k] + v for k, v in ticked.items()}
            n += 1
        self.state.release_params()
        if n:
            for k, b in stats.items():
                b.copy_(acc[k] / n)

    def evaluate(self, loader, train_loader=None) -> float:
        """Top-1 accuracy over every rank's slice of the eval set (the step
        sums its counts over the ranks), with the EMA weights when
        :meth:`uses_ema`; top-5 is kept on ``self.last_eval``. With
        ``eval_precise_bn_batches`` and a ``train_loader``, the BatchNorm
        statistics are refreshed first when eval reads the live ones."""
        k = self.cfg.eval_precise_bn_batches
        if k and train_loader is not None and not self.uses_ema() and self.state.stats():
            self.refresh_batch_stats(train_loader, k)
        sums = torch.zeros(3, device=self.device)
        with (self.state.ema_weights() if self.uses_ema()
              else contextlib.nullcontext()):
            for batch in self._batches(loader):
                c, c5, t = self.eval_step(self.state, batch)
                sums += torch.stack([c, c5, t])
            self.state.release_params()
        correct, correct5, total = sums.tolist()
        self.last_eval = {"top1": correct / max(total, 1.0),
                          "top5": correct5 / max(total, 1.0)}
        self.metrics_writer.write(self._global_step, self.last_eval, prefix="eval")
        return self.last_eval["top1"]

    def _fit(self) -> dict:
        cfg = self.cfg
        train_loader, eval_loader = self.make_loaders()

        def evaluate(epoch: int) -> float:
            acc = self.evaluate(eval_loader, train_loader)
            self.coord.print(f"[eval] epoch {epoch + 1}: top-1 {acc:.4f}")
            return acc

        final_acc, last_eval_epoch, preempted = self._run_epochs(train_loader, evaluate)
        if preempted:
            return {"final_acc": None, "preempted": True,
                    "last_metrics": self.meter.last, "steps": self.state.step}
        if cfg.target_acc is not None:
            if final_acc is None or last_eval_epoch != cfg.num_epochs:
                final_acc = self.evaluate(eval_loader, train_loader)
            if final_acc < cfg.target_acc:
                raise RuntimeError(
                    f"target accuracy {cfg.target_acc} not reached "
                    f"(got {final_acc:.4f})")
        return {"final_acc": final_acc, "preempted": False,
                "last_metrics": self.meter.last, "steps": self.state.step}
