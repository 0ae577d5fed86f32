"""Train state: model, optimizer state, loss scaler and step count as one
object, partitioned by its ZeRO stage.

The JAX package carries these as one immutable pytree through a jitted
step, placed on the mesh by ``parallel/sharding.py``. PyTorch updates in
place, so here they are one mutable object that the step changes: the
model's parameters and BatchNorm buffers, the optimizer's state, the loss
scaler and the number of committed updates.

Under ZeRO (``zero``, a ``parallel.zero.Zero``) the optimizer works on the
*master* parameters (:meth:`TrainState.master_params`): the model's own
tensors at stage 0, this rank's shards at stages 1–3. Every slot of the
optimizer's state (Adam's moments, the SGD trace, the parameters' EMA and
the BatchNorm statistics' EMA) is shard-shaped from stage 1 on, by the one
partition rule, and lives in host memory with ``cpu_offload`` (pinned
where there is a card). At stage 3 the shards
*are* the parameters between steps: the model's parameter tensors are
emptied after each step (:meth:`release_params`) and all-gathered again
before the next forward (:meth:`gather_params`). Under the ``fsdp`` axis
(``zero.fsdp``) the parameters are held as shards between steps at every
stage, as at stage 3, and the optimizer state is split as
``parallel/zero.py`` lays it out. A checkpoint holds the
whole tensors whatever the stage and world (:meth:`state_dict` gathers,
:meth:`load_state_dict` partitions anew). Under tensor parallelism
(``zero.tp``) the model's tensors are this model rank's shards, which the
ZeRO partition splits further; a checkpoint gathers them by the rule table
(``parallel/tensor_parallel.py``) too, and a load cuts them again, so a
save resumes at any ``(data, model, sequence)`` layout. The same holds
for the expert leaves under expert parallelism (``zero.ep``): a save
gathers every expert over the expert group, and a load cuts this rank's
block again, at any expert-axis size. Under the pipeline (``zero.pp``)
the model is this rank's stage: a save gathers every stage's blocks over
the pipe group into the world-1 format, in layer order (with JAX's layout
metadata beside it, ``layout``), and a load keeps this stage's, so a save
at any ``(pipe, virtual_stages)`` resumes at any other layout or at
world 1.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from distributed_training_tpu_torch.parallel.tensor_parallel import (
    gather_tensor,
    shard_tensor,
)
from distributed_training_tpu_torch.parallel.zero import Zero
from distributed_training_tpu_torch.train.optim import Optimizer, OptState
from distributed_training_tpu_torch.train.precision import LossScaleState


def _host_zeros(like: torch.Tensor) -> torch.Tensor:
    """float32 zeros of ``like``'s shape in host memory, pinned when the
    tensor it stands for is on a card (pinning needs CUDA)."""
    return torch.zeros(like.shape, dtype=torch.float32,
                       pin_memory=like.device.type == "cuda")


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    tx: Optimizer
    opt_state: OptState
    loss_scale: LossScaleState
    step: int = 0
    zero: Zero = dataclasses.field(default_factory=Zero)
    # Per parameter name: whether it takes weight decay (decided on the
    # full tensors), its shape and memory format, and (stage 3) its shard.
    decay: dict = dataclasses.field(default_factory=dict)
    layouts: dict = dataclasses.field(default_factory=dict)
    shards: dict | None = None
    # Set while ``train/multi_step.py`` runs its steps: the update reads its
    # count on the card, and what needs the host (the dynamic loss scale,
    # dropout's seed) raises.
    capturable: bool = False

    @classmethod
    def create(cls, model: torch.nn.Module, tx: Optimizer,
               loss_scale: LossScaleState | None = None,
               zero: Zero | None = None) -> "TrainState":
        if loss_scale is None:
            loss_scale = LossScaleState(scale=1.0, good_steps=0,
                                        hysteresis_left=1, dynamic=False)
        state = cls(model=model, tx=tx, opt_state=None, loss_scale=loss_scale,
                    zero=zero or Zero())
        params = state.params()
        state.decay = tx.decay_flags(params)
        state.layouts = {n: (p.shape, not p.is_contiguous() and p.is_contiguous(
                             memory_format=torch.channels_last))
                         for n, p in params.items()}
        if state.zero.partitions_params:
            state.shards = {n: state.zero.param_shard(p) for n, p in params.items()}
        state.opt_state = tx.init(state.master_params())
        stats = state.stats()
        if tx.ema_decay is not None and stats:
            # with_ema's BatchNorm half: seeded with the initial statistics.
            state.opt_state.slots["ema_stats"] = {
                n: state.partition(b.float()).clone() for n, b in stats.items()}
        if state.zero.cpu_offload:
            for slot in state.opt_state.slots.values():
                for n, t in slot.items():
                    slot[n] = _host_zeros(t).copy_(t)
        state.release_params()
        return state

    def params(self) -> dict[str, torch.Tensor]:
        """Parameters by name (the model's tensors themselves)."""
        return dict(self.model.named_parameters())

    def stats(self) -> dict[str, torch.Tensor]:
        """BatchNorm statistics (the model's buffers) by name."""
        return dict(self.model.named_buffers())

    def partition(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the optimizer's state holds it: this rank's shard from
        stage 1 on, ``t`` itself at stage 0."""
        return self.zero.shard(t) if self.zero.partitions_optimizer else t

    def _device(self) -> torch.device:
        return next(self.model.buffers(), next(self.model.parameters())).device

    def master_params(self) -> dict[str, torch.Tensor]:
        """What the optimizer updates: the model's tensors at stage 0;
        this rank's shards from stage 1 on (copies of the replicated
        parameters at 1–2, the parameters themselves at 3). Under fsdp the
        parameter shards at stages 0 and 3, and at 1–2 copies of this
        rank's optimizer chunk of them."""
        if self.shards is not None:
            if self.zero.opt_is_param_shard:
                return self.shards
            return {n: self.zero.opt_from_param(p) for n, p in self.shards.items()}
        if not self.zero.partitions_optimizer:
            return self.params()
        return {n: self.zero.shard(p) for n, p in self.params().items()}

    @torch.no_grad()
    def apply_params(self, new: dict[str, torch.Tensor]) -> None:
        """Install updated master parameters: at stage 0 the model's
        tensors become ``new``'s (a swap of references when they are not
        the same tensors); at 1–2 the shards are all-gathered into them; at
        3 the shards are kept and the model's tensors stay released. Under
        fsdp the parameter shards are kept (at 1–2 gathered over the inner
        group from the optimizer chunks)."""
        if self.shards is not None:
            names = list(new)
            self.shards = dict(zip(names, self.zero.params_from_opt(
                [new[n] for n in names])))
            return
        params = self.params()
        if not self.zero.partitions_optimizer:
            for n, p in params.items():
                if new[n] is not p:
                    p.data = new[n]
            return
        names = list(params)
        full = self.zero.all_gather([new[n] for n in names],
                                    [params[n].shape for n in names])
        for n, f in zip(names, full):
            params[n].copy_(f)

    @torch.no_grad()
    def gather_params(self) -> None:
        """Stage 3: the model's parameter tensors all-gathered from the
        shards (before a forward); a no-op at other stages."""
        if self.shards is None:
            return
        params = self.params()
        names = list(params)
        full = self.zero.gather_params([self.shards[n] for n in names],
                                       [self.layouts[n][0] for n in names])
        for n, f in zip(names, full):
            fmt = (torch.channels_last if self.layouts[n][1]
                   else torch.contiguous_format)
            params[n].data = f.contiguous(memory_format=fmt)

    def release_params(self) -> None:
        """Stage 3: empty the model's parameter tensors, which the shards
        stand for between steps; a no-op at other stages."""
        if self.shards is None:
            return
        for p in self.model.parameters():
            p.data = p.data.new_empty(0)

    def offload_fetch(self) -> OptState:
        """The optimizer state on the master parameters' device: with
        ``cpu_offload``, copies of the host slots queued on the current
        stream (pinned, so the host does not wait); else the state itself."""
        st = self.opt_state
        if not self.zero.cpu_offload:
            return st
        dev = next(iter(self.master_params().values())).device
        return OptState(st.count, {
            k: {n: t.to(dev, non_blocking=True) for n, t in v.items()}
            for k, v in st.slots.items()}, st.count_t)

    @torch.no_grad()
    def offload_store(self, st: OptState) -> None:
        """Keep ``st`` as the optimizer state; with ``cpu_offload`` its
        slots are written back into the host tensors on the current
        stream (no host sync: the next step's fetch is queued behind it)."""
        if not self.zero.cpu_offload:
            self.opt_state = st
            return
        host = self.opt_state
        for k, v in st.slots.items():
            for n, t in v.items():
                host.slots[k][n].copy_(t, non_blocking=True)
        host.count, host.count_t = st.count, st.count_t

    def _shapes(self, slot: str, names) -> list:
        """The whole shapes of a slot's tensors: the buffers' for
        ``ema_stats``, the parameters' for every other slot."""
        if slot == "ema_stats":
            stats = self.stats()
            return [stats[n].shape for n in names]
        return [self.layouts[n][0] for n in names]

    def _full_slot(self, slot: str, tensors: dict, device=None) -> dict:
        """A slot's whole tensors (all-gathered from the shards from stage
        1 on), on ``device`` (default: the host)."""
        if not tensors or not self.zero.partitions_optimizer:
            return tensors if device is None else {
                n: t.to(device) for n, t in tensors.items()}
        if self.zero.cpu_offload and torch.cuda.is_available():
            torch.cuda.synchronize()  # the host copies written back last step
        dev = self._device()
        names = list(tensors)
        full = self.zero.all_gather([tensors[n].to(dev) for n in names],
                                    self._shapes(slot, names))
        return {n: f.to(device or "cpu") for n, f in zip(names, full)}

    @contextlib.contextmanager
    def ema_weights(self):
        """While the block runs, the model holds the parameters' EMA and
        the BatchNorm statistics' EMA (eval with ``eval_with_ema``); its
        own afterwards. Every rank must enter it (it all-gathers the EMA
        from stage 1 on)."""
        slots = self.opt_state.slots
        if "ema" not in slots:
            raise ValueError("the optimizer state carries no EMA; set "
                             "OptimizerConfig.ema_decay")
        dev = self._device()
        stats = self.stats()
        live_stats = {n: b.clone() for n, b in stats.items()}
        live_shards, live = self.shards, None
        if self.shards is not None:
            names = list(slots["ema"])
            self.shards = dict(zip(names, self.zero.params_from_opt(
                [slots["ema"][n].to(dev) for n in names])))
        else:
            live = {n: p.data for n, p in self.params().items()}
            full = self._full_slot("ema", slots["ema"], dev)
            for n, p in self.params().items():
                fmt = (torch.channels_last if self.layouts[n][1]
                       else torch.contiguous_format)
                p.data = full[n].view(self.layouts[n][0]).contiguous(memory_format=fmt)
        with torch.no_grad():
            for n, t in self._full_slot("ema_stats", slots.get("ema_stats", {}),
                                        dev).items():
                stats[n].copy_(t.view(stats[n].shape))
        try:
            yield
        finally:
            self.shards = live_shards
            if live is not None:
                for n, p in self.params().items():
                    p.data = live[n]
            with torch.no_grad():
                for n, b in live_stats.items():
                    stats[n].copy_(b)

    def _contexts(self) -> list:
        return [c for c in (self.zero.tp, self.zero.ep) if c is not None]

    def _whole(self, tensors: dict) -> dict:
        """Tensors by parameter name, the model-sharded ones gathered over
        the model ranks and the expert-sharded ones over the expert ranks,
        then every pipeline stage's blocks over the pipe ranks, in layer
        order (the tensors themselves without any)."""
        for ctx in self._contexts():
            tensors = {n: gather_tensor(t, ctx.dim(n), ctx) for n, t in tensors.items()}
        if self.zero.pp is not None:
            tensors = self.zero.pp.gather(tensors, self._device())
        return tensors

    def _local(self, tensors: dict) -> dict:
        """The converse of :meth:`_whole`: this stage's, this rank's shards."""
        if self.zero.pp is not None:
            tensors = self.zero.pp.select(tensors)
        for ctx in self._contexts():
            tensors = {n: shard_tensor(t, ctx.dim(n), ctx) for n, t in tensors.items()}
        return tensors

    def writes_checkpoints(self) -> bool:
        """Whether this rank writes the saves: the first of its group, on
        the first model, expert and pipe rank."""
        return self.zero.rank == 0 and all(
            c.index == 0 for c in (*self._contexts(), self.zero.pp) if c is not None)

    def state_dict(self) -> dict:
        """Everything a resume needs, as whole tensors and numbers: the
        world-1 format at every stage and layout. Every rank must call it
        (it all-gathers partitioned state)."""
        self.gather_params()
        model = self._whole(self.model.state_dict())  # the gathered tensors
        self.release_params()
        return {
            "model": model,
            "opt_state": {"count": self.opt_state.count,
                          **{k: self._whole(self._full_slot(k, v))
                             for k, v in self.opt_state.slots.items()}},
            "loss_scale": dataclasses.asdict(self.loss_scale),
            "step": self.step,
            # JAX _ckpt_layout's metadata; nothing here is stored permuted.
            "layout": self.zero.pp.layout() if self.zero.pp is not None else {},
        }

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Load a :meth:`state_dict` saved at any stage and layout, and
        partition it for this one."""
        self.gather_params()
        self.model.load_state_dict(self._local(sd["model"]), strict=True)
        if self.shards is not None:
            self.shards = {n: self.zero.param_shard(p) for n, p in self.params().items()}
        self.release_params()
        saved = {k: v for k, v in sd["opt_state"].items() if k != "count"}
        if set(saved) != set(self.opt_state.slots):
            raise ValueError(f"optimizer state slots {sorted(self.opt_state.slots)} "
                             f"differ from the checkpoint's {sorted(saved)}")
        for key, tensors in saved.items():
            mine = self.opt_state.slots[key]
            tensors = self._local(tensors)
            if set(mine) != set(tensors):
                raise ValueError(f"optimizer state {key} names differ from "
                                 f"the checkpoint's")
            for n, t in tensors.items():
                mine[n].copy_(self.partition(t).view(mine[n].shape))
        self.opt_state.set_count(sd["opt_state"]["count"])
        self.loss_scale = LossScaleState(**sd["loss_scale"])
        self.step = int(sd["step"])


def param_count(model: torch.nn.Module, *contexts) -> int:
    """The model's parameter count; with tensor- or expert-parallel contexts
    or a pipeline stage (None ones skipped), the whole model's: each leaf
    counts its size times the size of every context it is sharded over."""
    contexts = [c for c in contexts if c is not None]
    return sum(p.numel() * math.prod(c.size for c in contexts if c.dim(name) is not None)
               for name, p in model.named_parameters())
