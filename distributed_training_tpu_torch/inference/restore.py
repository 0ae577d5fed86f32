"""Checkpoint → inference weights, shared by the generate CLI (and the
serving CLI to come).

The port of ``distributed_training_tpu/inference/restore.py``, on the
port's own checkpoints (those ``gpt/torch_cuda/train.py`` and
``LMTrainer`` write): build the model with the training run's flags, a
template train state with the same optimizer slots (Adam's moments, and
the EMA with ``--ema-decay``, so the checkpoint's slots must match),
restore the requested or newest verified epoch through
``checkpoint.restore_checkpoint`` (its manifest checked first), and pick
the raw or the EMA weights.

The PyTorch model holds its weights, so where JAX returns ``(model,
params, epoch)`` :func:`build_lm_and_restore` returns ``(model, epoch)``
with the chosen weights loaded, and :func:`restore_params` returns the
weights by parameter name (what a hot swap would load).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch


def moe_kwargs_from_flags(*, enabled: bool, num_experts, top_k: int,
                          min_capacity: int, mlp_type: str) -> dict:
    """The ``--moe`` flag family as model keywords (per-layer
    ``num_experts`` lists build the per-layer layout training used)."""
    if not enabled:
        return {}
    return dict(
        moe_num_experts=tuple(int(n) for n in num_experts),
        moe_top_k=int(top_k),
        moe_min_capacity=int(min_capacity),
        moe_mlp_type=mlp_type,
    )


def restore_params(template_state: Any, checkpoint: str, epoch: int, *,
                   use_ema: bool = False) -> dict[str, torch.Tensor]:
    """Restore ``epoch`` into the template train state and return the
    model's weights by name: the EMA average with ``use_ema``, else the
    raw parameters. A torn or corrupt save raises the typed
    ``CheckpointCorruptError`` before it is read."""
    from distributed_training_tpu_torch import checkpoint as ckpt_lib

    ckpt_lib.restore_checkpoint(checkpoint, epoch, template_state)
    if use_ema:
        with template_state.ema_weights():
            return {n: p.detach().clone() for n, p in template_state.params().items()}
    return {n: p.detach().clone() for n, p in template_state.params().items()}


def build_lm_and_restorer(
    *,
    vocab_size: int = 256,
    num_layers: int = 4,
    num_heads: int = 4,
    hidden_dim: int = 256,
    max_len: int = 2048,
    dtype: str = "fp32",
    head_bias: bool = False,
    logits_dtype: str = "bf16",
    moe_kwargs: Mapping[str, Any] | None = None,
    checkpoint: str = "./checkpoint",
    resume: int = -1,
    ema_decay: float | None = None,
    use_ema: bool = False,
    seed: int = 0,
    device: str | torch.device | None = None,
    printer: Callable[[str], None] = print,
) -> tuple[Any, int, Callable[..., dict]]:
    """``(model, epoch, restore_fn)``: the model on ``device`` (the card
    unless ``"cpu"`` is asked for; ``runtime.distributed.local_device``)
    holding the restored weights; ``epoch`` -1 when there was no
    checkpoint (the seeded random init); ``restore_fn(epoch,
    directory=checkpoint)`` the weights of another epoch (fresh tensors,
    restored into a template of its own, so the returned model is never
    written).

    Raises ``SystemExit`` for ``use_ema`` without ``ema_decay``, and with
    JAX's message when the checkpoint does not fit the flags.
    """
    from distributed_training_tpu_torch import checkpoint as ckpt_lib
    from distributed_training_tpu_torch.config import (
        OptimizerConfig,
        PrecisionConfig,
        SchedulerConfig,
    )
    from distributed_training_tpu_torch.models import get_model
    from distributed_training_tpu_torch.runtime.distributed import local_device
    from distributed_training_tpu_torch.train.lm_step import parse_logits_dtype
    from distributed_training_tpu_torch.train.optim import make_optimizer
    from distributed_training_tpu_torch.train.precision import LossScaleState, Policy
    from distributed_training_tpu_torch.train.train_state import TrainState

    if use_ema and ema_decay is None:
        raise SystemExit("--use-ema requires --ema-decay (mirror training)")

    precision = PrecisionConfig(dtype=dtype)

    def build_model():
        return get_model(
            "transformer_lm",
            num_classes=vocab_size,
            dtype=Policy.from_config(precision).compute_dtype,
            num_layers=num_layers,
            num_heads=num_heads,
            hidden_dim=hidden_dim,
            max_len=max_len,
            head_bias=head_bias,
            logits_dtype=parse_logits_dtype(logits_dtype),
            generator=torch.Generator().manual_seed(seed),
            **dict(moe_kwargs or {}),
        ).to(local_device(device))

    def make_template(m):
        tx = make_optimizer(OptimizerConfig(ema_decay=ema_decay), SchedulerConfig(),
                            world_size=1)
        return TrainState.create(m, tx, LossScaleState.create(precision))

    model = build_model()
    template = make_template(model)
    # Later restores (the serving hot swap's staging reads, on its watcher
    # thread) restore into a template of their own, built at the first
    # one: the first template holds the returned model's own parameters,
    # which may be serving.
    later: list = []

    def restore_fn(e: int, directory: str = checkpoint) -> dict:
        if not later:
            later.append(make_template(build_model()))
        return restore_params(later[0], directory, e, use_ema=use_ema)

    epoch = resume
    if epoch < 0:
        # The newest verified save: a torn newest one falls back to an
        # older good one, as the trainers' auto_resume does.
        latest = ckpt_lib.latest_valid_epoch(checkpoint, quarantine=False)
        epoch = -1 if latest is None else latest
    if epoch >= 0:
        try:
            params = restore_params(template, checkpoint, epoch, use_ema=use_ema)
        except ckpt_lib.CheckpointCorruptError:
            raise  # the typed verdict names the directory and the remedy
        except Exception as e:
            raise SystemExit(
                f"checkpoint restore failed — model flags must mirror the "
                f"training run. Most likely: this build defaults to NO "
                f"lm_head bias; pass --head-bias for checkpoints "
                f"trained with a head bias (or check --num-layers/--hidden-dim/"
                f"--moe flags). Original error: {e}") from e
        printer(f"restored epoch {epoch} from {checkpoint}")
    else:
        printer("no checkpoint found; using the seeded random init")
        if use_ema:  # the EMA starts at the parameters
            with template.ema_weights():
                params = {n: p.detach().clone() for n, p in template.params().items()}
        else:
            params = None
    if params is not None:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(params[n])
    if use_ema:
        printer("sampling from EMA parameter average")
    return model, epoch, restore_fn


def build_lm_and_restore(**kwargs: Any) -> tuple[Any, int]:
    """:func:`build_lm_and_restorer` without the re-restorer: ``(model,
    epoch)``."""
    model, epoch, _ = build_lm_and_restorer(**kwargs)
    return model, epoch
