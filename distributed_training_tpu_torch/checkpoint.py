"""Checkpoint / resume in the port's own format, with the JAX package's
commit protocol (``resilience/verify.py``).

A save of epoch N is the directory ``epoch_N`` holding:

1. ``state.pt``: ``torch.save`` of the train state (model, optimizer,
   loss scaler, step) and the resume metadata, written first (through a
   temporary name and a rename, so a crash mid-write leaves no
   ``state.pt``);
2. ``MANIFEST.json``: size and CRC32 of every payload file, and the CRC32,
   dtype and shape of every leaf of the state (``verify.write_manifest``);
3. ``COMMITTED``: an empty marker, written last through a temporary name
   and an atomic rename.

A directory without the marker, or whose files no longer match the
manifest, is not a checkpoint (``verify.verify_checkpoint`` raises
:class:`CheckpointCorruptError` with its reason): :func:`latest_valid_epoch`
skips it (and quarantines it to ``epoch_N.corrupt``), and
:func:`restore_checkpoint` refuses it. The saves of the port's earlier
layout (a manifest of files alone) verify and restore as they are. Orbax
compatibility with the JAX package is not a goal.

A data-parallel save is written by rank 0 alone, in the same format: the
state partitioned by ZeRO is gathered to whole tensors first (and the
tensor- and expert-parallel shards over their groups), so a save made at
any stage, world and layout resumes at any other. A save is made
synchronously (:func:`save_checkpoint`) or, with the trainers'
``checkpoint.async_save``, by a background writer from a host copy of the
state (``resilience/async_ckpt.py``), which calls
:func:`write_checkpoint`. A preemption save records where in its epoch
training stopped (``next_epoch``, ``epoch_step``), so the resume trains no
batch twice.
"""

from __future__ import annotations

import os
import shutil
import warnings

import torch

from distributed_training_tpu_torch.resilience import verify as verify_lib
from distributed_training_tpu_torch.resilience.errors import (  # noqa: F401
    CheckpointCorruptError,
)
from distributed_training_tpu_torch.resilience.verify import (  # noqa: F401
    COMMIT_NAME,
    MANIFEST_NAME,
    checkpoint_is_valid,
    verify_checkpoint,
)

PAYLOAD = "state.pt"


def _epoch_dir(directory: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(directory), f"epoch_{epoch}")


def write_checkpoint(directory: str, epoch: int, sd: dict, *,
                     next_epoch: int | None = None, epoch_step: int = 0) -> str:
    """Write a state dict (:meth:`TrainState.state_dict`, or the host
    copy ``resilience/async_ckpt.py`` takes of one) as the save of
    ``epoch``, through the commit protocol; returns the path. The metadata
    says where a resume starts: ``next_epoch`` (default ``epoch + 1``),
    after ``epoch_step`` of its batches (a preemption save mid-epoch)."""
    path = _epoch_dir(directory, epoch)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path)
    meta = {"epoch": epoch,
            "next_epoch": epoch + 1 if next_epoch is None else int(next_epoch),
            "epoch_step": int(epoch_step)}
    payload = os.path.join(path, PAYLOAD)
    with open(payload + ".tmp", "wb") as fh:
        torch.save({"state": sd, "meta": meta}, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(payload + ".tmp", payload)
    verify_lib.write_manifest(path, verify_lib.leaf_checksums({"state": sd}))
    return path


def save_checkpoint(directory: str, epoch: int, state, *,
                    next_epoch: int | None = None, epoch_step: int = 0) -> str:
    """Save ``state`` (a ``TrainState``) as the save of ``epoch``,
    synchronously; returns the path. ``next_epoch`` and ``epoch_step`` as
    in :func:`write_checkpoint` (an end-of-epoch save by default).

    Data-parallel: every rank calls it. The partitioned state is gathered
    to whole tensors on every rank (``TrainState.state_dict``), rank 0
    (``TrainState.writes_checkpoints``) writes the world-1 format, and the
    others wait at a barrier until the save is committed."""
    sd = state.state_dict()
    if not state.writes_checkpoints():
        state.zero.barrier()
        return _epoch_dir(directory, epoch)
    path = write_checkpoint(directory, epoch, sd, next_epoch=next_epoch,
                            epoch_step=epoch_step)
    state.zero.barrier()
    return path


def restore_checkpoint(directory: str, epoch: int, state) -> tuple[int, int]:
    """Load the save of ``epoch`` into ``state`` in place, partitioned for
    its stage and world whatever they were at the save; returns
    ``(start_epoch, start_step)``. Every rank calls it."""
    path = _epoch_dir(directory, epoch)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    verify_lib.verify_checkpoint(path)
    blob = torch.load(os.path.join(path, PAYLOAD), map_location="cpu",
                      weights_only=True)
    state.load_state_dict(blob["state"])
    meta = blob["meta"]
    return int(meta["next_epoch"]), int(meta["epoch_step"])


def _epoch_list(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(d.split("_", 1)[1])
        for d in os.listdir(directory)
        if d.startswith("epoch_") and d.split("_", 1)[1].isdigit())


def latest_valid_epoch(directory: str, *, quarantine: bool = True) -> int | None:
    """Newest epoch whose save verifies, or None. Bad saves met on the way
    are skipped and, with ``quarantine``, renamed to ``epoch_N.corrupt``
    (``verify.quarantine_checkpoint``); an unreadable one is skipped and
    left where it is."""
    directory = os.path.abspath(directory)
    for e in reversed(_epoch_list(directory)):
        path = _epoch_dir(directory, e)
        try:
            verify_lib.verify_checkpoint(path)
            return e
        except CheckpointCorruptError as err:
            if quarantine:
                dst = verify_lib.quarantine_checkpoint(path)
                warnings.warn(f"skipping corrupt checkpoint (quarantined to "
                              f"{dst}): {err}", stacklevel=2)
            else:
                warnings.warn(f"skipping corrupt checkpoint: {err}", stacklevel=2)
        except OSError as err:
            # A directory that vanished mid-scan or a transient read fault.
            warnings.warn(f"skipping unreadable checkpoint {path}: {err}",
                          stacklevel=2)
    return None


def resolve_resume(ckpt_cfg, *, quarantine: bool = True) -> int:
    """Resume epoch for a ``CheckpointConfig``: an explicit ``resume >= 0``
    wins; else ``auto_resume`` takes the newest verified save; -1 = fresh.
    ``quarantine`` as in :func:`latest_valid_epoch` (rank 0 only, when
    several processes look at one directory)."""
    if ckpt_cfg.resume >= 0:
        return ckpt_cfg.resume
    if ckpt_cfg.auto_resume:
        latest = latest_valid_epoch(ckpt_cfg.directory, quarantine=quarantine)
        if latest is not None:
            return latest
    return -1


def prune_checkpoints(directory: str, keep: int) -> None:
    """Keep the ``keep`` newest saves, and never delete the newest verified
    one: if every kept save is bad, the newest good older one survives."""
    directory = os.path.abspath(directory)
    epochs = _epoch_list(directory)
    if not epochs or keep <= 0:
        return
    victims = epochs[:-keep]
    if not victims:
        return
    protected = None
    if not any(checkpoint_is_valid(_epoch_dir(directory, e))
               for e in reversed(epochs[-keep:])):
        protected = next((e for e in reversed(victims)
                          if checkpoint_is_valid(_epoch_dir(directory, e))), None)
    for e in victims:
        if e != protected:
            shutil.rmtree(_epoch_dir(directory, e), ignore_errors=True)
