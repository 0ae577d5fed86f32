"""Checkpoint / resume in the port's own format, with the JAX package's
commit protocol.

A save of epoch N is the directory ``epoch_N`` holding:

1. ``state.pt``: ``torch.save`` of the train state (model, optimizer,
   loss scaler, step) and the resume metadata, written first;
2. ``MANIFEST.json``: size and CRC32 of every payload file;
3. ``COMMITTED``: an empty marker, written last through a temporary name
   and an atomic rename.

A directory without the marker, or whose files no longer match the
manifest, is not a checkpoint: :func:`latest_valid_epoch` skips it (and
quarantines it to ``epoch_N.corrupt``), and :func:`restore_checkpoint`
refuses it. Orbax compatibility with the JAX package is not a goal.

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

import json
import os
import shutil
import warnings
import zlib

import torch

PAYLOAD = "state.pt"
MANIFEST_NAME = "MANIFEST.json"
COMMIT_NAME = "COMMITTED"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory that is torn, uncommitted or altered."""


def _epoch_dir(directory: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(directory), f"epoch_{epoch}")


def _crc_file(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as fh:
        while block := fh.read(chunk):
            crc = zlib.crc32(block, crc)
    return crc


def _write_atomic(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


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
    torch.save({"state": sd, "meta": meta}, payload)
    files = {PAYLOAD: [os.path.getsize(payload), _crc_file(payload)]}
    _write_atomic(os.path.join(path, MANIFEST_NAME),
                  json.dumps({"files": files}).encode())
    _write_atomic(os.path.join(path, COMMIT_NAME), b"")
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


def verify_checkpoint(path: str) -> None:
    """Raise :class:`CheckpointCorruptError` unless ``path`` is a
    committed save whose files match its manifest."""
    if not os.path.exists(os.path.join(path, COMMIT_NAME)):
        raise CheckpointCorruptError(
            f"checkpoint {path} is UNCOMMITTED (torn or in-progress save)")
    try:
        with open(os.path.join(path, MANIFEST_NAME)) as fh:
            files = json.load(fh)["files"]
    except (OSError, ValueError, KeyError) as err:
        raise CheckpointCorruptError(
            f"checkpoint {path} has no readable manifest: {err}") from err
    for rel, (size, crc) in files.items():
        f = os.path.join(path, rel)
        if not os.path.exists(f) or os.path.getsize(f) != size or _crc_file(f) != crc:
            raise CheckpointCorruptError(
                f"checkpoint {path}: {rel} does not match its manifest")


def checkpoint_is_valid(path: str) -> bool:
    try:
        verify_checkpoint(path)
        return True
    except CheckpointCorruptError:
        return False


def restore_checkpoint(directory: str, epoch: int, state) -> tuple[int, int]:
    """Load the save of ``epoch`` into ``state`` in place, partitioned for
    its stage and world whatever they were at the save; returns
    ``(start_epoch, start_step)``. Every rank calls it."""
    path = _epoch_dir(directory, epoch)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    verify_checkpoint(path)
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
    are skipped and, with ``quarantine``, renamed to ``epoch_N.corrupt``."""
    directory = os.path.abspath(directory)
    for e in reversed(_epoch_list(directory)):
        path = _epoch_dir(directory, e)
        try:
            verify_checkpoint(path)
            return e
        except CheckpointCorruptError as err:
            if quarantine:
                dst = f"{path}.corrupt"
                shutil.rmtree(dst, ignore_errors=True)
                os.replace(path, dst)
                warnings.warn(f"skipping corrupt checkpoint (quarantined to "
                              f"{dst}): {err}", stacklevel=2)
            else:
                warnings.warn(f"skipping corrupt checkpoint: {err}", stacklevel=2)
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
