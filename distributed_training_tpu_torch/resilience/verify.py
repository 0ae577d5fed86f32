"""Checkpoint validity: checksum manifests and an atomic COMMITTED marker.

The port of ``distributed_training_tpu/resilience/verify.py``, with its
API, on the port's own save layout (``checkpoint.py``: ``epoch_N/state.pt``
from ``torch.save``). Each save gets two more files in its directory:

- ``MANIFEST.json``: ``{relpath: [size, crc32]}`` over every payload file
  (a torn, truncated or altered file is caught by a streaming CRC pass,
  before ``torch.load``), and ``{tree/path: [crc32, dtype, shape]}`` over
  the state's leaves, the content the step produced;
- ``COMMITTED``: an empty marker written last, through a temporary name
  and an atomic rename. A crash at any earlier point leaves no marker.

Several processes writing one save (``process_count > 1``) each write
``MANIFEST.<p>.json`` over the files they own (those under a
``process_<p>`` or ``ocdbt.process_<p>`` directory; process 0 owns the
rest), and process 0 writes ``COMMITTED`` after every peer's manifest has
appeared. Verification merges the family and requires it whole. The
port's trainers save from rank 0 alone (the state gathered to whole
tensors), so their saves are single-process.

:func:`verify_checkpoint` is the one validity test: committed and
consistent with its manifests ⇒ valid. A directory with neither manifest
nor marker is refused: the port has always written both, so such a
directory is a save that died before its manifest (a payload alone may be
truncated). The saves of the port's earlier layout (a ``MANIFEST.json`` of
``files`` alone, then ``COMMITTED``) verify as they are.
"""

from __future__ import annotations

import json
import os
import re
import time
import warnings
import zlib
from typing import Any

import numpy as np

from distributed_training_tpu_torch.resilience.errors import CheckpointCorruptError
from distributed_training_tpu_torch.resilience.retry import RetryPolicy

MANIFEST_NAME = "MANIFEST.json"
COMMIT_NAME = "COMMITTED"
MANIFEST_VERSION = 1

# MANIFEST.json and the per-process MANIFEST.<p>.json (and .tmp names).
_MANIFEST_RE = re.compile(r"^MANIFEST(\.\d+)?\.json(\.tmp)?$")
# The per-process ownership partition: files under process_<p>/ (or
# JAX's orbax ocdbt.process_<p>/) belong to process p.
_PROCESS_DIR_RE = re.compile(r"(?:^|/|\\)(?:ocdbt\.)?process_(\d+)(?:/|\\|$)")

_MANIFEST_IO_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.05)


def is_manifest_name(name: str) -> bool:
    """True for manifest files (any process): they describe a save and are
    no part of it."""
    return bool(_MANIFEST_RE.match(os.path.basename(name)))


def manifest_name(process_index: int = 0, process_count: int = 1) -> str:
    """``MANIFEST.json`` for one process, ``MANIFEST.<p>.json`` for
    several."""
    if process_count == 1:
        return MANIFEST_NAME
    return f"MANIFEST.{int(process_index)}.json"


def _crc_file(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as fh:
        while block := fh.read(chunk):
            crc = zlib.crc32(block, crc)
    return crc


def _walk_files(root: str) -> dict[str, str]:
    """``{relpath: abspath}`` of every file under ``root`` but the
    manifests and the marker."""
    out: dict[str, str] = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            rel = os.path.relpath(p, root)
            if rel == COMMIT_NAME or is_manifest_name(rel):
                continue
            out[rel] = p
    return out


def _owned_by(rel: str, process_index: int, process_count: int) -> bool:
    """Whether process ``process_index`` hashes ``rel`` (see the module
    docstring); every file has exactly one owner."""
    if process_count == 1:
        return True
    m = _PROCESS_DIR_RE.search(rel)
    if m is not None:
        return int(m.group(1)) == process_index
    return process_index == 0


def _leaf_buffer(leaf) -> tuple[Any, str, list]:
    """A leaf's bytes (a contiguous buffer), dtype name and shape: a tensor
    by its raw bytes on the host (bf16 included), else what numpy reads."""
    import torch

    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        return (t.reshape(-1).view(torch.uint8).numpy(),
                str(t.dtype).replace("torch.", ""), list(t.shape))
    arr = np.ascontiguousarray(np.asarray(leaf))
    return arr.tobytes(), str(arr.dtype), list(arr.shape)


def leaf_checksums(tree: Any, prefix: str = "") -> dict[str, list]:
    """``{path: [crc32, dtype, shape]}`` over a nested dict of tensors,
    arrays and numbers (lists and tuples count as dicts of their
    indices; None is skipped)."""
    out: dict[str, list] = {}
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            out.update(leaf_checksums(tree[k], f"{prefix}{k}/"))
        return out
    if tree is None:
        return out
    buf, dtype, shape = _leaf_buffer(tree)
    return {prefix.rstrip("/"): [zlib.crc32(buf), dtype, shape]}


def write_manifest(path: str, leaves: dict[str, list] | None = None, *,
                   process_index: int = 0, process_count: int = 1,
                   peer_wait_s: float = 120.0) -> None:
    """The manifest and the COMMITTED marker of a completed save at
    ``path``. Call it only after every payload file is written: the
    marker means that everything before it is on disk.

    One process: ``MANIFEST.json`` over every file, then the marker.
    Several: this process hashes only the files it owns into
    ``MANIFEST.<p>.json`` (a peer's files may still be in flight);
    process 0 writes the marker after waiting up to ``peer_wait_s`` for
    every peer's manifest, and leaves the save uncommitted (torn, to every
    scan) when one never appears.
    """
    name = manifest_name(process_index, process_count)
    files = {rel: [os.path.getsize(p), _crc_file(p)]
             for rel, p in sorted(_walk_files(path).items())
             if _owned_by(rel, process_index, process_count)}

    def _write_manifest():
        manifest = {"manifest_version": MANIFEST_VERSION, "files": files,
                    "leaves": leaves or {}}
        if process_count > 1:
            manifest["process_index"] = int(process_index)
            manifest["process_count"] = int(process_count)
        tmp = os.path.join(path, name + ".tmp")
        with open(tmp, "w") as fh:
            json.dump(manifest, fh, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(path, name))

    def _write_marker():
        tmp = os.path.join(path, COMMIT_NAME + ".tmp")
        with open(tmp, "w") as fh:
            fh.write("")  # its presence is the contract
        os.replace(tmp, os.path.join(path, COMMIT_NAME))

    _MANIFEST_IO_RETRY.call(_write_manifest)
    if process_index != 0:
        return
    if process_count > 1:
        deadline = time.monotonic() + peer_wait_s
        missing = [q for q in range(1, process_count)
                   if not os.path.isfile(
                       os.path.join(path, manifest_name(q, process_count)))]
        while missing and time.monotonic() < deadline:
            time.sleep(0.05)
            missing = [q for q in missing if not os.path.isfile(
                os.path.join(path, manifest_name(q, process_count)))]
        if missing:
            warnings.warn(
                f"checkpoint at {path}: peer manifest(s) {missing} never "
                f"appeared within {peer_wait_s}s; leaving the save "
                f"UNCOMMITTED (scanners will treat it as torn)",
                stacklevel=2)
            return
    _MANIFEST_IO_RETRY.call(_write_marker)


def _parse_manifest(path: str, mpath: str) -> dict[str, Any]:
    try:
        with open(mpath) as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            f"checkpoint manifest {mpath} is unreadable ({e}); the save "
            f"is untrustworthy — quarantine the directory and resume "
            f"from an earlier epoch", path=path, reason="torn") from e


def read_manifest(path: str) -> dict[str, Any] | None:
    """The single-process ``MANIFEST.json``, or None when there is none."""
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.isfile(mpath):
        return None
    return _parse_manifest(path, mpath)


def read_manifests(path: str) -> list[dict[str, Any]]:
    """Every manifest at ``path`` (``MANIFEST.json`` and the
    ``MANIFEST.<p>.json`` family), parsed, in file-name order; empty
    without one. An unreadable manifest raises the typed error."""
    if not os.path.isdir(path):
        return []
    out: list[dict[str, Any]] = []
    for name in sorted(os.listdir(path)):
        if not is_manifest_name(name) or name.endswith(".tmp"):
            continue
        out.append(_parse_manifest(path, os.path.join(path, name)))
    return out


def is_committed(path: str) -> bool:
    return os.path.isfile(os.path.join(path, COMMIT_NAME))


def verify_checkpoint(path: str) -> None:
    """Raise :class:`CheckpointCorruptError` unless ``path`` is a save to
    restore (see the module docstring); its ``reason`` is ``empty``,
    ``uncommitted``, ``torn`` or ``checksum``."""
    if not os.path.isdir(path):
        raise CheckpointCorruptError(
            f"no checkpoint directory at {path}", path=path, reason="empty")
    files = _walk_files(path)
    manifests = read_manifests(path)
    committed = is_committed(path)
    if not manifests and not committed:
        raise CheckpointCorruptError(
            f"checkpoint directory {path} is empty or structurally not a "
            f"checkpoint (no manifest, no {COMMIT_NAME} marker) — likely a "
            f"save that died before writing its manifest. Remedy: delete "
            f"the directory, or use auto_resume which skips it and falls "
            f"back to the newest verified save",
            path=path, reason="empty")
    if not committed:
        raise CheckpointCorruptError(
            f"checkpoint at {path} is UNCOMMITTED (the save died "
            f"before its atomic {COMMIT_NAME} marker — a torn write). "
            f"Remedy: resume from an earlier epoch; auto_resume does this "
            f"fallback automatically and quarantines the directory",
            path=path, reason="uncommitted")
    if not manifests:
        raise CheckpointCorruptError(
            f"checkpoint at {path} carries a {COMMIT_NAME} marker but no "
            f"{MANIFEST_NAME} — the save artifacts were tampered with or "
            f"partially deleted. Remedy: resume from an earlier epoch",
            path=path, reason="torn")
    # Merge the family: ownership makes the entries disjoint, so two
    # manifests that disagree about one file, or a missing member of a
    # several-process family, mean the save cannot be trusted.
    want: dict[str, list] = {}
    counts: set[int] = set()
    present: set[int] = set()
    for m in manifests:
        if "process_count" in m:
            counts.add(int(m["process_count"]))
            present.add(int(m.get("process_index", 0)))
        for rel, entry in m.get("files", {}).items():
            if rel in want and list(want[rel]) != list(entry):
                raise CheckpointCorruptError(
                    f"checkpoint at {path}: manifests disagree about "
                    f"{rel!r} ({want[rel]} vs {entry}) — the save was "
                    f"assembled from mismatched processes. Remedy: "
                    f"resume from an earlier epoch",
                    path=path, reason="torn")
            want[rel] = entry
    if counts:
        if len(counts) > 1:
            raise CheckpointCorruptError(
                f"checkpoint at {path}: per-process manifests disagree "
                f"about the saving world size ({sorted(counts)}) — the "
                f"save was assembled from mismatched processes. Remedy: "
                f"resume from an earlier epoch",
                path=path, reason="torn")
        missing = sorted(set(range(counts.pop())) - present)
        if missing:
            raise CheckpointCorruptError(
                f"checkpoint at {path} is missing per-process "
                f"manifest(s) for process(es) {missing} — those "
                f"processes' payload files cannot be verified (a "
                f"partial delete or tampering). Remedy: resume from an "
                f"earlier epoch", path=path, reason="torn")
    for rel, (size, crc) in sorted(want.items()):
        p = files.get(rel)
        if p is None:
            raise CheckpointCorruptError(
                f"checkpoint at {path} is missing file {rel!r} listed in "
                f"its manifest — a partial delete or torn write. Remedy: "
                f"resume from an earlier epoch (auto_resume falls back "
                f"automatically)", path=path, reason="torn")
        if os.path.getsize(p) != size or _crc_file(p) != crc:
            raise CheckpointCorruptError(
                f"checkpoint at {path} fails checksum verification against "
                f"its manifest on {rel!r} (truncated or corrupted after "
                f"commit). Remedy: "
                f"resume from an earlier epoch (auto_resume falls back "
                f"automatically)", path=path, reason="checksum")


def checkpoint_is_valid(path: str) -> bool:
    """:func:`verify_checkpoint` as a boolean; an unreadable directory is
    not valid."""
    try:
        verify_checkpoint(path)
        return True
    except (CheckpointCorruptError, OSError):
        return False


def quarantine_checkpoint(path: str) -> str:
    """Rename a bad save to ``<path>.corrupt`` (``.corrupt1``, ... when
    taken), out of every scan's way with its bytes kept; returns the new
    path."""
    dst = path + ".corrupt"
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = f"{path}.corrupt{n}"
    os.replace(path, dst)
    return dst
