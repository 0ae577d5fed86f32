"""Cross-rank flight aggregation: step-time skew + straggler attribution.

The port of ``distributed_training_tpu/observability/aggregate.py``. A
multi-rank step is a barrier: every rank's step time is the slowest
rank's, so a single straggling rank taxes the whole job while its own
percentiles look like everyone else's. This module names *which* rank:

- each rank serializes a fixed-shape payload of its recent per-step wall
  deltas (step-number-aligned) plus its WallClock phase totals;
- the payloads are all-gathered at meter-flush boundaries over a **gloo**
  process group on host tensors (:func:`host_group`: the default group
  when it is gloo, else a gloo group of every rank opened beside NCCL),
  where JAX exchanges them through its coordination service's key-value
  store: never an NCCL collective, so the exchange occupies no card,
  queues no kernel between the trainer's steps and reads nothing from
  the device. Every rank flushes at the same deterministic step and
  receives the SAME gathered matrix, so the exchange cannot strand a
  barrier;
- the summary attributes: per-rank excess over the cross-rank per-step
  median, a straggler score (mean positive excess in units of the median
  step time), and the single worst (rank, step) cell. The dump keeps
  JAX's keys (``num_hosts``, ``host``, ``process_index``): a "host" is a
  rank here.

With one process the cross-rank baseline degenerates to the rank's own
median step time, so the same summary pins *which step* stalled.
"""

from __future__ import annotations

import itertools
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

# Canonical phase order — fixed so the gathered payload has one schema
# on every host (a host that never entered 'eval' contributes 0.0).
PHASES = ("step", "data", "log", "ckpt", "eval")

DEFAULT_WINDOW = 256


def local_payload(recorder, clock=None,
                  window: int = DEFAULT_WINDOW) -> np.ndarray:
    """This host's fixed-shape contribution: the last ``window``
    (step, delta_ms) pairs (−1-padded) + the :data:`PHASES` totals.

    Fixed shape is what makes the payload all-gatherable; step numbers
    ride along so hosts align on step IDENTITY, not array position (a
    host that dropped a ring entry must not shift everyone's columns).
    """
    return payload_array(payload_parts(recorder, clock, window), window)


def payload_parts(recorder, clock=None,
                  window: int = DEFAULT_WINDOW) -> tuple[list, dict]:
    """What :func:`local_payload` packs, as host lists: the last ``window``
    (step, delta_ms) pairs and the clock's phase totals (cheap to take at
    every flush; a one-process run packs them only when summarised)."""
    deltas = recorder.step_deltas_ms(last=window)
    return deltas, (clock.snapshot() if clock is not None else {})


def payload_array(parts: tuple[list, dict], window: int = DEFAULT_WINDOW) -> np.ndarray:
    """:func:`payload_parts` as the fixed-shape payload."""
    deltas, phases = parts
    arr = np.full((window, 2), -1.0, dtype=np.float64)
    if deltas:
        arr[:len(deltas)] = np.fromiter(itertools.chain.from_iterable(deltas),
                                        dtype=np.float64,
                                        count=2 * len(deltas)).reshape(-1, 2)
    ph = np.asarray([float(phases.get(p, 0.0)) for p in PHASES],
                    dtype=np.float64)
    return np.concatenate([arr.reshape(-1), ph])


# (default group, the gloo group beside it): opened once per process.
_HOST_GROUP: tuple = (None, None)


def host_group():
    """The gloo group the payloads travel over: the default group when its
    backend is gloo, else a gloo group of every rank beside it, opened at
    the first call under this default group (collective: every rank makes
    that call at the same point) and reused by every later run of the
    process. None without a process group."""
    global _HOST_GROUP
    if not dist.is_initialized():
        return None
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    world = dist.group.WORLD
    if _HOST_GROUP[0] is not world:  # a new default group: a new gloo one
        _HOST_GROUP = (world, dist.new_group(backend="gloo"))
    return _HOST_GROUP[1]


def close_host_group() -> None:
    """Destroy the gloo group :func:`host_group` opened beside the default
    group, if any, and drop this module's reference to it: its worker
    threads are joined now, while the interpreter runs. Left open to the
    interpreter's exit, a worker still releasing its last exchange's
    tensors would take the GIL during finalization, which ends the thread
    inside C++ and aborts the process (``std::terminate``). Collective:
    every rank calls it (``runtime.distributed.shutdown_distributed``)."""
    global _HOST_GROUP
    world, group = _HOST_GROUP
    _HOST_GROUP = (None, None)
    if group is not None and dist.is_initialized() and world is dist.group.WORLD:
        dist.destroy_process_group(group)


def gather_payloads(payload: np.ndarray, num_processes: int, *,
                    group=None) -> np.ndarray:
    """All-gather ``payload`` across ranks → ``[num_ranks, len(payload)]``.

    Single-process is pure numpy. Multi-rank exchanges float64 host
    tensors over ``group`` (a gloo group, :func:`host_group`): the same
    matrix on every rank. Must be called from EVERY rank at the same point
    — the meter-flush boundary is exactly such a point."""
    if num_processes <= 1:
        return payload[None, :]
    if group is None:
        raise RuntimeError(
            "cross-rank flight aggregation needs a process group "
            "(runtime.distributed.initialize_distributed) and its gloo "
            "group (aggregate.host_group) to exchange payloads over")
    row = torch.from_numpy(np.ascontiguousarray(payload, dtype=np.float64))
    rows = [torch.empty_like(row) for _ in range(num_processes)]
    dist.all_gather(rows, row, group=group)
    return torch.stack(rows).numpy()


def summarize_hosts(gathered: np.ndarray,
                    window: int = DEFAULT_WINDOW) -> dict[str, Any]:
    """The gathered matrix → skew/straggler summary (JSON-ready).

    Baseline per step: the cross-host median (H > 1), or the host's own
    median step time (H == 1, where cross-host skew does not exist).
    ``straggler`` names the worst (host, step) cell by excess over that
    baseline; ``score`` is that excess in units of the median step time
    (how many extra steps' worth of wall-time the stall cost).
    """
    g = np.asarray(gathered, dtype=np.float64)
    n_hosts = g.shape[0]
    pairs = g[:, :2 * window].reshape(n_hosts, window, 2)
    phase_totals = g[:, 2 * window:]

    per_host_steps = []
    for h in range(n_hosts):
        valid = pairs[h][pairs[h][:, 0] >= 0]
        per_host_steps.append({int(s): float(dt) for s, dt in valid})
    common = sorted(set.intersection(*[set(d) for d in per_host_steps])
                    if per_host_steps else set())
    out: dict[str, Any] = {
        "num_hosts": int(n_hosts),
        "common_steps": len(common),
        "per_host": [
            {"process_index": h,
             "phase_seconds": {p: float(phase_totals[h, i])
                               for i, p in enumerate(PHASES)}}
            for h in range(n_hosts)
        ],
    }
    if not common:
        return out
    # D[h, s]: host h's wall delta for common step s.
    d = np.asarray([[per_host_steps[h][s] for s in common]
                    for h in range(n_hosts)])
    if n_hosts > 1:
        baseline = np.median(d, axis=0)[None, :]
        out["baseline"] = "cross-host median"
    else:
        baseline = np.full((1, len(common)), np.median(d))
        out["baseline"] = "within-host median"
    excess = d - baseline
    median_ms = float(np.median(d))
    out["window"] = [int(common[0]), int(common[-1])]
    out["median_step_ms"] = median_ms
    for h in range(n_hosts):
        pos = excess[h][excess[h] > 0]
        worst = int(np.argmax(excess[h]))
        out["per_host"][h].update({
            "step_time_mean_ms": float(d[h].mean()),
            "step_time_max_ms": float(d[h].max()),
            "mean_excess_ms": float(excess[h].mean()),
            "max_excess_ms": float(excess[h].max()),
            "max_excess_step": int(common[worst]),
            "straggler_score": (float(pos.mean() / median_ms)
                                if pos.size and median_ms > 0 else 0.0),
        })
    flat = int(np.argmax(excess))  # row-major: lowest host, then step
    h_star, s_star = divmod(flat, len(common))
    out["straggler"] = {
        "host": int(h_star),
        "step": int(common[s_star]),
        "excess_ms": float(excess[h_star, s_star]),
        "score": (float(excess[h_star, s_star] / median_ms)
                  if median_ms > 0 else 0.0),
    }
    return out
