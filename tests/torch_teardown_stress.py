"""Count two-rank gloo worlds that abort at exit, under load.

    python tests/torch_teardown_stress.py --runs 30 --concurrency 8

Each run spawns two ranks of ``tests/torch_dist_worker.py``'s
``_teardown_cycles`` part for one cycle: a default gloo group, the
straggler exchange's gloo group opened beside it (``aggregate.host_group``,
the default group's backend read as NCCL's, as on the card), one payload
exchanged over it, then ``runtime.distributed.shutdown_distributed`` as
the rank's last act before it exits: the end of the worker's
``_flight_world`` part. ``--concurrency`` loops of ``--runs`` runs each go
side by side, so the ranks' threads compete for the cores as under
``pytest -n 6``. A rank that dies with ``terminate called without an
active exception`` exits -6; the last line counts the runs with a rank
whose exit code is not 0. Nothing here is a test: the abort needs load and
is rare, so this counts it.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import multiprocessing
import os
import sys
import tempfile

import torch

# The ranks import the port from the repo's root (spawn hands them this path).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch_dist_worker as worker  # noqa: E402


def _loop(runs: int, scratch: str) -> list:
    """``runs`` two-rank worlds one after another: each failed run's error
    (the ranks' exit codes first), None for a run whose ranks exit 0."""
    torch.set_num_threads(1)
    failures = []
    for i in range(runs):
        out = os.path.join(scratch, f"run_{os.getpid()}_{i}")
        os.makedirs(out)
        torch.save({"dir": out, "teardown_cycles": 1}, os.path.join(out, "job.pt"))
        try:
            worker.spawn(out, 2, ("_teardown_cycles",), timeout_s=120.0)()
            failures.append(None)
        except RuntimeError as e:
            failures.append(str(e).splitlines()[0])
    return failures


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=30, help="runs in each loop")
    ap.add_argument("--concurrency", type=int, default=8, help="loops side by side")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="teardown_stress_") as scratch:
        with concurrent.futures.ProcessPoolExecutor(
                args.concurrency, mp_context=multiprocessing.get_context("spawn")) as pool:
            loops = list(pool.map(_loop, [args.runs] * args.concurrency,
                                  [scratch] * args.concurrency))
    runs = [r for loop in loops for r in loop]
    bad = [r for r in runs if r is not None]
    for r in bad:
        print(r)
    print(f"{len(bad)} of {len(runs)} two-rank runs had a rank exit non-zero")
    return 0


if __name__ == "__main__":
    sys.exit(main())
