"""Deterministic retry with typed exponential backoff.

A copy of ``distributed_training_tpu/resilience/retry.py``: a transient
I/O fault (a flaky network-filesystem read) costs a bounded retry, not
the run. The port applies it to the per-image decode of
``data/imagefolder.py``.

- **Deterministic.** The backoff sequence is a function of the policy
  alone (no jitter), so a run that meets the same faults replays exactly.
- **Typed.** Only exceptions in ``retry_on`` are retried (default
  ``OSError``, the transient-I/O family); any other error surfaces on the
  first attempt.

A process-wide counter (:func:`total_retries`) counts the retry sleeps
taken, so retries are visible rather than silently absorbed.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Iterator

_lock = threading.Lock()
_total_retries = 0


def total_retries() -> int:
    """Process-wide count of retry sleeps taken."""
    return _total_retries


def _count_retry() -> None:
    global _total_retries
    with _lock:
        _total_retries += 1


def reset_retries() -> None:
    """Zero the process-wide counter (test isolation)."""
    global _total_retries
    with _lock:
        _total_retries = 0


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded-attempt exponential backoff; see the module docstring.

    ``max_attempts`` counts total tries (1 = no retry). ``sleep`` is
    injectable so tests assert the exact delay sequence without waiting.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 2.0
    retry_on: tuple = (OSError,)
    sleep: Callable[[float], None] = time.sleep

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("delays must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError(
                f"multiplier must be >= 1, got {self.multiplier}")

    def delays(self) -> Iterator[float]:
        """The deterministic backoff sequence (one delay per retry)."""
        d = self.base_delay_s
        for _ in range(self.max_attempts - 1):
            yield min(d, self.max_delay_s)
            d *= self.multiplier

    def call(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        """Run ``fn`` under the policy; re-raises the final failure."""
        delays = list(self.delays()) + [None]  # None: the last attempt
        for delay in delays:
            try:
                return fn(*args, **kwargs)
            except self.retry_on:
                if delay is None:
                    raise
                _count_retry()
                self.sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover
