"""Token datasets and the sharded token loader of the LM path.

The port of ``distributed_training_tpu/data/lm_text.py``; every array and
every batch order is bitwise the JAX package's:

- :func:`synthetic_tokens`: arithmetic progressions (next token =
  (prev + 1) mod vocab), cheap, learnable and deterministic;
- :func:`byte_corpus`: byte-level windows of a local text file (vocab
  256), read under JAX's deterministic transient-I/O retry
  (``resilience/retry.py``), where the chaos harness injects its faults;
- :class:`TokenLoader`: a ``(seed, epoch)``-seeded permutation of the
  sequences, each process's contiguous slice of every global batch (or,
  with ``microbatches``, of each gradient-accumulation microbatch in
  JAX's order, ``data/pipeline.py::process_rows``), partial batches
  dropped. Batches are ``{'tokens': int32 [B, T+1]}``: one
  extra position for the next-token shift
  (``train/lm_step.py::make_lm_batch``).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from distributed_training_tpu_torch.data.pipeline import check_microbatches, process_rows


def synthetic_tokens(n: int, seq_len: int, vocab_size: int = 256,
                     seed: int = 0) -> np.ndarray:
    """``[n, seq_len+1]`` int32 progressions: row i = (start_i + arange) % V."""
    rng = np.random.RandomState(seed)
    starts = rng.randint(0, vocab_size, size=(n, 1))
    return ((starts + np.arange(seq_len + 1)) % vocab_size).astype(np.int32)


def byte_corpus(path: str, n: int, seq_len: int, seed: int = 0,
                span: tuple[float, float] = (0.0, 1.0)) -> np.ndarray:
    """``[n, seq_len+1]`` int32 byte windows sampled from a fractional
    ``span`` of a file (train and eval take disjoint spans). The read runs
    under JAX's ``RetryPolicy`` (3 attempts, 0.02 s), and the chaos
    harness's ``chaos_io_check`` keys it by the path."""
    from distributed_training_tpu_torch.resilience.chaos import chaos_io_check
    from distributed_training_tpu_torch.resilience.retry import RetryPolicy

    def _read() -> bytes:
        chaos_io_check("data", path)
        with open(path, "rb") as fh:
            return fh.read()

    data = np.frombuffer(RetryPolicy(max_attempts=3, base_delay_s=0.02).call(_read),
                         dtype=np.uint8)
    lo, hi = int(data.size * span[0]), int(data.size * span[1])
    data = data[lo:hi]
    if data.size < seq_len + 2:
        raise ValueError(f"corpus {path!r} span {span} has {data.size} bytes; "
                         f"need > {seq_len + 1}")
    rng = np.random.RandomState(seed)
    starts = rng.randint(0, data.size - seq_len - 1, size=n)
    idx = starts[:, None] + np.arange(seq_len + 1)[None, :]
    return data[idx].astype(np.int32)


class TokenLoader:
    """Deterministic sharded loader over a ``[N, T+1]`` token array
    (always ``drop_last``)."""

    def __init__(self, tokens: np.ndarray, *, global_batch_size: int,
                 shuffle: bool = True, seed: int = 0, process_index: int = 0,
                 process_count: int = 1, max_steps: int | None = None,
                 microbatches: int = 1):
        self.tokens = tokens
        self.global_batch_size = global_batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.process_index = process_index
        self.process_count = process_count
        if global_batch_size % process_count:
            raise ValueError(f"global batch {global_batch_size} not divisible "
                             f"by {process_count} processes")
        self.max_steps = max_steps
        check_microbatches(global_batch_size, process_count, microbatches)
        self.microbatches = microbatches

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        steps = self.tokens.shape[0] // self.global_batch_size
        return min(steps, self.max_steps) if self.max_steps else steps

    def __iter__(self) -> Iterator[dict]:
        return self.iter_from(0)

    def iter_from(self, start_step: int) -> Iterator[dict]:
        """Iterate from ``start_step`` of the epoch's deterministic shuffle."""
        order = np.arange(self.tokens.shape[0])
        if self.shuffle:
            np.random.RandomState((self.seed, self.epoch)).shuffle(order)
        for step in range(start_step, len(self)):
            sel = order[step * self.global_batch_size:
                        (step + 1) * self.global_batch_size]
            rows = process_rows(sel, self.process_index, self.process_count,
                                self.microbatches)
            yield {"tokens": self.tokens[rows]}
