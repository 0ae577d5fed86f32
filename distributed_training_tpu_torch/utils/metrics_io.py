"""Metric sinks: TensorBoard scalars and/or JSONL event lines.

The port of ``distributed_training_tpu/utils/metrics_io.py``: the same
``MetricsWriter`` and the same JSONL lines (``{"step": N, "prefix": ...,
<metric>: <float>, ...}``, one object a line, appended). Writes happen at
the meter's ``log_interval`` flushes, when the values are already on the
host, so the sinks add no device synchronisation.

TensorBoard goes through ``torch.utils.tensorboard``, imported only when
``tensorboard_dir`` is set. Without the ``tensorboard`` package that
request raises ``ImportError`` naming the option: nothing is written
elsewhere instead.
"""

from __future__ import annotations

import json
import os
from typing import Any


class MetricsWriter:
    """Fan-out writer for flushed metric dicts (rank 0 only: pass
    ``enabled=False`` on the others).

    - ``tensorboard_dir``: scalar summaries, ``<prefix>/<metric>``;
    - ``jsonl_path``: one ``{"step": N, "prefix": ..., ...}`` object per
      line, appended, line-buffered.

    Both optional; with neither this is a no-op sink.
    """

    def __init__(self, tensorboard_dir: str | None = None,
                 jsonl_path: str | None = None, enabled: bool = True):
        self._tb = None
        self._jsonl = None
        if not enabled:
            return
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as err:
                raise ImportError(
                    f"tensorboard_dir (--tensorboard-dir) {tensorboard_dir!r} "
                    f"needs the tensorboard package, which is not installed: "
                    f"{err}") from err
            self._tb = SummaryWriter(log_dir=tensorboard_dir)
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)), exist_ok=True)
            self._jsonl = open(jsonl_path, "a", buffering=1)

    def write(self, step: int, metrics: dict[str, Any],
              prefix: str = "train") -> None:
        scalars = {k: float(v) for k, v in metrics.items() if k != "step"}
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{prefix}/{k}", v, global_step=step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"step": int(step), "prefix": prefix, **scalars}) + "\n")

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
