"""Device choice and the float32 math policy, in one place.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do). Without a GPU and without that
request they raise rather than fall back quietly.

TF32 is turned off for both matmuls and cuDNN convolutions. PyTorch
leaves ``torch.backends.cudnn.allow_tf32`` on by default, which would make
an "fp32" run's convolutions keep about three decimal digits; the fp16
policy computes its convolutions in fp16 and does not read these flags.

:func:`card_line` and :func:`cuda_ms` are what the port's measuring
scripts print beside a time and take it with.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the first CUDA device, and raises without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU explicitly")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def set_fp32_math() -> None:
    """Full-precision float32 matmuls and convolutions (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, iters: int, ahead: bool = True) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, after three
    warm-up calls).

    With ``ahead``, the card first spins for ~0.2 s so that the host
    queues the launches before the first one runs: the events then time
    the device's work, not the host's enqueueing. Without it, the launches
    run as the host issues them (what a caller waiting on each call sees).
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if ahead:
        torch.cuda._sleep(400_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
