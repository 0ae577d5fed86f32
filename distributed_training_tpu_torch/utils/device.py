"""Device choice and the float32 math policy, in one place.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do). Without a GPU and without that
request they raise rather than fall back quietly.

TF32 is turned off for both matmuls and cuDNN convolutions. PyTorch
leaves ``torch.backends.cudnn.allow_tf32`` on by default, which would make
an "fp32" run's convolutions keep about three decimal digits; the fp16
policy computes its convolutions in fp16 and does not read these flags.
"""

from __future__ import annotations

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
