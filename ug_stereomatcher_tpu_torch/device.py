"""Device and numeric policy of the port.

Every plane is float32, as in the reference.  TF32 is switched off for
matrix products and cuDNN convolutions, so nothing on the card rounds
float32 data to three decimal digits behind the caller's back (the same
trap as a TPU's default bf16 matmul).  A CUDA device that is asked for
and absent is an error: the port never runs a CUDA request on the CPU.
"""

from __future__ import annotations

import torch

DTYPE = torch.float32


def resolve_device(device: str | torch.device) -> torch.device:
    """Parse ``device`` and apply the numeric policy.

    Raises RuntimeError for a CUDA device on a machine without one, and
    ValueError for a device type the port does not run on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch finds no CUDA "
                f"device; pass device='cpu' to run the plain PyTorch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}; "
                         f"use 'cuda' or 'cpu'")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
