"""Where the port's tensors live.

Every entry point takes an optional ``device``. Left unset it means the
card: the port is written for an NVIDIA GPU, and a run that silently fell
back to the CPU would report CPU numbers under a GPU's name. The CPU is
used only when the caller asks for it, as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for ``device``: ``cuda`` when unset, and an error
    when a CUDA device is wanted but no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "euler_tpu_torch runs on a CUDA device and none is available; "
            'pass device="cpu" to run the plain PyTorch versions on the CPU'
        )
    return dev
