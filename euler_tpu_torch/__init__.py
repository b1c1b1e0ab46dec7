"""euler_tpu_torch: the PyTorch/CUDA port of euler_tpu for NVIDIA Hopper.

The package mirrors ``euler_tpu``'s module layout and names, so each
counterpart is easy to find (``graph/device.py``, ``nn/encoders.py``,
``models/graphsage.py``, ``train.py``), and keeps its own copy of
everything it needs: it imports ``torch`` and numpy, never ``jax`` and
nothing of ``euler_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see ``device.resolve_device``). Every TPU kernel of the JAX package
becomes a kernel written by hand for Hopper under ``csrc/``; on CPU
tensors its wrapper runs the plain PyTorch version, on CUDA tensors it
launches the kernel or raises.
"""

from euler_tpu_torch.device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
