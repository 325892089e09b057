"""cnn_tpu_torch — the PyTorch/CUDA port of ``cnn_tpu`` for NVIDIA Hopper.

The package mirrors ``cnn_tpu``'s module names. Plain tensor code is
PyTorch; every kernel that ``cnn_tpu`` wrote in Pallas is a CUDA C++ kernel
under ``csrc/``, built with ``nvcc`` at first use and bound with ``ctypes``
(``ops/hopper/``). Activations stay NHWC and conv weights HWIO, as in
``cnn_tpu``, so weights carry across unchanged.

Entry points run on the GPU unless the caller asks for the CPU, where every
kernel wrapper takes its plain PyTorch version.

This package imports ``torch`` and numpy only: never JAX, optax, cv2 or
``cnn_tpu``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else CUDA.

    Raises when no CUDA device is present and the caller did not name one,
    so that nothing drops to the CPU unasked.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return torch.device("cuda")
