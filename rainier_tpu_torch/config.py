"""Global numeric configuration of the PyTorch port.

Counterpart of ``rainier_tpu/config.py``.  State is float32 by default
(the H100's non-tensor-core f32 rate is what the sampler runs at), and
entry points run on the CUDA card unless the caller asks for the CPU —
``device="cpu"`` on a call, or ``set_device("cpu")`` for the process, as
the CPU tests do.  Nothing moves to the CPU silently when CUDA is
missing: :func:`resolve_device` raises instead.

Matmul precision: the JAX package forces f32-exact density matmuls
(``_MATMUL_PRECISION = "highest"``, rainier_tpu/config.py:19-37).  The
counterpart here is keeping TF32 off for both cuBLAS matmuls and cuDNN,
set once when this module is imported.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_DTYPE = torch.float32
_DEVICE = "cuda"


def set_dtype(dtype) -> None:
    global _DTYPE
    _DTYPE = dtype


def dtype() -> torch.dtype:
    """Compute dtype used when lowering graphs / running samplers."""
    return _DTYPE


def set_device(device) -> None:
    """Default device of every entry point ("cuda" unless changed)."""
    global _DEVICE
    _DEVICE = str(torch.device(device))


def device() -> str:
    return _DEVICE


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the argument, else the
    process default; "cuda" is the process's current card (the rank's,
    once parallel.initialize has pinned it).  Raises when that is CUDA
    and no card is present."""
    dev = torch.device(device if device is not None else _DEVICE)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rainier_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' or call "
            "rainier_tpu_torch.config.set_device('cpu')")
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
