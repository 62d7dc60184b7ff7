"""Device and compute-dtype selection for the port's entry points.

Every entry point takes ``device=`` with default ``"cuda"``.  With no card
present that default raises; the port never continues on the CPU unless the
caller asked for the CPU explicitly.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: "str | torch.device | None" = DEFAULT_DEVICE) -> torch.device:
    """The torch device an entry point runs on; raises RuntimeError when a
    CUDA device is asked for (the default) and none is available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "photon_ml_tpu_torch: a CUDA device was requested "
            f"(device={str(dev)!r}) but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def torch_dtype(dtype) -> torch.dtype:
    """torch.float32/float64 from a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = {np.dtype(np.float32): torch.float32,
               np.dtype(np.float64): torch.float64}.get(np.dtype(dtype))
    if out not in (torch.float32, torch.float64):
        raise ValueError(f"compute dtype must be float32 or float64, not {dtype!r}")
    return out
