"""Device selection for the port's entry points.

Every entry point takes ``device=`` with default ``"cuda"``.  With no card
present that default raises; the port never continues on the CPU unless the
caller asked for the CPU explicitly.
"""

from __future__ import annotations

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
