"""photon_ml_tpu_torch: the PyTorch / CUDA (NVIDIA Hopper) port of photon_ml_tpu.

The JAX package ``photon_ml_tpu`` is the reference; this package mirrors its
module names so each module's counterpart is easy to find.  It imports torch
and numpy only.  Entry points take ``device=`` and default to ``"cuda"``;
they run on the CPU only when the caller asks for it.

Covered so far: GLMix training (``game.GameEstimator.fit``) over dense
shards, with fixed effects under L-BFGS or TRON and per-entity random
effects on the structure-of-arrays Newton solver (narrow lanes) or the
lane-batched L-BFGS / TRON (every other lane), ``models.GameModel.score``
and AUC.  The three hot kernels are hand-written CUDA C++ for sm_90a
(``csrc/``).
"""

from photon_ml_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
