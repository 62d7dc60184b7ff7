"""photon_ml_tpu_torch: the PyTorch / CUDA (NVIDIA Hopper) port of photon_ml_tpu.

The JAX package ``photon_ml_tpu`` is the reference; this package mirrors its
module names so each module's counterpart is easy to find.  It imports torch
and numpy only.  Entry points take ``device=`` and default to ``"cuda"``;
they run on the CPU only when the caller asks for it.

Slice covered so far: GLMix training (``game.GameEstimator.fit``) with a
dense fixed effect under L-BFGS and a dense per-entity random effect under
the structure-of-arrays Newton solver, ``models.GameModel.score`` and AUC.
The two hot kernels are hand-written CUDA C++ for sm_90a (``csrc/``).
"""

from photon_ml_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
