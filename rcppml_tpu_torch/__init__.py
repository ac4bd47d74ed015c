"""rcppml_tpu_torch — the PyTorch / CUDA port of ``rcppml_tpu``.

A second package beside the JAX one, which stays the reference.  This
slice carries the dense ALS-NMF fit with MSE loss, both solvers (Cholesky +
clip and CD NNLS), the L1/L2/L21/angular/graph/target features, and the
standard, projective and symmetric variants.  The CD NNLS solve runs in a
CUDA kernel written for Hopper (``csrc/cd_nnls_shared.cu``) on a CUDA
tensor, and in its plain PyTorch twin on a CPU tensor.

It imports ``torch`` and never ``jax``; kernels are built with ``nvcc`` at
first use, never at import.
"""

from .api import build_config, nmf
from .config import FactorConfig, Loss, NMFConfig, Norm, Solver
from .device import kernels_available, set_fp32_precision
from .result import NMFResult

__all__ = ["nmf", "build_config", "NMFConfig", "FactorConfig", "NMFResult",
           "Loss", "Norm", "Solver", "kernels_available",
           "set_fp32_precision"]
