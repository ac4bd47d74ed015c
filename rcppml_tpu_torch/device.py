"""Device helpers: where the kernels run, and float32 matmul precision.

``kernels_available`` plays the role of ``pallas_available()``
(``rcppml_tpu/ops/pallas_kernels.py:231-242``): the hand-written kernels are
built for ``sm_90a`` and run only on a Hopper card.
``set_fp32_precision`` is the counterpart of ``PREC = HIGHEST``
(``rcppml_tpu/ops/linalg.py:30-32``): float32 products stay in full float32,
never TF32, so Grams that feed Cholesky solves keep their precision.
"""

from __future__ import annotations

import torch


def kernels_available() -> bool:
    """True when CUDA is present and device 0 has compute capability 9.0."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0) == (9, 0))


def set_fp32_precision() -> None:
    """Turn TF32 off for float32 matmuls and convolutions (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
