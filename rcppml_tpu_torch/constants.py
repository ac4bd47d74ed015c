"""Numeric constants shared across the framework.

The same values as ``rcppml_tpu/constants.py``, copied so that this package
never imports JAX (``rcppml_tpu/__init__.py`` imports it).  Values are kept
identical to the reference's constants contract
(``inst/include/FactorNet/core/constants.hpp:41-108``) so that convergence
decisions and epsilon guards match.
"""

# Coordinate-descent NNLS (constants.hpp:64-76)
CD_TOL = 1e-8          # per-sweep mean relative-change early-exit threshold
# fp32 floor for the per-sweep exit: the reference's 1e-8 was chosen for
# double-precision CD (constants.hpp:64); in fp32 the residual-tracked
# coordinate changes bottom out at ~1e-7 relative, so 1e-8 NEVER fires and
# every solve burns the full cd_maxit sweeps.  Clamping to ~4 ulp keeps the
# criterion's meaning — "stop when changes reach numerical noise" — at
# this precision.
CD_TOL_F32_FLOOR = 5e-6
CD_MAXIT = 100         # max CD sweeps per solve
CD_ABS_TOL = 1e-15     # denominator guard in relative-change accumulation

# NMF outer loop (constants.hpp:83-89)
NMF_TOL = 1e-4         # relative loss-change tolerance
NMF_MAXIT = 100        # max ALS iterations
NMF_PATIENCE = 5       # consecutive sub-tol checks required for convergence

# Numeric guards (constants.hpp:42-53)
TINY_NUM = 1e-15       # component-death guard added to scaling vector d
KL_EPSILON = 1e-10     # mu clamp inside KL / count-likelihood terms

DEFAULT_HUBER_DELTA = 1.0

# IRLS inner loop (core/config.hpp:151-154)
IRLS_MAX_ITER = 5
IRLS_TOL = 1e-4
