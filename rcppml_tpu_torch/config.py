"""Configuration dataclasses of the port.

The same fields, defaults and validation as ``rcppml_tpu/config.py``
(``NMFConfig.validate`` at ``:207-289``), copied so that this package never
imports JAX.  The configs stay frozen and hashable; nothing here depends on
a backend.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass

from . import constants


class Loss(enum.Enum):
    """Distribution families (math/loss.hpp:39-50)."""
    MSE = "mse"
    KL = "kl"            # internal: IRLS weight mode used for GP updates
    GP = "gp"            # Generalized Poisson
    NB = "nb"            # Negative Binomial
    GAMMA = "gamma"
    INVGAUSS = "inverse_gaussian"
    TWEEDIE = "tweedie"


class Dispersion(enum.Enum):
    """Dispersion parameterization (math/loss.hpp:55-60)."""
    NONE = "none"
    GLOBAL = "global"
    PER_ROW = "per_row"
    PER_COL = "per_col"


class ZI(enum.Enum):
    """Zero-inflation mode (math/loss.hpp:73-78). TWOWAY is rejected at
    validate time, as in the reference (core/config.hpp:437-440)."""
    NONE = "none"
    ROW = "row"
    COL = "col"


class Norm(enum.Enum):
    """Factor-row normalization (core/types.hpp:99-107)."""
    L1 = "L1"
    L2 = "L2"
    NONE = "none"


class Solver(enum.Enum):
    """NNLS solver mode (core/config.hpp:133)."""
    CD = 0          # coordinate descent (exact NNLS)
    CHOLESKY = 1    # unconstrained Cholesky solve + clip


@dataclass(frozen=True)
class FactorConfig:
    """Per-factor (W or H) regularization config (core/factor_config.hpp:37-132).

    ``graph_lambda`` / ``target_lambda`` are scalars here; the Laplacian and
    target matrices themselves are passed to the fit as tensors.
    A positive ``target_lambda`` enriches toward the target; negative
    activates PROJ_ADV eigen-projected removal (factor_config.hpp:80-102).
    """
    L1: float = 0.0
    L2: float = 0.0
    L21: float = 0.0
    angular: float = 0.0
    nonneg: bool = True
    upper_bound: float = 0.0      # 0 = unbounded
    graph_lambda: float = 0.0     # >0 iff a graph Laplacian array is supplied
    target_lambda: float = 0.0    # !=0 iff a target matrix array is supplied

    def has_tier2(self) -> bool:
        return self.L21 > 0 or self.angular > 0 or self.graph_lambda > 0


@dataclass(frozen=True)
class NMFConfig:
    """Unified NMF config (core/config.hpp:54-454), frozen and hashable."""
    rank: int = 10
    tol: float = constants.NMF_TOL
    max_iter: int = constants.NMF_MAXIT
    patience: int = constants.NMF_PATIENCE

    W: FactorConfig = FactorConfig()
    H: FactorConfig = FactorConfig()

    loss: Loss = Loss.MSE
    robust_delta: float = 0.0          # Huber-on-Pearson; 0 = off
    tweedie_power: float = 1.5

    dispersion: Dispersion = Dispersion.PER_ROW
    theta_init: float = 0.1            # GP theta init
    theta_min: float = 0.0
    theta_max: float = 0.9
    nb_size_init: float = 10.0
    nb_size_min: float = 0.01     # core/config.hpp:192
    nb_size_max: float = 1e6      # core/config.hpp:189 (near-Poisson genes
                                  # legitimately reach huge theta)
    gamma_phi_init: float = 1.0
    gamma_phi_min: float = 1e-4
    gamma_phi_max: float = 1e4

    zi: ZI = ZI.NONE
    zi_em_iters: int = 1

    solver: Solver = Solver.CHOLESKY   # reference default solver_mode=1
    cd_max_iter: int = constants.CD_MAXIT
    cd_tol: float = constants.CD_TOL
    irls_max_iter: int = constants.IRLS_MAX_ITER
    irls_tol: float = constants.IRLS_TOL

    seed: int = 0
    init_mode: int = 0                 # 0=random, 1=lanczos SVD, 2=irlba SVD
    norm: Norm = Norm.L1
    projective: bool = False
    symmetric: bool = False
    sort_model: bool = False

    # Cross-validation (speckled holdout) fields (config.hpp:240-260)
    test_fraction: float = 0.0
    cv_seed: int = 0
    mask_zeros: bool = False
    cv_patience: int = constants.NMF_PATIENCE
    # row/col subsampling: restrict holdout eligibility for speed
    # (speckled_cv.hpp:67-73)
    cv_col_subsample: float = 1.0
    cv_row_subsample: float = 1.0
    # GP/KL weight blend (0 = pure KL, 1 = full GP Fisher weight)
    gp_blend: float = 1.0

    track_loss_history: bool = True
    enable_profiling: bool = False
    verbose: bool = False
    # opt-in: store A as bfloat16 for the ALS matmuls, fp32 accumulation
    # (rcppml_tpu/config.py:144-162 gives the reasons it is never on by
    # default: a seed must mean the same factors, and the loss histories
    # drive the stopping rule).  Plain MSE fits only.
    bf16_data: bool = False
    # opt-in whole-fit Newton-Schulz ALS (ops/fused_als.py): the entire
    # fixed-iteration fit is one call that enqueues its kernels and returns,
    # the k x k Gram inverted by warm-started Newton-Schulz instead of a
    # Cholesky solve.  Same ALS fixed point to ~1e-3 relative, different
    # trailing digits, hence opt-in and never automatic.  Plain dense MSE
    # only: fixed maxit (tol=0), L1 norm, nonneg, L1/L2 penalties allowed.
    fused_vmem: bool = False

    # presence flags for the auxiliary arrays (masks, graphs, targets)
    has_mask: bool = False
    has_graph_W: bool = False
    has_graph_H: bool = False
    has_target_H: bool = False
    has_target_W: bool = False

    def requires_irls(self) -> bool:
        return self.loss not in (Loss.MSE,) or self.robust_delta > 0

    def is_cv(self) -> bool:
        return self.test_fraction > 0

    def has_zi(self) -> bool:
        return self.zi != ZI.NONE

    def replace(self, **kw) -> "NMFConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        """Reject illegal combinations (core/config.hpp:421-453)."""
        if self.rank <= 0:
            raise ValueError(f"rank must be positive, got {self.rank}")
        # penalty ranges (R/nmf_validation.R, test_validation_errors.R:35-71)
        for side, fc in (("W", self.W), ("H", self.H)):
            if not (0.0 <= fc.L1 < 1.0):
                raise ValueError(
                    f"L1 penalty must be in [0, 1), got {fc.L1} on {side} "
                    f"(L1 is a fraction of the max coefficient)")
            for name in ("L2", "L21", "angular", "upper_bound",
                         "graph_lambda"):
                val = getattr(fc, name)
                if val < 0:
                    raise ValueError(f"{name} must be non-negative, got "
                                     f"{val} on {side}")
        if self.max_iter <= 0:
            raise ValueError(f"max_iter must be positive, got {self.max_iter}")
        if self.tol < 0:
            raise ValueError("tol must be non-negative")
        if self.cd_max_iter <= 0:
            raise ValueError("cd_max_iter must be positive")
        if self.solver == Solver.CHOLESKY and self.requires_irls():
            raise ValueError(
                "Cholesky solver is not supported with IRLS-based distributions. "
                "Use the CD solver for GP, NB, Gamma, Inverse Gaussian, Tweedie, "
                "or robust losses.")
        if self.projective and self.symmetric:
            raise ValueError("projective and symmetric cannot both be true")
        if self.has_zi() and self.loss not in (Loss.GP, Loss.NB):
            raise ValueError("zero-inflation requires loss='gp' or loss='nb'")
        if not (0.0 <= self.test_fraction < 1.0):
            raise ValueError("test_fraction must be in [0, 1)")
        if self.loss == Loss.TWEEDIE and self.tweedie_power < 0:
            raise ValueError("tweedie_power must be >= 0")
        # PROJ_ADV's whole-Gram eigen-clip does not commute with the
        # per-column Gram corrections of CV/masked/IRLS solves; the
        # reference silently drops ALL targets there (apply_cv_features,
        # variant_helpers.hpp:174-189 has no target branch) — we reject
        # instead of silently returning an un-regularized model.
        has_proj_adv = self.W.target_lambda < 0 or self.H.target_lambda < 0
        if has_proj_adv and (self.is_cv() or self.has_mask):
            raise ValueError(
                "PROJ_ADV target regularization (negative target_lambda) is "
                "not supported with CV (test_fraction > 0) or a user mask. "
                "Enrichment targets (positive target_lambda) are supported.")
        if has_proj_adv and self.requires_irls():
            raise ValueError(
                "PROJ_ADV target regularization (negative target_lambda) "
                "requires the MSE loss.")
        if self.bf16_data and (self.requires_irls() or self.is_cv()
                               or self.has_mask or self.mask_zeros):
            # only the fused MSE loop honors the bf16 data path — reject
            # rather than silently ignore the knob elsewhere
            raise ValueError(
                "bf16_data is supported for the plain MSE fit only (no "
                "IRLS losses, CV, or masks)")
        if self.fused_vmem:
            blockers = []
            if self.requires_irls():
                blockers.append("non-MSE/robust losses")
            if self.is_cv() or self.has_mask or self.mask_zeros:
                blockers.append("CV/masks")
            if self.projective or self.symmetric:
                blockers.append("projective/symmetric variants")
            if self.tol != 0.0:
                blockers.append("tol-based early stopping (set tol=0.0; "
                                "the kernel runs a fixed max_iter)")
            if self.norm != Norm.L1:
                blockers.append("norms other than L1")
            for side, fc in (("W", self.W), ("H", self.H)):
                # L1/L2 are supported in-kernel (RHS shift / Gram
                # diagonal, cholesky_clip.hpp:79-87 semantics)
                if (fc.L21 or fc.angular or fc.upper_bound
                        or fc.graph_lambda or fc.target_lambda
                        or not fc.nonneg):
                    blockers.append(f"tier-2 penalties/bounds/targets on "
                                    f"{side} (and nonneg must stay on)")
            if blockers:
                raise ValueError(
                    "fused_vmem supports the dense nonneg MSE fit "
                    "(optionally L1/L2-penalized); unsupported here: "
                    + "; ".join(blockers))


@dataclass(frozen=True)
class SVDConfig:
    """Truncated SVD config (core/svd_config.hpp:32)."""
    k: int = 10
    tol: float = 1e-5
    max_iter: int = 0                  # 0 = auto
    center: bool = False
    scale: bool = False
    seed: int = 0
    oversample: int = 10               # randomized SVD oversampling
    power_iters: int = 2               # randomized SVD power iterations
    work: int = 0                      # IRLBA working size; 0 = k + 7
    robust_delta: float = 0.0
    # convergence criterion for deflation/krylov (svd_config.hpp:25-29):
    # "factor" = relative factor change, "loss" = relative sigma /
    # variance change, "both" = either
    convergence: str = "factor"

    # Per-side constraints (krylov / deflation solvers)
    u: FactorConfig = FactorConfig(nonneg=False)
    v: FactorConfig = FactorConfig(nonneg=False)

    # CV
    test_fraction: float = 0.0
    cv_seed: int = 0
    patience: int = 3                  # auto-rank non-improving factors (R/svd.R:43)
    # CV holdout restricted to nonzero entries (svd_config.hpp:127;
    # recommender-style missingness)
    mask_zeros: bool = False

    def replace(self, **kw) -> "SVDConfig":
        return dataclasses.replace(self, **kw)
