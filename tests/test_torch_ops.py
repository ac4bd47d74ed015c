"""The port's ops against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both packages as numpy arrays.
Plain products are compared at rtol 1e-5 (the two frameworks sum in other
orders).  The CD NNLS twin is compared bit for bit: see
``test_cd_plain_matches_jax_sweep_bitwise``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rcppml_tpu.config import FactorConfig as RefFactorConfig
from rcppml_tpu.config import Norm as RefNorm
from rcppml_tpu.ops import features as ref_feat
from rcppml_tpu.ops import linalg as ref_linalg
from rcppml_tpu.ops import solvers as ref_solvers

from rcppml_tpu_torch.config import FactorConfig, Norm
from rcppml_tpu_torch.ops import cd_nnls
from rcppml_tpu_torch.ops import features as feat
from rcppml_tpu_torch.ops import linalg, solvers

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _close(port, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _factors(seed, k=6, m=40, n=30):
    rs = np.random.RandomState(seed)
    F = rs.uniform(0.1, 1.0, (k, m)).astype(np.float32)
    A = rs.uniform(0.0, 1.0, (m, n)).astype(np.float32)
    H = rs.uniform(0.1, 1.0, (k, n)).astype(np.float32)
    return F, A, H


# ---------------------------------------------------------------------------
# Package hygiene
# ---------------------------------------------------------------------------

def test_import_loads_neither_jax_nor_triton():
    code = ("import sys, rcppml_tpu_torch; "
            "bad = [m for m in ('jax', 'triton') if m in sys.modules]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_port_source_imports_jax():
    for path in (REPO / "rcppml_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax")), \
                f"{path}: {line}"


# ---------------------------------------------------------------------------
# linalg
# ---------------------------------------------------------------------------

def test_gram_and_rhs():
    F, A, _ = _factors(0)
    _close(linalg.gram(_t(F)), ref_linalg.gram(jnp.asarray(F)))
    _close(linalg.rhs(_t(F), _t(A)), ref_linalg.rhs(jnp.asarray(F),
                                                    jnp.asarray(A)))


@pytest.mark.parametrize("norm", ["L1", "L2", "none"])
def test_extract_scaling(norm):
    _, _, H = _factors(1)
    X, d = linalg.extract_scaling(_t(H), Norm(norm))
    Xr, dr = ref_linalg.extract_scaling(jnp.asarray(H), RefNorm(norm))
    _close(X, Xr)
    _close(d, dr)


def test_gram_trick_losses():
    F, A, H = _factors(2)
    trAtA = float((A.astype(np.float64) ** 2).sum())
    G, B = F @ F.T, F @ A
    port = linalg.gram_trick_loss(torch.tensor(trAtA, dtype=torch.float32),
                                  _t(G), _t(B), _t(H))
    ref = ref_linalg.gram_trick_loss(jnp.float32(trAtA), jnp.asarray(G),
                                     jnp.asarray(B), jnp.asarray(H))
    _close(port, ref, rtol=1e-4)

    d = np.random.RandomState(3).uniform(0.5, 2.0, F.shape[0]).astype(
        np.float32)
    B_w = H @ A.T
    G_w = H @ H.T
    port = linalg.mse_loss_from_saved(
        torch.tensor(trAtA, dtype=torch.float32), _t(F), _t(d), _t(B_w),
        _t(G_w))
    ref = ref_linalg.mse_loss_from_saved(
        jnp.float32(trAtA), jnp.asarray(F), jnp.asarray(d), jnp.asarray(B_w),
        jnp.asarray(G_w))
    _close(port, ref, rtol=1e-4)


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------

def _gram_rhs(seed):
    F, A, H = _factors(seed)
    return F @ F.T + np.eye(F.shape[0], dtype=np.float32), F @ A, H, F


def test_apply_l1_l2():
    G, B, _, _ = _gram_rhs(4)
    Gp, Bp = feat.apply_l1_l2(_t(G), _t(B), 0.2, 0.3)
    Gr, Br = ref_feat.apply_l1_l2(jnp.asarray(G), jnp.asarray(B), 0.2, 0.3)
    _close(Gp, Gr)
    _close(Bp, Br)


def test_apply_l21_and_graph_reg():
    G, _, H, _ = _gram_rhs(5)
    H[2] = 0.0                        # a dead row takes the guarded branch
    _close(feat.apply_l21(_t(G), _t(H), 0.5),
           ref_feat.apply_l21(jnp.asarray(G), jnp.asarray(H), 0.5))
    n = H.shape[1]
    rs = np.random.RandomState(6)
    adj = (rs.uniform(size=(n, n)) < 0.2).astype(np.float32)
    adj = np.triu(adj, 1) + np.triu(adj, 1).T
    lap = (np.diag(adj.sum(1)) - adj).astype(np.float32)
    _close(feat.apply_graph_reg(_t(G), _t(lap), _t(H), 0.3),
           ref_feat.apply_graph_reg(jnp.asarray(G), jnp.asarray(lap),
                                    jnp.asarray(H), 0.3))


@pytest.mark.parametrize("lam", [0.4, -0.5])
def test_apply_target(lam):
    G, B, H, _ = _gram_rhs(7)
    T = np.random.RandomState(8).uniform(size=B.shape).astype(np.float32)
    T_gram = (T @ T.T / T.shape[1]).astype(np.float32)
    Gp, Bp = feat.apply_target(_t(G), _t(B), FactorConfig(target_lambda=lam),
                               _t(T), _t(T_gram))
    Gr, Br = ref_feat.apply_target(jnp.asarray(G), jnp.asarray(B),
                                   RefFactorConfig(target_lambda=lam),
                                   jnp.asarray(T), jnp.asarray(T_gram))
    # eigh + reassembly: absolute error ~ eps * ||G||
    _close(Gp, Gr, rtol=1e-4, atol=1e-5 * float(np.abs(G).max()))
    _close(Bp, Br)


def test_apply_features_sequence():
    G, B, H, _ = _gram_rhs(9)
    kw = dict(L1=0.1, L2=0.2, L21=0.3)
    Gp, Bp = feat.apply_features(_t(G), _t(B), _t(H), FactorConfig(**kw))
    Gr, Br = ref_feat.apply_features(jnp.asarray(G), jnp.asarray(B),
                                     jnp.asarray(H), RefFactorConfig(**kw))
    _close(Gp, Gr)
    _close(Bp, Br)


def test_apply_upper_bound_and_angular():
    _, _, H, _ = _gram_rhs(10)
    _close(feat.apply_upper_bound(_t(H), 0.5),
           ref_feat.apply_upper_bound(jnp.asarray(H), 0.5))
    _close(feat.apply_angular_posthoc(_t(H), 0.05),
           ref_feat.apply_angular_posthoc(jnp.asarray(H), 0.05), atol=1e-6)


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nonneg", [True, False])
def test_cholesky_clip_batch(nonneg):
    G, B, _, _ = _gram_rhs(11)
    port = solvers.cholesky_clip_batch(_t(G), _t(B), nonneg=nonneg,
                                       upper_bound=2.0)
    ref = ref_solvers.cholesky_clip_batch(jnp.asarray(G), jnp.asarray(B),
                                          nonneg=nonneg, upper_bound=2.0)
    _close(port, ref, atol=1e-6)


def test_eff_cd_tol_floor():
    assert solvers._eff_cd_tol(1e-8, torch.float32) == \
        ref_solvers._eff_cd_tol(1e-8, np.float32) == 5e-6
    assert solvers._eff_cd_tol(1e-3, torch.float32) == 1e-3
    assert solvers._eff_cd_tol(1e-8, torch.float64) == 1e-8


def _spd_system(k, n, seed, dead_coord=False, warm=True):
    """tests/test_tpu_kernels.py's system: G = F F' with |normal| F."""
    rs = np.random.RandomState(seed)
    F = np.abs(rs.normal(size=(k, max(2 * k, 64)))).astype(np.float32)
    if dead_coord:
        F[k // 2, :] = 0.0
    G = (F @ F.T).astype(np.float32)
    B = rs.normal(size=(k, n)).astype(np.float32)
    X0 = np.abs(rs.normal(size=(k, n))).astype(np.float32)
    if not warm:
        X0 = np.zeros_like(X0)
    return G, (B - G @ X0).astype(np.float32), X0


# (k, L1, upper_bound, dead coordinate, warm start, cd_tol, maxit).  L1 is
# small enough that the solutions are not all zero; maxit is cut at large k
# because the JAX sweep runs one operation at a time here.
CD_CASES = [
    (8, 0.0, 0.0, False, True, 1e-8, 100),
    (50, 0.01, 0.0, False, True, 5e-6, 20),
    (100, 0.0, 0.0, False, False, 5e-6, 8),
    (16, 0.01, 0.0, True, True, 5e-6, 100),
    (20, 0.005, 0.05, False, True, 5e-6, 40),
]


@pytest.mark.parametrize("k,l1,ub,dead,warm,tol,maxit", CD_CASES)
def test_cd_plain_matches_jax_sweep_bitwise(k, l1, ub, dead, warm, tol,
                                            maxit):
    """The twin against ``_cd_sweeps`` run operation by operation.

    Compiled, XLA's CPU backend fuses the rank-1 update
    ``B_res - g_col * actual`` into a fused multiply-add: at k=8 the first
    sweep's last coordinate then differs in 81 of 300 columns, and the
    difference grows over an ill-conditioned solve.  The twin (and the CUDA
    kernel) round the product and the difference separately, which is what
    ``jax.disable_jit`` gives, one primitive at a time: there the two agree
    bit for bit.
    """
    G, B_res, X0 = _spd_system(k, 300, seed=k, dead_coord=dead, warm=warm)
    with jax.disable_jit():
        ref = np.asarray(ref_solvers._cd_sweeps.__wrapped__(
            jnp.asarray(G), jnp.asarray(B_res), jnp.asarray(X0),
            jnp.float32(l1), jnp.float32(tol), nonneg=True, maxit=maxit,
            l1_static=True, upper_bound=ub))
    port = cd_nnls.cd_nnls_shared_plain(_t(G), _t(B_res), _t(X0), l1, tol,
                                        nonneg=True, maxit=maxit,
                                        upper_bound=ub).numpy()
    assert (port > 0).any()
    np.testing.assert_array_equal(port, ref)
    if dead:
        np.testing.assert_array_equal(port[k // 2], X0[k // 2])


def test_cd_wrapper_on_cpu_takes_the_plain_path():
    G, B_res, X0 = _spd_system(12, 64, seed=3)
    before = cd_nnls.cd_nnls_shared.launches
    out = solvers.cd_nnls_batch_traced(_t(G), _t(B_res), _t(X0), 0.0,
                                       nonneg=True, maxit=50, cd_tol=1e-8)
    plain = cd_nnls.cd_nnls_shared_plain(_t(G), _t(B_res), _t(X0), 0.0, 5e-6,
                                         nonneg=True, maxit=50)
    assert cd_nnls.cd_nnls_shared.launches == before
    assert torch.equal(out, plain)


def test_cd_nnls_batch_solves_nnls():
    """Cold and warm starts reach the same nonnegative solution, and it
    satisfies the KKT conditions of min ||Gx - b|| with x >= 0."""
    G, B_res, X0 = _spd_system(6, 50, seed=4)
    G = G + 10.0 * np.eye(6, dtype=np.float32)        # well conditioned
    B = (B_res + G @ X0).astype(np.float32)
    cold = solvers.cd_nnls_batch(_t(G), _t(B), maxit=500, cd_tol=1e-7)
    warm = solvers.cd_nnls_batch(_t(G), _t(B), _t(X0), maxit=500,
                                 cd_tol=1e-7, warm_start=True)
    np.testing.assert_allclose(cold.numpy(), warm.numpy(), atol=1e-4)
    x = cold.numpy().astype(np.float64)
    grad = G.astype(np.float64) @ x - B
    assert (x >= 0).all()
    assert np.abs(grad[x > 1e-6]).max() < 1e-3 * np.abs(B).max()
    assert grad[x <= 1e-6].min() > -1e-3 * np.abs(B).max()


def test_cd_wrapper_rejects_bad_inputs():
    G, B_res, X0 = _spd_system(4, 8, seed=5)
    with pytest.raises(ValueError):
        cd_nnls.cd_nnls_shared(_t(G)[:3, :3], _t(B_res), _t(X0), 0.0, 1e-6,
                               nonneg=True, maxit=5)
    with pytest.raises(TypeError):
        cd_nnls.cd_nnls_shared(_t(G).double(), _t(B_res), _t(X0), 0.0, 1e-6,
                               nonneg=True, maxit=5)
