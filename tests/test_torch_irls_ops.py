"""The port's IRLS ops against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both packages as numpy arrays.
Off the TPU the JAX package takes its plain lax / XLA branches, which is what
the port's twins mirror.  Tolerances:

  * elementwise float32 maths (weights, losses, dispersion updates): rtol
    1e-5 (``lgamma``, ``pow``, ``log1p`` differ by a few ulp between the two
    frameworks), with an atol of 1e-6 of the largest entry where a loss
    cancels to near zero;
  * contractions (weighted Gram and RHS, batched solves): 1e-4 of the largest
    entry (the two frameworks sum in other orders);
  * the per-column-Gram CD twin against the lax loop run op by op: bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rcppml_tpu.config import (Dispersion as RefDispersion,
                               FactorConfig as RefFactorConfig,
                               Loss as RefLoss, NMFConfig as RefNMFConfig,
                               Solver as RefSolver, ZI as RefZI)
from rcppml_tpu.models import nmf_irls as ref_irls
from rcppml_tpu.ops import features as ref_feat
from rcppml_tpu.ops import linalg as ref_linalg
from rcppml_tpu.ops import losses as ref_losses
from rcppml_tpu.ops import solvers as ref_solvers

from rcppml_tpu_torch import convert
from rcppml_tpu_torch.config import FactorConfig
from rcppml_tpu_torch.models import nmf_irls
from rcppml_tpu_torch.ops import (cd_nnls_batched, features as feat, linalg,
                                  losses, solvers, wgram)

RTOL = 1e-5
LOSSES = ["mse", "kl", "gp", "nb", "gamma", "inverse_gaussian", "tweedie"]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _j(x):
    return jnp.asarray(np.asarray(x, dtype=np.float32))


def _close(port, ref, rtol=RTOL, scale_atol=1e-6):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    atol = scale_atol * float(np.abs(ref).max()) if ref.size else 0.0
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def _cfgs(**kw):
    """The same config in both packages (CD solver: IRLS needs it)."""
    ref = RefNMFConfig(solver=RefSolver.CD, **{
        key: (RefLoss(val) if key == "loss" else
              RefDispersion(val) if key == "dispersion" else
              RefZI(val) if key == "zi" else val)
        for key, val in kw.items()})
    return convert.config_from_reference(ref), ref


def _field(seed, m=40, n=30, positive=False):
    """Counts y, a positive mean mu with some tiny entries, a dispersion."""
    rs = np.random.RandomState(seed)
    mu = rs.gamma(1.0, 2.0, size=(m, n)).astype(np.float32)
    mu[rs.uniform(size=mu.shape) < 0.05] = 1e-7
    y = rs.poisson(np.maximum(mu, 0.3)).astype(np.float32)
    if positive:
        y = y + rs.uniform(0.1, 1.0, size=y.shape).astype(np.float32)
    theta = rs.uniform(0.05, 5.0, size=(m, 1)).astype(np.float32)
    return y, mu, np.broadcast_to(theta, (m, n)).copy()


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_w_cap_is_the_reference_cap():
    assert losses._W_CAP == ref_losses._W_CAP == 1e6


@pytest.mark.parametrize("name,args", [
    ("irls_weight_kl", ("mu",)),
    ("irls_weight_gp", ("y", "mu", "theta")),
    ("irls_weight_nb", ("mu", "theta")),
    ("loss_mse", ("y", "mu")),
    ("loss_kl", ("y", "mu")),
    ("loss_gp", ("y", "mu", "theta")),
    ("loss_gamma", ("ypos", "mu")),
    ("loss_invgauss", ("ypos", "mu")),
])
def test_weight_and_loss_functions(name, args):
    y, mu, theta = _field(0)
    ypos = _field(0, positive=True)[0]
    vals = {"y": y, "ypos": ypos, "mu": mu, "theta": theta}
    port = getattr(losses, name)(*[_t(vals[a]) for a in args])
    ref = getattr(ref_losses, name)(*[_j(vals[a]) for a in args])
    _close(port, ref)


@pytest.mark.parametrize("p", [1.5, 2.0, 3.0, 0.5])
def test_irls_weight_power(p):
    _, mu, _ = _field(1)
    _close(losses.irls_weight_power(_t(mu), p),
           ref_losses.irls_weight_power(_j(mu), p))


@pytest.mark.parametrize("p", [1.0, 1.5, 2.0, 2.7])
def test_loss_tweedie(p):
    y, mu, _ = _field(2, positive=True)
    _close(losses.loss_tweedie(_t(y), _t(mu), p),
           ref_losses.loss_tweedie(_j(y), _j(mu), p), rtol=1e-4)


@pytest.mark.parametrize("r", [0.5, 10.0, 299.0, 301.0, 1e4, 1e6])
def test_loss_nb_both_sides_of_the_stirling_switch(r):
    y, mu, _ = _field(3)
    rr = np.full_like(mu, r)
    # the direct form's lgamma(y + r) - lgamma(r) cancels: its absolute
    # error grows with r, so the bar is relative to the largest entry
    _close(losses.loss_nb(_t(y), _t(mu), _t(rr)),
           ref_losses.loss_nb(_j(y), _j(mu), _j(rr)), rtol=1e-4,
           scale_atol=1e-5)


@pytest.mark.parametrize("loss", LOSSES)
def test_variance_fn(loss):
    cfg, ref_cfg = _cfgs(loss=loss)
    _, mu, theta = _field(4)
    _close(losses.variance_fn(_t(mu), cfg, _t(theta)),
           ref_losses.variance_fn(_j(mu), ref_cfg, _j(theta)))


@pytest.mark.parametrize("robust", [0.0, 1.345])
@pytest.mark.parametrize("loss", LOSSES)
def test_compute_irls_weight(loss, robust):
    cfg, ref_cfg = _cfgs(loss=loss, robust_delta=robust)
    y, mu, theta = _field(5)
    _close(losses.compute_irls_weight(_t(y), _t(mu), cfg, _t(theta)),
           ref_losses.compute_irls_weight(_j(y), _j(mu), ref_cfg, _j(theta)),
           rtol=1e-4)


@pytest.mark.parametrize("robust", [0.0, 1.345])
@pytest.mark.parametrize("loss", LOSSES)
def test_compute_loss_elements(loss, robust):
    cfg, ref_cfg = _cfgs(loss=loss, robust_delta=robust)
    y, mu, theta = _field(6, positive=loss in ("gamma", "inverse_gaussian",
                                               "tweedie"))
    _close(losses.compute_loss_elements(_t(y), _t(mu), cfg, _t(theta)),
           ref_losses.compute_loss_elements(_j(y), _j(mu), ref_cfg,
                                            _j(theta)),
           rtol=1e-4, scale_atol=1e-5)


@pytest.mark.parametrize("nz_only", [False, True])
@pytest.mark.parametrize("theta_side", ["row", "col"])
@pytest.mark.parametrize("loss", LOSSES)
def test_explicit_loss(loss, theta_side, nz_only):
    cfg, ref_cfg = _cfgs(loss=loss)
    rs = np.random.RandomState(7)
    k, m, n = 4, 40, 30
    W_Td = rs.uniform(0.1, 1.0, (k, m)).astype(np.float32)
    H = rs.uniform(0.1, 1.0, (k, n)).astype(np.float32)
    A = rs.poisson(W_Td.T @ H).astype(np.float32)
    th = rs.uniform(0.1, 3.0, m if theta_side == "row" else n).astype(
        np.float32)
    kw = {f"theta_{theta_side}": th}
    port = losses.explicit_loss(_t(A), _t(W_Td), _t(H), cfg, nz_only=nz_only,
                                **{key: _t(v) for key, v in kw.items()})
    ref = ref_losses.explicit_loss(_j(A), _j(W_Td), _j(H), ref_cfg,
                                   nz_only=nz_only,
                                   **{key: _j(v) for key, v in kw.items()})
    np.testing.assert_allclose(float(port), float(ref), rtol=1e-4)


# ---------------------------------------------------------------------------
# linalg, features, batched solvers
# ---------------------------------------------------------------------------

def _wgram_operands(seed, k=5, m=40, bc=24):
    rs = np.random.RandomState(seed)
    F = rs.uniform(0.0, 1.0, (k, m)).astype(np.float32)
    w = rs.uniform(0.1, 3.0, (m, bc)).astype(np.float32)
    A = rs.poisson(1.0, (m, bc)).astype(np.float32)
    return F, w, A


def test_kr_product_and_budget():
    F, _, _ = _wgram_operands(0)
    ref = np.asarray(ref_linalg.kr_product(_j(F)).astype(jnp.float32))
    # the reference rounds the operand to bfloat16; the port keeps float32
    np.testing.assert_allclose(linalg.kr_product(_t(F)).numpy(), ref,
                               rtol=2 ** -8)
    np.testing.assert_array_equal(
        linalg.kr_product(_t(F)).numpy(),
        (F[:, None, :] * F[None, :, :]).reshape(25, -1))
    assert linalg.KR_BUDGET_FLOATS == ref_linalg.KR_BUDGET_FLOATS


@pytest.mark.parametrize("path", ["kr", "kr_given", "blocked"])
def test_weighted_gram_and_rhs(path, monkeypatch):
    F, w, A = _wgram_operands(1)
    Gr, br = ref_linalg.weighted_gram_and_rhs(_j(F), _j(w), _j(A))
    if path == "blocked":
        monkeypatch.setattr(linalg, "KR_BUDGET_FLOATS", 0)
    KR = linalg.kr_product(_t(F)) if path == "kr_given" else None
    Gp, bp = linalg.weighted_gram_and_rhs(_t(F), _t(w), _t(A), KR=KR)
    assert Gp.is_contiguous() and bp.is_contiguous()
    _close(Gp, Gr, rtol=0, scale_atol=1e-4)
    _close(bp, br, rtol=0, scale_atol=1e-4)


@pytest.mark.parametrize("which", ["none", "l21", "graph", "both"])
def test_tier2_gram_addition(which):
    rs = np.random.RandomState(2)
    H = rs.uniform(0.1, 1.0, (5, 30)).astype(np.float32)
    adj = (rs.uniform(size=(30, 30)) < 0.2).astype(np.float32)
    adj = np.triu(adj, 1) + np.triu(adj, 1).T
    lap = (np.diag(adj.sum(1)) - adj).astype(np.float32)
    kw = dict(L21=0.4 if which in ("l21", "both") else 0.0,
              graph_lambda=0.3 if which in ("graph", "both") else 0.0)
    graph = lap if which in ("graph", "both") else None
    port = feat.tier2_gram_addition(
        _t(H), FactorConfig(**kw), None if graph is None else _t(graph))
    ref = ref_feat.tier2_gram_addition(
        _j(H), RefFactorConfig(**kw), None if graph is None else _j(graph))
    if which == "none":
        assert port is None and ref is None
    else:
        _close(port, ref, rtol=1e-4)


def _batched_system(seed, k=6, n=50, dead=False, p=24):
    """G_j = F diag(w_j) F^T + ridge, b_j, a warm start."""
    rs = np.random.RandomState(seed)
    F = np.abs(rs.normal(size=(k, p))).astype(np.float32)
    if dead:
        F[k // 2] = 0.0
    w = rs.uniform(0.2, 2.0, (p, n)).astype(np.float32)
    Gb = np.einsum("kp,pj,lp->jkl", F, w, F).astype(np.float32)
    b = (F @ (w * np.abs(rs.normal(size=(p, n))))).astype(np.float32)
    X0 = np.abs(rs.normal(size=(k, n))).astype(np.float32)
    return Gb, b, X0


def test_batched_gram_matvec():
    Gb, _, X0 = _batched_system(3)
    port = solvers.batched_gram_matvec(_t(Gb), _t(X0))
    assert port.is_contiguous()
    _close(port, ref_solvers.batched_gram_matvec(_j(Gb), _j(X0)), rtol=1e-4)


def test_batched_spd_solve():
    Gb, b, _ = _batched_system(4)
    Gb = Gb + np.eye(6, dtype=np.float32)[None]
    port = solvers.batched_spd_solve(_t(Gb), _t(b))
    _close(port, ref_solvers.batched_spd_solve(_j(Gb), _j(b)), rtol=1e-4,
           scale_atol=1e-4)
    x = port.numpy().astype(np.float64)
    resid = np.einsum("jkl,lj->kj", Gb.astype(np.float64), x) - b
    assert np.abs(resid).max() < 1e-3 * np.abs(b).max()


@pytest.mark.parametrize("nonneg,ub", [(True, 0.0), (True, 0.5), (False, 0.0)])
def test_cholesky_clip_batched_gram(nonneg, ub):
    Gb, b, _ = _batched_system(5)
    Gb = Gb + np.eye(6, dtype=np.float32)[None]
    b = b - 2.0 * b.mean()                  # some negative solutions
    port = solvers.cholesky_clip_batched_gram(_t(Gb), _t(b), nonneg=nonneg,
                                              upper_bound=ub)
    ref = ref_solvers.cholesky_clip_batched_gram(_j(Gb), _j(b),
                                                 nonneg=nonneg,
                                                 upper_bound=ub)
    _close(port, ref, rtol=1e-4, scale_atol=1e-4)


# ---------------------------------------------------------------------------
# the per-column-Gram CD twin
# ---------------------------------------------------------------------------

# (k, L1, upper_bound, dead coordinate, cd_tol, maxit)
CDB_CASES = [
    (6, 0.0, 0.0, False, 1e-8, 60),
    (16, 0.01, 0.0, False, 5e-6, 30),
    (8, 0.01, 0.0, True, 5e-6, 60),
    (12, 0.005, 0.05, False, 5e-6, 40),
    (30, 0.0, 0.0, False, 5e-6, 10),
]


def _residual_form(Gb, b, X0):
    return (b - np.einsum("jkl,lj->kj", Gb, X0)).astype(np.float32)


@pytest.mark.parametrize("k,l1,ub,dead,tol,maxit", CDB_CASES)
def test_cd_batched_plain_matches_lax_loop_bitwise(k, l1, ub, dead, tol,
                                                   maxit):
    """The twin against the lax loop of ``cd_nnls_batched_gram`` run
    operation by operation: compiled, XLA fuses the rank-1 update into a
    multiply-add, which the twin and the CUDA kernel do not."""
    Gb, b, X0 = _batched_system(k, k=k, n=80, dead=dead, p=max(2 * k, 24))
    B_res = _residual_form(Gb, b, X0)
    with jax.disable_jit():
        ref = np.asarray(ref_solvers.cd_nnls_batched_gram(
            _j(Gb), _j(B_res), _j(X0), l1, nonneg=True, maxit=maxit,
            cd_tol=tol, upper_bound=ub))
    port, sweeps = cd_nnls_batched.cd_nnls_batched_plain(
        _t(Gb), _t(B_res), _t(X0), l1, solvers._eff_cd_tol(tol, torch.float32),
        nonneg=True, maxit=maxit, upper_bound=ub, return_sweeps=True)
    assert (port.numpy() > 0).any()
    np.testing.assert_array_equal(port.numpy(), ref)
    assert 1 <= int(sweeps.max()) <= maxit and int(sweeps.min()) >= 1
    if dead:
        np.testing.assert_array_equal(port.numpy()[k // 2], X0[k // 2])


@pytest.mark.parametrize("k,l1,ub,dead,tol,maxit", CDB_CASES[:4])
def test_cd_batched_gram_matches_jitted_reference(k, l1, ub, dead, tol,
                                                  maxit):
    Gb, b, X0 = _batched_system(k, k=k, n=80, dead=dead, p=max(2 * k, 24))
    Gb = Gb + 0.5 * np.eye(k, dtype=np.float32)[None]    # well conditioned
    if dead:
        Gb[:, k // 2, k // 2] = 0.0
    B_res = _residual_form(Gb, b, X0)
    ref = jax.jit(lambda G, B, X: ref_solvers.cd_nnls_batched_gram(
        G, B, X, l1, nonneg=True, maxit=200, cd_tol=tol,
        upper_bound=ub))(_j(Gb), _j(B_res), _j(X0))
    before = cd_nnls_batched.cd_nnls_batched.launches
    port = solvers.cd_nnls_batched_gram(_t(Gb), _t(B_res), _t(X0), l1,
                                        nonneg=True, maxit=200, cd_tol=tol,
                                        upper_bound=ub)
    assert cd_nnls_batched.cd_nnls_batched.launches == before
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())))


def test_cd_batched_frozen_column_stays():
    """A column that starts at its solution freezes after one sweep and
    keeps its value while the others go on."""
    Gb, b, X0 = _batched_system(9, k=6, n=20)
    Gb = Gb + np.eye(6, dtype=np.float32)[None]
    x_star = np.abs(np.random.RandomState(1).normal(size=6)).astype(
        np.float32)
    b[:, 0] = Gb[0] @ x_star
    X0[:, 0] = x_star
    B_res = _residual_form(Gb, b, X0)
    B_res[:, 0] = 0.0
    out, sweeps = cd_nnls_batched.cd_nnls_batched_plain(
        _t(Gb), _t(B_res), _t(X0), 0.0, 5e-6, nonneg=True, maxit=100,
        return_sweeps=True)
    np.testing.assert_array_equal(out.numpy()[:, 0], x_star)
    assert int(sweeps[0]) == 1 and int(sweeps.max()) > 1


def test_cd_batched_wrapper_rejects_bad_inputs():
    Gb, b, X0 = _batched_system(10, k=4, n=8)
    with pytest.raises(ValueError):
        cd_nnls_batched.cd_nnls_batched(_t(Gb)[:, :3, :3], _t(b), _t(X0), 0.0,
                                        1e-6, nonneg=True, maxit=5)
    with pytest.raises(TypeError):
        cd_nnls_batched.cd_nnls_batched(_t(Gb).double(), _t(b), _t(X0), 0.0,
                                        1e-6, nonneg=True, maxit=5)


# ---------------------------------------------------------------------------
# the fused weight + Gram + RHS twin
# ---------------------------------------------------------------------------

WG_CASES = [("kl", 0.0, None, "kl"), ("power", 2.0, None, "gamma"),
            ("power", 3.0, None, "inverse_gaussian"),
            ("power", 1.5, None, "tweedie"), ("nb", 0.0, "row", "nb"),
            ("nb", 0.0, "col", "nb")]


@pytest.mark.parametrize("sparse_zeros", [False, True])
@pytest.mark.parametrize("kind,power,theta,loss", WG_CASES)
def test_weighted_gram_rhs_plain(kind, power, theta, loss, sparse_zeros):
    rs = np.random.RandomState(11)
    k, m, bc = 5, 40, 24
    F = rs.uniform(0.0, 1.0, (k, m)).astype(np.float32)
    X = rs.uniform(0.0, 1.0, (k, bc)).astype(np.float32)
    A = rs.poisson(0.7, (m, bc)).astype(np.float32)
    th_row = rs.uniform(0.1, 20.0, m).astype(np.float32) \
        if theta == "row" else None
    th_col = rs.uniform(0.1, 20.0, bc).astype(np.float32) \
        if theta == "col" else None
    _, ref_cfg = _cfgs(loss=loss, tweedie_power=1.5)
    mu = _j(F).T @ _j(X)
    theta_b = ref_losses._expand_theta(
        None if th_row is None else _j(th_row),
        None if th_col is None else _j(th_col), (m, bc))
    w = ref_losses.compute_irls_weight(_j(A), mu, ref_cfg, theta_b)
    if sparse_zeros:
        w = jnp.where(_j(A) != 0, w, 1.0)
    Gr, br = ref_linalg.weighted_gram_and_rhs(_j(F), w, _j(A))

    args = (_t(F), _t(X), _t(A), None if th_row is None else _t(th_row),
            None if th_col is None else _t(th_col))
    kw = dict(loss_kind=kind, power=power, sparse_zeros=sparse_zeros)
    Gp, bp = wgram.weighted_gram_rhs_plain(*args, **kw)
    _close(Gp, Gr, rtol=0, scale_atol=1e-4)
    _close(bp, br, rtol=0, scale_atol=1e-4)
    before = wgram.weighted_gram_rhs.launches
    Gw, bw = wgram.weighted_gram_rhs(*args, **kw)     # CPU: the twin
    assert wgram.weighted_gram_rhs.launches == before
    assert torch.equal(Gw, Gp) and torch.equal(bw, bp)


def test_weighted_gram_rhs_rejects_bad_inputs():
    F, w, A = _wgram_operands(12)
    X = np.ones((5, 24), np.float32)
    with pytest.raises(ValueError):
        wgram.weighted_gram_rhs(_t(F), _t(X), _t(A), loss_kind="gp")
    with pytest.raises(ValueError):
        wgram.weighted_gram_rhs(_t(F), _t(X), _t(A), loss_kind="nb")
    with pytest.raises(ValueError):
        wgram.weighted_gram_rhs(_t(F), _t(X[:, :5]), _t(A), loss_kind="kl")
    with pytest.raises(TypeError):
        wgram.weighted_gram_rhs(_t(F).double(), _t(X), _t(A), loss_kind="kl")


# ---------------------------------------------------------------------------
# dispersion updates, ZI, initial state
# ---------------------------------------------------------------------------

def _recon(seed, m=40, n=30, k=4):
    rs = np.random.RandomState(seed)
    S = np.maximum(rs.gamma(1.0, 1.0, (m, k)) @ rs.gamma(1.0, 1.0, (k, n)),
                   1e-10).astype(np.float32)
    A = rs.poisson(S * rs.gamma(2.0, 0.5, S.shape)).astype(np.float32)
    A[rs.uniform(size=A.shape) < 0.3] = 0.0
    return A, S


@pytest.mark.parametrize("dispersion,axis", [("per_row", 1), ("per_col", 0),
                                             ("global", 1)])
def test_gp_theta_update(dispersion, axis):
    cfg, ref_cfg = _cfgs(loss="gp", dispersion=dispersion)
    A, S = _recon(0)
    th0 = np.full(A.shape[1 - axis], 0.1, np.float32)
    _close(nmf_irls.gp_theta_update(_t(A), _t(S), _t(th0), cfg, axis),
           ref_irls.gp_theta_update(_j(A), _j(S), _j(th0), ref_cfg, axis),
           rtol=1e-4)


@pytest.mark.parametrize("dispersion,axis", [("per_row", 1), ("per_col", 0),
                                             ("global", 1), ("global", 0)])
def test_nb_size_update(dispersion, axis):
    cfg, ref_cfg = _cfgs(loss="nb", dispersion=dispersion)
    A, S = _recon(1)
    _close(nmf_irls.nb_size_update(_t(A), _t(S), cfg, axis),
           ref_irls.nb_size_update(_j(A), _j(S), ref_cfg, axis), rtol=1e-4)


@pytest.mark.parametrize("loss", ["gamma", "inverse_gaussian", "tweedie"])
@pytest.mark.parametrize("dispersion,axis", [("per_row", 1), ("per_col", 0),
                                             ("global", 0)])
def test_phi_update(loss, dispersion, axis):
    cfg, ref_cfg = _cfgs(loss=loss, dispersion=dispersion)
    A, S = _recon(2)
    _close(nmf_irls.phi_update(_t(A), _t(S), cfg, axis),
           ref_irls.phi_update(_j(A), _j(S), ref_cfg, axis), rtol=1e-4)


@pytest.mark.parametrize("with_disp_col", [False, True])
@pytest.mark.parametrize("zi", ["row", "col"])
@pytest.mark.parametrize("loss", ["gp", "nb"])
def test_zi_em_step(loss, zi, with_disp_col):
    cfg, ref_cfg = _cfgs(loss=loss, zi=zi)
    A, S = _recon(3)
    m, n = A.shape
    rs = np.random.RandomState(4)
    disp_row = rs.uniform(0.05, 0.8, m).astype(np.float32)
    disp_col = rs.uniform(0.05, 0.8, n).astype(np.float32) \
        if with_disp_col else None
    pi_row = rs.uniform(0.05, 0.3, m).astype(np.float32)
    pi_col = rs.uniform(0.05, 0.3, n).astype(np.float32)
    port = nmf_irls.zi_em_step(
        _t(A), _t(S), cfg, _t(disp_row), _t(pi_row), _t(pi_col),
        disp_col=None if disp_col is None else _t(disp_col))
    ref = ref_irls.zi_em_step(
        _j(A), _j(S), ref_cfg, _j(disp_row), _j(pi_row), _j(pi_col),
        disp_col=None if disp_col is None else _j(disp_col))
    for p, r in zip(port, ref):
        _close(p, r, rtol=1e-4)
    assert float(port[0].min()) >= 0.001 and float(port[0].max()) <= 0.999


def test_zi_em_step_with_valid_mask():
    cfg, ref_cfg = _cfgs(loss="gp", zi="row")
    A, S = _recon(5)
    valid = np.random.RandomState(6).uniform(size=A.shape) < 0.8
    m, n = A.shape
    disp = np.full(m, 0.2, np.float32)
    pr, pc = np.full(m, 0.1, np.float32), np.full(n, 0.1, np.float32)
    port = nmf_irls.zi_em_step(_t(A), _t(S), cfg, _t(disp), _t(pr), _t(pc),
                               valid=torch.from_numpy(valid))
    ref = ref_irls.zi_em_step(_j(A), _j(S), ref_cfg, _j(disp), _j(pr), _j(pc),
                              valid=jnp.asarray(valid))
    for p, r in zip(port, ref):
        _close(p, r, rtol=1e-4)


@pytest.mark.parametrize("zi", ["none", "row", "col"])
def test_zi_pi_init(zi):
    cfg, ref_cfg = _cfgs(loss="gp", zi=zi)
    A, _ = _recon(7)
    for p, r in zip(nmf_irls._zi_pi_init(_t(A), cfg),
                    ref_irls._zi_pi_init(_j(A), ref_cfg)):
        _close(p, r)


@pytest.mark.parametrize("dispersion", ["per_row", "none"])
@pytest.mark.parametrize("loss", ["kl", "gp", "nb", "gamma", "tweedie"])
def test_init_dispersion(loss, dispersion):
    cfg, ref_cfg = _cfgs(loss=loss, dispersion=dispersion)
    for p, r in zip(nmf_irls._init_dispersion(cfg, 7, 5),
                    ref_irls._init_dispersion(ref_cfg, 7, 5, np.float32)):
        np.testing.assert_array_equal(p, r)


@pytest.mark.parametrize("n,k,m,kr", [(2638, 16, 13714, True),
                                      (13714, 16, 2638, True),
                                      (100000, 50, 3867, False),
                                      (5, 4, 10, True)])
def test_block_count(n, k, m, kr):
    assert nmf_irls._block_count(n, k, m, kr=kr) == \
        ref_irls._block_count(n, k, m, kr=kr)


# ---------------------------------------------------------------------------
# one IRLS solve from the same warm start
# ---------------------------------------------------------------------------

SOLVE_CASES = {
    "kl": dict(loss="kl"),
    "nb_theta_row": dict(loss="nb"),
    "nb_theta_col": dict(loss="nb"),
    "gamma": dict(loss="gamma"),
    "robust_mse": dict(loss="mse", robust_delta=1.345),
    "kl_sparse_zeros": dict(loss="kl"),
    "kl_G_add": dict(loss="kl"),
    "kl_target": dict(loss="kl"),
    "kl_L1_L2": dict(loss="kl"),
    "kl_cold": dict(loss="kl"),
}


@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_irls_solve_batch(case):
    cfg, ref_cfg = _cfgs(**SOLVE_CASES[case])
    rs = np.random.RandomState(13)
    k, m, n = 4, 50, 36
    F = rs.gamma(1.0, 1.0, (k, m)).astype(np.float32)
    X_true = rs.gamma(1.0, 1.0, (k, n)).astype(np.float32)
    A = rs.poisson(F.T @ X_true).astype(np.float32)
    if case == "gamma":
        A = A + rs.uniform(0.1, 1.0, A.shape).astype(np.float32)
    X_warm = None if case == "kl_cold" else \
        (X_true * rs.uniform(0.5, 1.5, X_true.shape)).astype(np.float32)
    th_row = rs.uniform(1.0, 30.0, m).astype(np.float32) \
        if case == "nb_theta_row" else None
    th_col = rs.uniform(1.0, 30.0, n).astype(np.float32) \
        if case == "nb_theta_col" else None
    fkw = {}
    G_add = target = None
    if case == "kl_G_add":
        M = rs.uniform(size=(k, k)).astype(np.float32)
        G_add = (M @ M.T * 0.1).astype(np.float32)
    if case == "kl_target":
        fkw["target_lambda"] = 0.5
        target = rs.uniform(size=(k, n)).astype(np.float32)
    if case == "kl_L1_L2":
        fkw.update(L1=0.05, L2=0.1)
    sparse_zeros = case == "kl_sparse_zeros"
    counts = {}
    port = nmf_irls.irls_solve_batch(
        _t(A), _t(F), cfg, cfg.loss, None if th_row is None else _t(th_row),
        None if th_col is None else _t(th_col), FactorConfig(**fkw),
        sparse_zeros, X_warm=None if X_warm is None else _t(X_warm),
        G_add=None if G_add is None else _t(G_add),
        target=None if target is None else _t(target), counts=counts)
    ref = ref_irls.irls_solve_batch(
        _j(A), _j(F), ref_cfg, ref_cfg.loss,
        None if th_row is None else _j(th_row),
        None if th_col is None else _j(th_col), RefFactorConfig(**fkw),
        sparse_zeros, X_warm=None if X_warm is None else _j(X_warm),
        G_add=None if G_add is None else _j(G_add),
        target=None if target is None else _j(target))
    assert port.shape == (k, n) and port.is_contiguous()
    assert 1 <= counts["inner_iters"] <= cfg.irls_max_iter
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)


def test_irls_solve_batch_does_not_depend_on_the_block_size(monkeypatch):
    cfg, _ = _cfgs(loss="kl")
    rs = np.random.RandomState(14)
    k, m, n = 4, 30, 41
    F = rs.gamma(1.0, 1.0, (k, m)).astype(np.float32)
    A = rs.poisson(F.T @ rs.gamma(1.0, 1.0, (k, n))).astype(np.float32)
    th = rs.uniform(1.0, 30.0, n).astype(np.float32)
    nb = dataclasses.replace(cfg, loss=type(cfg.loss)("nb"))
    whole = nmf_irls.irls_solve_batch(_t(A), _t(F), nb, nb.loss, None, _t(th),
                                      FactorConfig(), False)
    monkeypatch.setattr(nmf_irls, "_block_count", lambda *a, **kw: 8)
    blocks = nmf_irls.irls_solve_batch(_t(A), _t(F), nb, nb.loss, None,
                                       _t(th), FactorConfig(), False)
    np.testing.assert_allclose(blocks.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)
