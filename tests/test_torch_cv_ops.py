"""The ops of the port's cross-validated and masked fits against the JAX
package's, on the CPU.

Inputs come from numpy seeds and go through both packages as numpy arrays.
Held here:

  * the position hash, the holdout mask and the 1-D subsample mask: bit for
    bit, on the host (numpy uint64) and in torch int64 arithmetic;
  * contractions (weighted Gram and RHS, the gathered downdate, the masked
    solves): 1e-5 of the largest entry (the two frameworks sum in other
    orders), 1e-4 for the solves of a Cholesky factorization;
  * the Cholesky solve + clip twin against the JAX package's
    ``cholesky_clip_batch``: the bar of the JAX package's own TPU test (rtol
    5e-3, atol 5e-4) and, tighter, 1e-4 of the largest entry.

The two TPU kernels that the port's kernels replace take no ``interpret=``;
here ``pl.pallas_call`` is wrapped with ``interpret=True`` inside the test, so
that they run on the CPU, and the port's twins are held against them too.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rcppml_tpu import rng as ref_rng
from rcppml_tpu.config import (FactorConfig as RefFactorConfig,
                               NMFConfig as RefNMFConfig, Solver as RefSolver)
from rcppml_tpu.models import nmf_cv as ref_cv
from rcppml_tpu.ops import linalg as ref_linalg
from rcppml_tpu.ops import pallas_experiments as ref_pallas
from rcppml_tpu.ops import solvers as ref_solvers

from rcppml_tpu_torch import convert, rng
from rcppml_tpu_torch.models import nmf_cv
from rcppml_tpu_torch.ops import cholesky_clip as cc
from rcppml_tpu_torch.ops import linalg, solvers
from rcppml_tpu_torch.ops import weighted_gram as wg5

SEEDS = [0, 1, 2**31, 2**63 + 5]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _j(x):
    return jnp.asarray(np.asarray(x, dtype=np.float32))


def _close(port, ref, tol=1e-5):
    """Within ``tol`` of the reference's largest entry."""
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert np.abs(port - ref).max() <= tol * max(np.abs(ref).max(), 1e-30)


# ---------------------------------------------------------------------------
# rng
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_position_hash_bitwise(seed):
    i = np.arange(37, dtype=np.uint32)[:, None]
    j = np.arange(29, dtype=np.uint32)[None, :] * 1000003
    np.testing.assert_array_equal(rng.position_hash(seed, i, j),
                                  ref_rng.position_hash(seed, i, j))


@pytest.mark.parametrize("inv_prob", [2, 10, 7, 0])
@pytest.mark.parametrize("seed", SEEDS)
def test_holdout_mask_bitwise(seed, inv_prob):
    ref = ref_rng.holdout_mask(seed, 61, 47, inv_prob)
    np.testing.assert_array_equal(rng.holdout_mask(seed, 61, 47, inv_prob),
                                  ref)
    on_device = rng.is_holdout(seed, 61, 47, inv_prob, "cpu")
    assert on_device.dtype == torch.bool
    np.testing.assert_array_equal(on_device.numpy(), ref)
    if inv_prob:
        assert 0 < ref.mean() < 1
    rows, cols = np.array([5, 3, 60]), np.array([0, 46])
    np.testing.assert_array_equal(
        rng.holdout_mask(seed, rows, cols, inv_prob),
        ref_rng.holdout_mask(seed, rows, cols, inv_prob))


@pytest.mark.parametrize("fraction", [0.1, 0.3, 0.15])
def test_is_holdout_matches_the_traced_hash(fraction, monkeypatch):
    """A 1 / fraction that is not an integer is floored, as the JAX fit's
    in-trace mask does; hashing in row chunks changes nothing."""
    inv_prob = int(1.0 / fraction)
    pair = jnp.asarray(ref_rng.seed_to_u32_pair(9))
    np.testing.assert_array_equal(rng.seed_to_u32_pair(9), np.asarray(pair))
    ii = jnp.arange(83, dtype=jnp.uint32)[:, None]
    jj = jnp.arange(51, dtype=jnp.uint32)[None, :]
    ref = np.asarray(ref_rng.is_holdout_traced(pair, ii, jj, inv_prob))
    np.testing.assert_array_equal(
        rng.is_holdout(9, 83, 51, inv_prob, "cpu").numpy(), ref)
    monkeypatch.setattr(rng, "_HASH_CHUNK_ELEMS", 200)
    np.testing.assert_array_equal(
        rng.is_holdout(9, 83, 51, inv_prob, "cpu").numpy(), ref)


@pytest.mark.parametrize("use_col_constant", [True, False])
@pytest.mark.parametrize("seed,frac", [(0, 0.5), (1, 0.25), (2**31, 0.9),
                                       (2**63 + 5, 0.5), (3, 1.0)])
def test_subsample_mask_bitwise(seed, frac, use_col_constant):
    np.testing.assert_array_equal(
        rng.subsample_mask_1d(seed, 200, frac, use_col_constant),
        ref_rng.subsample_mask_1d(seed, 200, frac, use_col_constant))


@pytest.mark.parametrize("kw", [
    dict(test_fraction=0.1, cv_seed=3),
    dict(test_fraction=0.3, cv_seed=0, mask_zeros=True),
    dict(test_fraction=0.2, cv_seed=7, cv_row_subsample=0.5,
         cv_col_subsample=0.6)], ids=["plain", "mask_zeros", "subsampled"])
def test_build_speckled_mask_matches_reference(kw):
    rs = np.random.RandomState(0)
    A = (rs.rand(70, 50) * (rs.rand(70, 50) < 0.6)).astype(np.float32)
    ref_cfg = RefNMFConfig(rank=3, **kw)
    np.testing.assert_array_equal(
        nmf_cv.build_speckled_mask(convert.config_from_reference(ref_cfg), A),
        ref_cv.build_speckled_mask(ref_cfg, A))


# ---------------------------------------------------------------------------
# Weighted Gram + RHS (kernel 5's twin) and the gathered downdate
# ---------------------------------------------------------------------------

def _wg_inputs(k, m, bc, real, seed=0):
    rs = np.random.RandomState(seed)
    F = (np.abs(rs.normal(size=(k, m))) * (rs.rand(k, m) < 0.7)).astype(
        np.float32)
    w = (rs.uniform(0, 2, size=(m, bc)) if real
         else rs.rand(m, bc) >= 0.2).astype(np.float32)
    A = rs.poisson(0.8, size=(m, bc)).astype(np.float32)
    return F, w, A


@pytest.mark.parametrize("real", [False, True], ids=["01", "real"])
@pytest.mark.parametrize("k,m,bc", [(1, 40, 1), (5, 200, 1), (12, 150, 33),
                                    (9, 77, 200)])
def test_weighted_gram_twin_matches_reference(k, m, bc, real):
    F, w, A = _wg_inputs(k, m, bc, real, seed=k + bc)
    Gr, br = ref_linalg.weighted_gram_and_rhs(_j(F), _j(w), _j(A))
    for Gb, b in (wg5.weighted_gram_plain(_t(F), _t(w), _t(A)),
                  wg5.weighted_gram(_t(F), _t(w), _t(A))):
        assert Gb.shape == (bc, k, k) and b.shape == (k, bc)
        _close(Gb, Gr)
        _close(b, br)
    np.testing.assert_allclose(
        Gb.numpy(), np.einsum("im,mj,lm->jil", F, w, F), rtol=1e-5,
        atol=1e-5 * float(np.abs(np.asarray(Gr)).max()))


def test_weighted_gram_and_rhs_reaches_the_twin_beyond_the_kr_budget(
        monkeypatch):
    """The branch that runs when the Khatri-Rao operand does not fit is the
    kernel's wrapper, which on a CPU tensor is the twin; the Khatri-Rao
    branch gives the same Grams."""
    F, w, A = _wg_inputs(6, 90, 14, True)
    calls = []
    real_twin = wg5.weighted_gram_plain
    monkeypatch.setattr(wg5, "weighted_gram_plain",
                        lambda *a: calls.append(1) or real_twin(*a))
    within = linalg.weighted_gram_and_rhs(_t(F), _t(w), _t(A))
    assert not calls
    monkeypatch.setattr(linalg, "KR_BUDGET_FLOATS", 6 * 6 * 90 - 1)
    beyond = linalg.weighted_gram_and_rhs(_t(F), _t(w), _t(A))
    assert calls == [1]
    # a precomputed Khatri-Rao operand still takes the Khatri-Rao branch
    given = linalg.weighted_gram_and_rhs(_t(F), _t(w), _t(A),
                                         KR=linalg.kr_product(_t(F)))
    assert calls == [1]
    for a, b_, c in zip(within, beyond, given):
        _close(b_, a.numpy())
        assert torch.equal(a, c)
    # column blocks of a wider matrix, as the masked solve passes them
    part = linalg.weighted_gram_and_rhs(_t(F), _t(w)[:, 3:9], _t(A)[:, 3:9])
    _close(part[0], beyond[0][3:9].numpy())
    _close(part[1], beyond[1][:, 3:9].numpy())


def test_weighted_gram_twin_matches_the_tpu_kernel_interpreted(monkeypatch):
    """``weighted_gram_pallas`` run on the CPU through the interpreter."""
    monkeypatch.setattr(ref_pallas.pl, "pallas_call", functools.partial(
        ref_pallas.pl.pallas_call, interpret=True))
    F, w, A = _wg_inputs(12, 100, 5, True, seed=2)
    Gr, br = ref_pallas.weighted_gram_pallas.__wrapped__(
        _j(F), _j(w), _j(A), tc=8, mt=128)
    Gb, b = wg5.weighted_gram(_t(F), _t(w), _t(A))
    _close(Gb, Gr)
    _close(b, br)


def test_weighted_gram_refuses_bad_operands():
    F, w, A = (_t(x) for x in _wg_inputs(4, 30, 5, True))
    with pytest.raises(ValueError, match="do not fit"):
        wg5.weighted_gram(F, w[:-1], A)
    with pytest.raises(ValueError, match="do not fit"):
        wg5.weighted_gram(F, w, A[:, :-1])
    with pytest.raises(TypeError, match="float32"):
        wg5.weighted_gram(F, w.double(), A)


@pytest.mark.parametrize("k,m,T,bc", [(4, 50, 7, 9), (10, 120, 1, 30)])
def test_gathered_gram_downdate_matches_reference(k, m, T, bc):
    rs = np.random.RandomState(T)
    F = np.abs(rs.normal(size=(k, m))).astype(np.float32)
    idx = rs.randint(0, m, size=(T, bc))
    val = (rs.rand(T, bc) < 0.7).astype(np.float32)
    ref = ref_linalg.gathered_gram_downdate(_j(F), jnp.asarray(idx), _j(val))
    port = linalg.gathered_gram_downdate(_t(F), torch.from_numpy(idx),
                                         _t(val))
    _close(port, ref)


def test_downdate_equals_the_weighted_gram_of_a_01_mask():
    rs = np.random.RandomState(1)
    F = _t(np.abs(rs.normal(size=(5, 60))))
    train = _t(rs.rand(60, 11) >= 0.15)
    idx, val = nmf_cv._excl_indices(train, 25)
    full = F @ F.T
    Gb, _ = wg5.weighted_gram_plain(F, train, torch.zeros_like(train))
    _close(full[None] - linalg.gathered_gram_downdate(F, idx, val),
           Gb.numpy(), tol=1e-5)


@pytest.mark.parametrize("t_max", [3, 12, 40])
def test_excl_indices_matches_reference(t_max):
    rs = np.random.RandomState(t_max)
    train = (rs.rand(40, 17) >= 0.2).astype(np.float32)
    train[:, 3] = 1.0                       # a column with nothing excluded
    ref_idx, ref_val = ref_cv._excl_indices(_j(train), t_max)
    idx, val = nmf_cv._excl_indices(_t(train), t_max)
    np.testing.assert_array_equal(val.numpy(), np.asarray(ref_val))
    # where a slot is valid the row index is the reference's
    keep = np.asarray(ref_val) > 0
    np.testing.assert_array_equal(idx.numpy()[keep], np.asarray(ref_idx)[keep])


def test_rank_ridge_matches_reference():
    rs = np.random.RandomState(0)
    F = rs.normal(size=(7, 6, 9)).astype(np.float32)
    Gb = np.einsum("bkm,blm->bkl", F, F)
    Gb[2] = 0.0                             # a column with no train entries
    ref = ref_cv._rank_ridge(_j(Gb), jnp.eye(6, dtype=jnp.float32))
    port = nmf_cv._rank_ridge(_t(Gb), torch.eye(6))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-30)


# ---------------------------------------------------------------------------
# Cholesky solve + clip (kernel 6's twin)
# ---------------------------------------------------------------------------

def _spd(k, n, seed, ridge=1e-3):
    rs = np.random.RandomState(seed)
    F = np.abs(rs.normal(size=(k, max(2 * k, 16)))).astype(np.float32)
    G = (F @ F.T + ridge * np.eye(k)).astype(np.float32)
    B = rs.normal(size=(k, n)).astype(np.float32)
    return G, B


@pytest.mark.parametrize("nonneg,ub", [(True, 0.0), (False, 0.0),
                                       (True, 0.05), (False, 0.05)])
@pytest.mark.parametrize("k,n", [(1, 1), (2, 50), (12, 1), (12, 200),
                                 (24, 200)])
def test_cholesky_clip_twin_matches_reference(k, n, nonneg, ub):
    """Both add their ridge inside ``cholesky_clip_batch``; the twin gets the
    port's ridged Gram, as the card's route gives it to the kernel."""
    G, B = _spd(k, n, seed=9 + k)
    ref = np.asarray(ref_solvers.cholesky_clip_batch(
        _j(G), _j(B), nonneg=nonneg, upper_bound=ub))
    twin = cc.cholesky_clip_plain(solvers._ridged(_t(G)), _t(B),
                                  nonneg=nonneg, upper_bound=ub)
    wrapper = cc.cholesky_clip(solvers._ridged(_t(G)), _t(B), nonneg=nonneg,
                               upper_bound=ub)
    assert torch.equal(twin, wrapper)          # a CPU tensor takes the twin
    np.testing.assert_allclose(twin.numpy(), ref, rtol=5e-3, atol=5e-4)
    _close(twin, ref, tol=1e-4)
    # and the port's own CPU route (torch.linalg) agrees with the twin
    _close(solvers.cholesky_clip_batch(_t(G), _t(B), nonneg=nonneg,
                                       upper_bound=ub), twin.numpy(),
           tol=1e-4)


@pytest.mark.parametrize("k", [1, 3, 17])
def test_cholesky_factor_twin_is_the_cholesky_factor(k):
    G, _ = _spd(k, 1, seed=k)
    L = cc.cholesky_factor_plain(_t(G))
    assert torch.equal(L, torch.tril(L))
    _close(L, np.linalg.cholesky(G.astype(np.float64)), tol=1e-5)
    # only the lower triangle of G is read
    G_upper_noise = G + np.triu(np.ones_like(G), 1)
    assert torch.equal(cc.cholesky_factor_plain(_t(G_upper_noise)), L)


def test_cholesky_clip_twin_matches_the_tpu_kernel_interpreted(monkeypatch):
    """``cholesky_clip_pallas`` run on the CPU through the interpreter."""
    monkeypatch.setattr(ref_pallas.pl, "pallas_call", functools.partial(
        ref_pallas.pl.pallas_call, interpret=True))
    G, B = _spd(12, 37, seed=4)
    for nonneg, ub in ((True, 0.0), (False, 0.02)):
        ref = ref_pallas.cholesky_clip_pallas.__wrapped__(
            _j(G), _j(B), nonneg=nonneg, upper_bound=ub)
        _close(cc.cholesky_clip(_t(G), _t(B), nonneg=nonneg, upper_bound=ub),
               ref, tol=1e-5)


def test_cholesky_clip_floors_a_pivot_that_is_not_positive():
    """Where ``torch.linalg.cholesky`` raises, the twin (and the kernel)
    floor the pivot at 1e-30: finite, no exception."""
    G, B = torch.zeros((4, 4)), torch.ones((4, 3))
    with pytest.raises(Exception):
        torch.linalg.cholesky(G)
    out = cc.cholesky_clip(G, B)
    assert torch.isfinite(out).all()
    indefinite = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    assert torch.isfinite(cc.cholesky_clip(indefinite, torch.ones((2, 2)),
                                           nonneg=False)).all()
    # a rank-deficient Gram is solvable once the fit's ridge is on it
    F = torch.from_numpy(np.random.RandomState(0).normal(
        size=(8, 3)).astype(np.float32))
    X = cc.cholesky_clip(solvers._ridged(F @ F.T), torch.ones((8, 5)))
    assert torch.isfinite(X).all()


def test_cholesky_clip_refuses_bad_operands():
    with pytest.raises(ValueError, match="do not fit"):
        cc.cholesky_clip(torch.eye(3), torch.ones((4, 2)))
    with pytest.raises(TypeError, match="float32"):
        cc.cholesky_clip(torch.eye(3, dtype=torch.float64), torch.ones((3, 2)))


# ---------------------------------------------------------------------------
# The masked solves
# ---------------------------------------------------------------------------

def _solve_case(seed, k=5, m=60, n=40):
    rs = np.random.RandomState(seed)
    F = np.abs(rs.normal(size=(k, m))).astype(np.float32)
    A = (np.abs(rs.normal(size=(m, n))) * (rs.rand(m, n) < 0.7)).astype(
        np.float32)
    train = (rs.rand(m, n) >= 0.15).astype(np.float32)
    X_warm = np.abs(rs.normal(size=(k, n))).astype(np.float32)
    G_add = np.diag(rs.uniform(0.0, 0.3, size=k)).astype(np.float32)
    target = np.abs(rs.normal(size=(k, n))).astype(np.float32)
    return F, A, train, X_warm, G_add, target


SOLVE_CASES = {
    "plain": dict(),
    "L1": dict(L1=0.05),
    "L2": dict(L2=0.3),
    "L1_L2": dict(L1=0.02, L2=0.1),
    "G_add": dict(use_G_add=True),
    "target": dict(target_lambda=0.4),
    "signed": dict(nonneg=False),
    "all": dict(L1=0.02, L2=0.1, use_G_add=True, target_lambda=0.2),
}


def _solve_configs(solver, kw):
    kw = {key: val for key, val in kw.items() if key != "use_G_add"}
    ref_fc = RefFactorConfig(**kw)
    ref_cfg = RefNMFConfig(rank=5, solver=RefSolver[solver], H=ref_fc)
    cfg = convert.config_from_reference(ref_cfg)
    return cfg, cfg.H, ref_cfg, ref_fc


@pytest.mark.parametrize("case", list(SOLVE_CASES))
@pytest.mark.parametrize("solver", ["CHOLESKY", "CD"])
def test_masked_mse_solve_batch_matches_reference(solver, case, monkeypatch):
    kw = SOLVE_CASES[case]
    F, A, train, X_warm, G_add, target = _solve_case(3)
    cfg, fc, ref_cfg, ref_fc = _solve_configs(solver, kw)
    G_add = G_add if kw.get("use_G_add") else None
    target = target if kw.get("target_lambda") else None
    ref = ref_cv.masked_mse_solve_batch(
        _j(A), _j(F), _j(train), ref_cfg, ref_fc, _j(X_warm),
        G_add=None if G_add is None else _j(G_add),
        target=None if target is None else _j(target))

    def port():
        return nmf_cv.masked_mse_solve_batch(
            _t(A), _t(F), _t(train), cfg, fc, _t(X_warm),
            G_add=None if G_add is None else _t(G_add),
            target=None if target is None else _t(target))

    # a Cholesky solve divides by pivots: 1e-4; the CD solve stops on a
    # tolerance of 1e-8 per sweep, a few 1e-6 of the largest entry
    tol = 1e-4 if solver == "CHOLESKY" else 1e-5
    whole = port()
    _close(whole, ref, tol=tol)
    # column blocks change no column: a block size of 8 gives five blocks,
    # and beyond the Khatri-Rao budget the twin of the kernel serves them
    monkeypatch.setattr(nmf_cv, "_block_count", lambda *a, **k: 8)
    _close(port(), whole.numpy(), tol=tol)
    monkeypatch.setattr(linalg, "KR_BUDGET_FLOATS", 1.0)
    _close(port(), whole.numpy(), tol=tol)


@pytest.mark.parametrize("case", ["plain", "L1", "L2", "target", "all"])
@pytest.mark.parametrize("solver", ["CHOLESKY", "CD"])
def test_masked_downdate_solve_batch_matches_reference(solver, case):
    kw = SOLVE_CASES[case]
    F, A, train, X_warm, G_add, target = _solve_case(5)
    cfg, fc, ref_cfg, ref_fc = _solve_configs(solver, kw)
    target = target if kw.get("target_lambda") else None
    k = F.shape[0]
    G_feat = F @ F.T + (1e-15 + kw.get("L2", 0.0)) * np.eye(k, dtype=np.float32)
    if kw.get("use_G_add"):
        G_feat = G_feat + G_add
    if target is not None:
        G_feat = G_feat + kw["target_lambda"] * np.eye(k, dtype=np.float32)
    B_full = F @ (train * A)
    t_max = int((train == 0).sum(axis=0).max())
    ref_idx, ref_val = ref_cv._excl_indices(_j(train), t_max)
    ref = ref_cv.masked_downdate_solve_batch(
        _j(B_full), _j(F), _j(G_feat), ref_idx, ref_val, ref_cfg, ref_fc,
        _j(X_warm), target=None if target is None else _j(target))
    idx, val = nmf_cv._excl_indices(_t(train), t_max)
    port = nmf_cv.masked_downdate_solve_batch(
        _t(B_full), _t(F), _t(G_feat), idx, val, cfg, fc, _t(X_warm),
        target=None if target is None else _t(target))
    tol = 1e-4 if solver == "CHOLESKY" else 1e-5
    _close(port, ref, tol=tol)
    # and the downdate is the weighted solve of the same 0/1 mask
    weighted = nmf_cv.masked_mse_solve_batch(
        _t(A), _t(F), _t(train), cfg, fc, _t(X_warm),
        G_add=_t(G_add) if kw.get("use_G_add") else None,
        target=None if target is None else _t(target))
    _close(port, weighted.numpy(), tol=2e-4)
