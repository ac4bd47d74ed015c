"""Degenerate inputs and the CD kernels' launch plan, on the CPU.

The default (Cholesky) solver on rank-deficient data: a CPU tensor takes
``torch.linalg.cholesky_ex`` + ``cholesky_solve`` where LAPACK factors the
ridged Gram, bit for bit what ``torch.linalg.cholesky`` gave, and kernel 6's
twin where it does not, so no fit raises.  On these inputs a ridged fp32
Gram has a condition number of 1e7 to 1e8: every solver (LAPACK, XLA, the
twin, a float64 solve of the same fp32 Gram) returns a different solution
with the same 1e-7 backward error, and the port's and the JAX package's fits
part in the first iteration.  So the fits are held to what was recorded:
no exception, finite losses, the JAX package's own outcome (it gives NaN at
k = 60, where a failed XLA factorization is NaN), and on all-ones data a
loss within the fp32 cancellation floor of the JAX package's.

``fused_vmem=True`` past k = 138 (where the card moves the k x k section to
device memory) against the JAX package's ``_ns_als_xla`` at the
Newton-Schulz float32 bars of ``tests/test_torch_fused.py``: loss rtol 1e-4
+ 10 eps tr(A'A), W / d / H within 2e-3 of their largest entry.

:func:`plan_cd` of both CD kernels for every k from 1 to 300.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package runs on the CPU here)

import rcppml_tpu as rt

import rcppml_tpu_torch as rtt
from rcppml_tpu_torch.ops import cd_nnls, cd_nnls_batched
from rcppml_tpu_torch.ops import cholesky_clip as cc
from rcppml_tpu_torch.ops import solvers

EPS32 = float(np.finfo(np.float32).eps)


def _degenerate(kind):
    rs = np.random.default_rng(0)
    if kind == "rank1":
        return np.outer(rs.random(200), rs.random(150)).astype(np.float32)
    if kind == "rank3":
        return (rs.random((200, 3)) @ rs.random((3, 150))).astype(np.float32)
    return np.ones((200, 150), np.float32)


# (data, k): whether the JAX package's last loss is finite, as recorded
JAX_FINITE = {("rank1", 10): True, ("rank1", 60): False,
              ("rank3", 10): True, ("rank3", 60): False,
              ("ones", 10): True, ("ones", 60): False}


@pytest.mark.parametrize("kind,k", list(JAX_FINITE))
def test_default_solver_never_raises_on_rank_deficient_data(kind, k):
    A = _degenerate(kind)
    kw = dict(maxit=10, tol=0, seed=1)
    port = rtt.nmf(A, k, device="cpu", **kw)
    ref = rt.nmf(A, k, **kw)
    assert port.misc["config"].solver.name == "CHOLESKY"
    hist = np.asarray(port.loss_history)
    assert hist.shape == (10,) and np.isfinite(hist).all()
    for name in ("W", "d", "H"):
        assert np.isfinite(getattr(port, name)).all(), name
    assert bool(np.isfinite(np.asarray(ref.loss_history)[-1])) \
        == JAX_FINITE[(kind, k)]
    if kind == "ones" and JAX_FINITE[(kind, k)]:
        floor = 10 * EPS32 * float((A.astype(np.float64) ** 2).sum())
        assert abs(hist[-1] - float(ref.loss_history[-1])) <= floor


def _head_chol_solve(G, B):
    """The CPU solve before ``cholesky_ex``: it raised on a Gram that LAPACK
    finds not positive definite."""
    return torch.cholesky_solve(B, torch.linalg.cholesky(solvers._ridged(G)))


@pytest.mark.parametrize("k,n", [(5, 90), (20, 300), (64, 17)])
def test_positive_definite_solve_is_bitwise_the_linalg_solve(k, n):
    rs = np.random.RandomState(k + n)
    F = rs.rand(k, 3 * k).astype(np.float32)
    G = torch.from_numpy(F @ F.T)
    B = torch.from_numpy(rs.normal(size=(k, n)).astype(np.float32))
    assert int(torch.linalg.cholesky_ex(solvers._ridged(G))[1]) == 0
    assert torch.equal(solvers._chol_solve(G, B), _head_chol_solve(G, B))
    assert torch.equal(solvers.cholesky_clip_batch(G, B),
                       torch.clamp_min(_head_chol_solve(G, B), 0.0))


def test_positive_definite_fit_is_bitwise_the_linalg_fit(monkeypatch):
    from rcppml_tpu_torch.utils.simulate import simulate_nmf
    A = simulate_nmf(120, 90, 5, seed=8)["A"]
    kw = dict(maxit=8, tol=0, seed=1, device="cpu")
    res = rtt.nmf(A, 5, **kw)
    monkeypatch.setattr(solvers, "_chol_solve", _head_chol_solve)
    head = rtt.nmf(A, 5, **kw)
    np.testing.assert_array_equal(res.loss_history, head.loss_history)
    for name in ("W", "d", "H"):
        np.testing.assert_array_equal(getattr(res, name), getattr(head, name))


def test_a_gram_lapack_refuses_goes_to_the_twin():
    """Where LAPACK stops (info != 0) the CPU solve is kernel 6's twin on the
    ridged Gram, unclipped, then clipped: what the card computes."""
    G = torch.tensor([[1.0, 2.0, 0.0], [2.0, 1.0, 0.5], [0.0, 0.5, 3.0]])
    B = torch.tensor([[1.0, -2.0], [0.5, 1.0], [2.0, 0.0]])
    assert int(torch.linalg.cholesky_ex(solvers._ridged(G))[1]) != 0
    out = solvers.cholesky_clip_batch(G, B, nonneg=False)
    assert torch.isfinite(out).all()
    assert torch.equal(out, cc.cholesky_clip_plain(solvers._ridged(G), B,
                                                   nonneg=False))
    clipped = solvers.cholesky_clip_batch(G, B, upper_bound=0.3)
    assert torch.equal(clipped, cc.cholesky_clip_plain(
        solvers._ridged(G), B, upper_bound=0.3))


def test_a_pivot_that_is_not_positive_takes_the_diagonal_entry():
    """Kernel 6's rule: a pivot not above 1e-30 is replaced by G's own
    diagonal entry, or by 1e-30 where that is not above it either."""
    L = cc.cholesky_factor_plain(torch.tensor([[1.0, 2.0], [2.0, 1.0]]))
    # the Schur complement 1 - 4 = -3 is replaced by G[1, 1] = 1
    assert torch.equal(L, torch.tensor([[1.0, 0.0], [2.0, 1.0]]))
    L0 = cc.cholesky_factor_plain(torch.zeros((3, 3)))
    assert torch.equal(torch.diagonal(L0), torch.full(
        (3,), float(np.sqrt(np.float32(cc.PIVOT_FLOOR))), dtype=torch.float32))
    # a positive definite G never meets the rule
    G = torch.tensor([[4.0, 2.0], [2.0, 3.0]])
    assert torch.allclose(cc.cholesky_factor_plain(G),
                          torch.linalg.cholesky(G), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# fused_vmem beyond k = 138
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [139, 150])
def test_fused_vmem_past_the_shared_memory_of_one_block(k):
    A = np.random.default_rng(0).random((300, 200)).astype(np.float32)
    kw = dict(maxit=3, tol=0, seed=1, fused_vmem=True, sort_model=False)
    port = rtt.nmf(A, k, device="cpu", **kw)
    ref = rt.nmf(A, k, **kw)
    lp = np.asarray(port.loss_history, np.float64)
    lr = np.asarray(ref.loss_history, np.float64)
    assert lp.shape == lr.shape == (3,) and np.isfinite(lp).all()
    trAtA = float((A.astype(np.float64) ** 2).sum())
    assert np.all(np.abs(lp - lr) <= 1e-4 * np.abs(lr) + 10 * EPS32 * trAtA)
    for name in ("W", "d", "H"):
        p = np.asarray(getattr(port, name), np.float64)
        r = np.asarray(getattr(ref, name), np.float64)
        assert np.abs(p - r).max() <= 2e-3 * np.abs(r).max(), name


# ---------------------------------------------------------------------------
# The CD kernels' plan
# ---------------------------------------------------------------------------

NS = (1, 2, 33, 610, 2639, 13714, 50000, 10**6)


@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
def test_plan_cd_covers_every_k_and_n(batched):
    plan_cd = cd_nnls_batched.plan_cd if batched else cd_nnls.plan_cd
    busy = cd_nnls.BUSY_THREADS
    for k in range(1, 301):
        # the shortest chain: the smallest power of two >= k, at most 32
        widest = 1 << (min(k, 32) - 1).bit_length()
        for n in NS:
            p = plan_cd(k, n)
            assert (p.lanes, p.rows) == cd_nnls.lanes_rows(k, n)
            assert p.lanes in (1, 2, 4, 8, 16, 32) and p.lanes <= widest
            if k > 32 * cd_nnls.MAX_ROWS:
                # past 8 rows a lane: the loop variant, a warp a column
                assert p.rows == 0 and p.lanes == 32 and not p.gram_shared
                assert p.shared_bytes == (p.threads // 32) * 8 * k
            else:
                # rows in registers cover k, the fewest powers of two
                assert p.rows in (1, 2, 4, 8)
                assert p.lanes * p.rows >= k
                assert p.rows == 1 or p.lanes * p.rows // 2 < k
                # fewer lanes only where the columns keep the card busy
                # with them, and never past 8 rows a lane
                if p.lanes < widest:
                    assert n * p.lanes >= busy
                if p.lanes > 1 and n * (p.lanes // 2) >= busy:
                    assert -(-k // (p.lanes // 2)) > cd_nnls.MAX_ROWS
            assert p.threads % 32 == 0 and p.threads % p.lanes == 0
            assert 32 <= p.threads <= 512
            assert 0 <= p.shared_bytes <= cd_nnls.SHARED_OPTIN
            groups = p.threads // p.lanes
            assert p.blocks * groups >= n > (p.blocks - 1) * groups
            if p.rows and not p.gram_shared:
                assert p.shared_bytes == 0
            if p.gram_shared:
                per = 4 * k * (k | 1)
                assert p.shared_bytes == (groups * per if batched else per)
    # the routes at the main path's and the edge ks
    assert cd_nnls.plan_cd(241, 10).gram_shared
    assert not cd_nnls.plan_cd(242, 10).gram_shared
    assert not cd_nnls.plan_cd(256, 10).gram_shared
    assert cd_nnls_batched.plan_cd(83, 10).gram_shared
    assert not cd_nnls_batched.plan_cd(84, 10).gram_shared
    assert cd_nnls_batched.plan_cd(16, 2638) == cd_nnls.CDPlan(
        16, 1, 32, 2 * 4 * 16 * 17, True, 1319)
    # the main path's solves: the MSE CD fit's W side four columns a warp
    # and four rows a lane, its H side a warp a column; the KL fit's W side
    # four columns a warp
    assert cd_nnls.plan_cd(20, 13714)[:2] == (8, 4)
    assert cd_nnls.plan_cd(20, 2638)[:2] == (32, 1)
    assert cd_nnls.plan_cd(50, 3867)[:2] == (32, 2)
    assert cd_nnls_batched.plan_cd(16, 13714)[:2] == (8, 2)
    assert cd_nnls_batched.plan_cd(16, 2638)[:2] == (16, 1)
    with pytest.raises(ValueError, match="positive"):
        cd_nnls.plan_cd(0, 5)
    with pytest.raises(ValueError, match="positive"):
        cd_nnls_batched.plan_cd(5, 0)
