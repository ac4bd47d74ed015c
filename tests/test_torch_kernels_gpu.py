"""The CUDA kernels against their plain twins, on the card.

Every test here needs a CUDA card with compute capability 9.0 and skips
without one.  The file imports no JAX, so it runs on a machine that has none:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \\
        tests/test_torch_kernels_gpu.py

Parity contract: the two CD kernels round each operation as PyTorch's eager
twins do (no FMA contraction, IEEE division), so their results are bitwise
equal.  The fused weight + Gram + RHS kernel sums over m in another order
than the twin's cuBLAS products, and is held within 1e-4 of the twin's
largest entry; two launches on the same inputs are bitwise equal.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    from rcppml_tpu_torch.device import kernels_available, set_fp32_precision
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if not kernels_available():
        pytest.skip("the kernels are built for sm_90a (compute capability 9.0)")
    set_fp32_precision()
    return torch.device("cuda")


def _system(k, n, seed, device, dead=False):
    rs = np.random.RandomState(seed)
    p = max(2 * k, 64)
    F = np.abs(rs.normal(size=(k, p))).astype(np.float32)
    if dead:
        F[k // 2] = 0.0
    Y = (np.abs(rs.normal(size=(p, n)))
         * (rs.uniform(size=(p, n)) < 0.3)).astype(np.float32)
    G = F @ F.T
    X0 = np.abs(rs.normal(size=(k, n))).astype(np.float32)
    B_res = (F @ Y - G @ X0).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (G, B_res, X0)]


@pytest.mark.parametrize("k,n,l1,ub,dead", [
    (8, 610, 0.0, 0.0, False),
    (20, 2638, 0.25, 0.0, False),
    (50, 610, 0.0, 0.0, True),
    (100, 700, 0.25, 2.0, False),
    (128, 300, 0.0, 0.0, False),     # G above 48 KB of shared memory
    (256, 200, 0.0, 0.0, False),     # G read through the read-only cache
])
def test_kernel_matches_plain_bitwise(cuda, k, n, l1, ub, dead):
    from rcppml_tpu_torch.ops import cd_nnls
    G, B_res, X0 = _system(k, n, k + n, cuda, dead=dead)
    before = cd_nnls.cd_nnls_shared.launches
    out = cd_nnls.cd_nnls_shared(G, B_res, X0, l1, 5e-6, nonneg=True,
                                 maxit=100, upper_bound=ub)
    torch.cuda.synchronize()
    assert cd_nnls.cd_nnls_shared.launches == before + 1
    plain = cd_nnls.cd_nnls_shared_plain(G, B_res, X0, l1, 5e-6, nonneg=True,
                                         maxit=100, upper_bound=ub)
    assert (out > 0).any()
    assert torch.equal(out, plain)
    if dead:
        assert torch.equal(out[k // 2], X0[k // 2])


def test_cd_fit_launches_the_kernel_twice_per_iteration(cuda, monkeypatch):
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.ops import cd_nnls, solvers
    from rcppml_tpu_torch.utils.simulate import simulate_nmf
    A = torch.from_numpy(simulate_nmf(400, 300, 8, seed=1)["A"]).to(cuda)
    before = cd_nnls.cd_nnls_shared.launches
    res = rtt.nmf(A, 8, solver="cd", maxit=6, tol=0, seed=1)
    assert cd_nnls.cd_nnls_shared.launches == before + 2 * 6
    monkeypatch.setattr(solvers, "cd_nnls_shared",
                        cd_nnls.cd_nnls_shared_plain)
    plain = rtt.nmf(A, 8, solver="cd", maxit=6, tol=0, seed=1)
    np.testing.assert_array_equal(res.loss_history, plain.loss_history)


def _batched_system(k, n, seed, device, dead=False):
    """One Gram per column, G_j = F diag(w_j) F^T, in residual form."""
    from rcppml_tpu_torch.ops import linalg, solvers
    rs = np.random.RandomState(seed)
    p = max(2 * k, 64)
    F = np.abs(rs.normal(size=(k, p))).astype(np.float32)
    if dead:
        F[k // 2] = 0.0
    w = rs.uniform(0.2, 2.0, size=(p, n)).astype(np.float32)
    Y = (np.abs(rs.normal(size=(p, n)))
         * (rs.uniform(size=(p, n)) < 0.3)).astype(np.float32)
    X0 = np.abs(rs.normal(size=(k, n))).astype(np.float32)
    F, w, Y, X0 = (torch.from_numpy(a).to(device) for a in (F, w, Y, X0))
    Gb, b = linalg.weighted_gram_and_rhs(F, w, Y)
    return Gb, b - solvers.batched_gram_matvec(Gb, X0), X0


@pytest.mark.parametrize("k,n,l1,ub,dead", [
    (8, 610, 0.0, 0.0, False),
    (16, 2638, 0.25, 0.0, False),
    (20, 13714, 0.0, 0.0, False),
    (50, 610, 0.0, 0.0, True),
    (100, 700, 0.25, 2.0, False),
    (16, 33, 0.0, 0.0, False),       # one full warp and one thread
])
def test_batched_kernel_matches_plain_bitwise(cuda, k, n, l1, ub, dead):
    from rcppml_tpu_torch.ops import cd_nnls_batched as cdb
    Gb, B_res, X0 = _batched_system(k, n, k + n, cuda, dead=dead)
    before = cdb.cd_nnls_batched.launches
    out = cdb.cd_nnls_batched(Gb, B_res, X0, l1, 5e-6, nonneg=True,
                              maxit=100, upper_bound=ub)
    torch.cuda.synchronize()
    assert cdb.cd_nnls_batched.launches == before + 1
    plain = cdb.cd_nnls_batched_plain(Gb, B_res, X0, l1, 5e-6, nonneg=True,
                                      maxit=100, upper_bound=ub)
    assert (out > 0).any()
    assert torch.equal(out, plain)
    if dead:
        assert torch.equal(out[k // 2], X0[k // 2])


@pytest.mark.parametrize("sparse_zeros", [False, True])
@pytest.mark.parametrize("kind,power,theta", [
    ("kl", 0.0, None), ("power", 2.0, None), ("power", 3.0, None),
    ("power", 1.5, None), ("nb", 0.0, "row"), ("nb", 0.0, "col")])
def test_wgram_kernel_matches_plain(cuda, kind, power, theta, sparse_zeros):
    from rcppml_tpu_torch.ops import wgram
    k, m, bc = 20, 1501, 333                     # no multiple of any tile
    rs = np.random.RandomState(m + bc)
    F = torch.from_numpy(np.abs(rs.normal(size=(k, m))).astype(
        np.float32)).to(cuda)
    X = torch.from_numpy((np.abs(rs.normal(size=(k, bc))) / k).astype(
        np.float32)).to(cuda)
    A = torch.from_numpy(rs.poisson(0.4, size=(m, bc)).astype(
        np.float32)).to(cuda)
    th = torch.from_numpy(rs.uniform(0.05, 50.0, size=(
        m if theta == "row" else bc,)).astype(np.float32)).to(cuda)
    args = (F, X, A, th if theta == "row" else None,
            th if theta == "col" else None)
    kw = dict(loss_kind=kind, power=power, sparse_zeros=sparse_zeros)
    before = wgram.weighted_gram_rhs.launches
    Gb, b = wgram.weighted_gram_rhs(*args, **kw)
    Gb2, b2 = wgram.weighted_gram_rhs(*args, **kw)
    torch.cuda.synchronize()
    assert wgram.weighted_gram_rhs.launches == before + 2
    assert torch.equal(Gb, Gb2) and torch.equal(b, b2)
    Gp, bp = wgram.weighted_gram_rhs_plain(*args, **kw)
    assert float((Gb - Gp).abs().max()) <= 1e-4 * float(Gp.abs().max())
    assert float((b - bp).abs().max()) <= 1e-4 * float(bp.abs().max())


def test_wgram_kernel_beyond_128_factors(cuda):
    """k > 128 takes a second slab of Gram columns (grid z)."""
    from rcppml_tpu_torch.ops import wgram
    k, m, bc = 150, 300, 70
    rs = np.random.RandomState(0)
    F = torch.from_numpy(np.abs(rs.normal(size=(k, m))).astype(
        np.float32)).to(cuda)
    X = torch.from_numpy((np.abs(rs.normal(size=(k, bc))) / k).astype(
        np.float32)).to(cuda)
    A = torch.from_numpy(rs.poisson(0.4, size=(m, bc)).astype(
        np.float32)).to(cuda)
    Gb, b = wgram.weighted_gram_rhs(F, X, A, loss_kind="kl")
    Gp, bp = wgram.weighted_gram_rhs_plain(F, X, A, loss_kind="kl")
    assert float((Gb - Gp).abs().max()) <= 1e-4 * float(Gp.abs().max())
    assert float((b - bp).abs().max()) <= 1e-4 * float(bp.abs().max())


def test_kl_fit_launches_the_batched_kernel_once_per_inner_iteration(
        cuda, monkeypatch):
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.ops import cd_nnls_batched as cdb
    from rcppml_tpu_torch.ops import solvers, wgram
    from rcppml_tpu_torch.utils.simulate import simulate_counts
    A = simulate_counts(400, 300, 8, scale=0.25, seed=1)["A"]
    monkeypatch.delenv("RCPPML_FUSED_WGRAM", raising=False)
    before = cdb.cd_nnls_batched.launches, wgram.weighted_gram_rhs.launches
    # a host array with no device= goes to the card
    res = rtt.nmf(A, 8, loss="kl", maxit=4, tol=0, seed=1)
    inner = res.misc["irls_inner_iterations"]
    assert 8 <= inner <= 40
    assert cdb.cd_nnls_batched.launches == before[0] + inner
    assert wgram.weighted_gram_rhs.launches == before[1]

    monkeypatch.setenv("RCPPML_FUSED_WGRAM", "1")
    fused = rtt.nmf(A, 8, loss="kl", maxit=4, tol=0, seed=1)
    assert wgram.weighted_gram_rhs.launches == \
        before[1] + fused.misc["irls_inner_iterations"]
    np.testing.assert_allclose(fused.loss_history, res.loss_history,
                               rtol=1e-3)
    monkeypatch.delenv("RCPPML_FUSED_WGRAM")

    monkeypatch.setattr(solvers, "cd_nnls_batched", cdb.cd_nnls_batched_plain)
    plain = rtt.nmf(A, 8, loss="kl", maxit=4, tol=0, seed=1)
    np.testing.assert_array_equal(res.loss_history, plain.loss_history)
