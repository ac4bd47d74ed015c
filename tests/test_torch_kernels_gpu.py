"""The CUDA kernels against their plain twins, on the card.

Every test here needs a CUDA card with compute capability 9.0 and skips
without one.  The file imports no JAX, so it runs on a machine that has none:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \\
        tests/test_torch_kernels_gpu.py

Parity contract: the two CD kernels round each operation as PyTorch's eager
twins do (no FMA contraction, IEEE division), so their results are bitwise
equal.  The fused weight + Gram + RHS kernel (kernel 5's tile, the weight
formed in a prologue) sums mu in float32 and the Gram and RHS over m in
3xTF32, in another order than the twin's cuBLAS products, and is held
within 1e-4 of the twin's largest entry, with one split of m and several,
F's rows staged and read from device memory; two launches on the same
inputs are bitwise equal.  The two
tall-skinny products sum in another order than cuBLAS and are held within
1e-5 of the twin's largest entry; the whole-fit kernel within 1e-4 of its twin
after one iteration in float32 (H also with bfloat16 data; W and d, which see
H rounded to bfloat16, within 2^-7) and within 1e-3 in loss after twenty
(1e-2 with bfloat16 data, whose rounding flips ALS amplifies at these small
sizes).  All three repeat bit for bit.  The per-column weighted Gram + RHS
kernel sums over m in a fixed order (3xTF32 products on the tensor cores, the
splits' partials added in index order) and is held within 2e-5 of its twin's
largest entry; the Cholesky solve + clip kernel keeps its twin's order of operations
with ``_rn`` intrinsics and equals it bit for bit on both routes (one launch
with a lane group per column up to k = 64, two kernels beyond) and at every
group width the plan can take.  The rank-2 clustering on the card equals the
CPU port's split and tree on planted groups; checkpointed fits on the card
are the uninterrupted fit bit for bit, with its kernel launches.  A
``.spz`` stream on the card holds to the same stream on the CPU port, and
its wire-cached run to its uncached one within 1e-5; its sparse panels are
densified by the COO densify kernel, which equals its twin bit for bit at
the hcabm40k stream's panel shapes and at its edges, and with the dense
cache its transposed panels are built from the forward ones by the
transposed-panel kernel, bit for bit its twin at those shapes and the
decoded stream's fit.  The graph engine's
outer ALS on the card holds to the same net on the CPU (loss 1e-4,
factors 1e-2 of the largest entry), with kernels 6 and 1 bitwise their
twins at its deep layer's shapes, and a multi-modal fit is the stacked
matrix's fit bit for bit.
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


# the lane-group design's edges (csrc/cd_nnls.cuh): one lane, a group of 16
# (two columns a warp) and one past it, one warp, one and two registers of
# rows a lane; one column, one warp of columns and one past it
CD_EDGES = [(k, n, l1, ub, dead) for k in (1, 2, 15, 16, 17, 31, 32, 33, 64,
                                           65)
            for n, l1, ub, dead in ((1, 0.0, 0.0, False),
                                    (33, 0.25, 2.0, True),
                                    (2639, 0.0, 0.0, False))]


@pytest.mark.parametrize("k,n,l1,ub,dead", [
    (8, 610, 0.0, 0.0, False),
    (20, 2638, 0.25, 0.0, False),
    (20, 13714, 0.25, 2.0, True),    # 8 lanes a column, 4 rows a lane
    (50, 610, 0.0, 0.0, True),
    (100, 700, 0.25, 2.0, False),
    (128, 300, 0.0, 0.0, False),     # G above 48 KB of shared memory
    (241, 100, 0.0, 0.0, False),     # the largest G in shared memory
    (256, 200, 0.0, 0.0, False),     # G read from device memory
    (300, 70, 0.25, 2.0, True),      # past 8 rows a lane: the loop variant
] + CD_EDGES)
def test_kernel_matches_plain_bitwise(cuda, k, n, l1, ub, dead):
    from rcppml_tpu_torch.ops import cd_nnls
    G, B_res, X0 = _system(k, n, k + n, cuda, dead=dead)
    before = cd_nnls.cd_nnls_shared.launches
    out = cd_nnls.cd_nnls_shared(G, B_res, X0, l1, 5e-6, nonneg=True,
                                 maxit=100, upper_bound=ub)
    again = cd_nnls.cd_nnls_shared(G, B_res, X0, l1, 5e-6, nonneg=True,
                                   maxit=100, upper_bound=ub)
    torch.cuda.synchronize()
    assert cd_nnls.cd_nnls_shared.launches == before + 2
    plain = cd_nnls.cd_nnls_shared_plain(G, B_res, X0, l1, 5e-6, nonneg=True,
                                         maxit=100, upper_bound=ub)
    assert (out > 0).any() or (dead and k == 1)
    assert torch.equal(out, plain)
    assert torch.equal(out, again)
    if dead:
        # its step is 0: it keeps its warm start, moved onto the bound where
        # it lies above it (x + (ub - x) may round a last bit off)
        x0 = X0[k // 2]
        if ub == 0:
            assert torch.equal(out[k // 2], x0)
        else:
            torch.testing.assert_close(out[k // 2], x0.clamp(max=ub),
                                       rtol=1e-6, atol=0)


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
    (83, 200, 0.0, 0.0, False),      # the largest Gram in shared memory
    (84, 200, 0.25, 2.0, True),      # Grams read from device memory
    (300, 40, 0.0, 0.0, False),      # past 8 rows a lane: the loop variant
] + CD_EDGES)
def test_batched_kernel_matches_plain_bitwise(cuda, k, n, l1, ub, dead):
    from rcppml_tpu_torch.ops import cd_nnls_batched as cdb
    Gb, B_res, X0 = _batched_system(k, n, k + n, cuda, dead=dead)
    before = cdb.cd_nnls_batched.launches
    out = cdb.cd_nnls_batched(Gb, B_res, X0, l1, 5e-6, nonneg=True,
                              maxit=100, upper_bound=ub)
    again = cdb.cd_nnls_batched(Gb, B_res, X0, l1, 5e-6, nonneg=True,
                                maxit=100, upper_bound=ub)
    torch.cuda.synchronize()
    assert cdb.cd_nnls_batched.launches == before + 2
    plain = cdb.cd_nnls_batched_plain(Gb, B_res, X0, l1, 5e-6, nonneg=True,
                                      maxit=100, upper_bound=ub)
    assert (out > 0).any() or (dead and k == 1)
    assert torch.equal(out, plain)
    assert torch.equal(out, again)
    if dead:
        # its step is 0: it keeps its warm start, moved onto the bound where
        # it lies above it (x + (ub - x) may round a last bit off)
        x0 = X0[k // 2]
        if ub == 0:
            assert torch.equal(out[k // 2], x0)
        else:
            torch.testing.assert_close(out[k // 2], x0.clamp(max=ub),
                                       rtol=1e-6, atol=0)


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


@pytest.mark.parametrize("mode", [1, 2], ids=["F_staged", "F_global"])
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("k", [1, 8, 16, 17, 50, 128, 129])
def test_wgram_kernel_tile_edges(cuda, monkeypatch, k, splits, mode):
    """Kernel 4 on kernel 5's tile at k that is no multiple of its 16 x 8
    tiles, m (1,500) no multiple of its 32-row stages and odd bc (77), the
    reduction over m in one range and in three, F's rows for mu staged with
    the stage and read from device memory: within 1e-4 of the twin's
    largest entry, bitwise repeatable.  A theta per row and sparse_zeros on
    odd k, a theta per column on even k."""
    from rcppml_tpu_torch.ops import wgram
    plan = wgram.plan_wgram

    def forced(k_, m_, bc_, sms=132):
        _, wc, _, _ = plan(k_, m_, bc_, sms)
        chunk = -(-(-(-m_ // splits)) // 32) * 32
        return mode, wc, -(-m_ // chunk), chunk

    monkeypatch.setattr(wgram, "plan_wgram", forced)
    m, bc = 1500, 77
    rs = np.random.RandomState(k + 31 * splits)
    F = torch.from_numpy((np.abs(rs.normal(size=(k, m)))
                          * (rs.uniform(size=(k, m)) < 0.7)).astype(
        np.float32)).to(cuda)
    X = torch.from_numpy((np.abs(rs.normal(size=(k, bc))) / k).astype(
        np.float32)).to(cuda)
    A = torch.from_numpy(rs.poisson(0.4, size=(m, bc)).astype(
        np.float32)).to(cuda)
    odd = k % 2 == 1
    th = torch.from_numpy(rs.uniform(0.05, 50.0, size=(
        m if odd else bc,)).astype(np.float32)).to(cuda)
    args = (F, X, A, th if odd else None, None if odd else th)
    kw = dict(loss_kind="nb", sparse_zeros=odd)
    Gb, b = wgram.weighted_gram_rhs(*args, **kw)
    again = wgram.weighted_gram_rhs(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(Gb, again[0]) and torch.equal(b, again[1])
    Gp, bp = wgram.weighted_gram_rhs_plain(*args, **kw)
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


# ---------------------------------------------------------------------------
# Kernels 7, 8 (tall-skinny products) and 3 (whole-fit Newton-Schulz ALS)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("k,m,n", [
    (1, 1001, 77), (20, 1001, 77), (50, 3867, 610), (128, 700, 333),
    (150, 300, 260),                 # beyond 128 rows: a second pass
    (20, 13714, 2638), (7, 31, 5000), (7, 5000, 31),
    # each alignment of A's rows (n = 1, 2, 3 mod 4 and 0 mod 8), k not a
    # multiple of 8, m and n below one tile of 128 and one past it
    (7, 100, 90), (20, 129, 129), (50, 127, 259), (1, 129, 258),
    (150, 131, 512), (128, 257, 515)])
def test_rhs_tall_kernels_match_plain(cuda, k, m, n, dtype):
    from rcppml_tpu_torch.ops import rhs_tall as rt_
    rs = np.random.RandomState(k + m + n)
    A = torch.from_numpy((rs.rand(m, n) * (rs.rand(m, n) < 0.2)).astype(
        np.float32)).to(cuda).to(dtype)
    F = torch.from_numpy(rs.rand(k, m).astype(np.float32)).to(cuda)
    H = torch.from_numpy(rs.rand(k, n).astype(np.float32)).to(cuda)
    before = rt_.rhs_tall.launches, rt_.rhs_tall_t.launches
    fwd, fwd2 = rt_.rhs_tall(F, A), rt_.rhs_tall(F, A)
    trp, trp2 = rt_.rhs_tall_t(H, A), rt_.rhs_tall_t(H, A)
    torch.cuda.synchronize()
    assert (rt_.rhs_tall.launches, rt_.rhs_tall_t.launches) == \
        (before[0] + 2, before[1] + 2)
    assert torch.equal(fwd, fwd2) and torch.equal(trp, trp2)
    for out, plain in ((fwd, rt_.rhs_tall_plain(F, A)),
                       (trp, rt_.rhs_tall_t_plain(H, A))):
        assert out.shape == plain.shape and out.dtype == torch.float32
        assert float((out - plain).abs().max()) <= \
            1e-5 * float(plain.abs().max())


@pytest.mark.parametrize("k,n", [(7, 77), (20, 258), (150, 515)])
def test_rhs_tall_rounds_the_small_operand_as_the_twin(cuda, k, n):
    """Against a bfloat16 identity both products return the small operand
    as they rounded it: bit for bit ``_round_small``'s rounding."""
    from rcppml_tpu_torch.ops import rhs_tall as rt_
    rs = np.random.RandomState(k + n)
    eye = torch.eye(n, device=cuda, dtype=torch.bfloat16)
    X = torch.from_numpy(rs.normal(size=(k, n)).astype(np.float32)).to(cuda)
    # ties between two bfloat16 values round to the even one
    X[0, :4] = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8,
                             -1.0 - 2.0 ** -8, 2.0 ** -8 * (1 + 2 ** -8)])
    want = rt_._round_small(X, eye)
    assert torch.equal(rt_.rhs_tall(X, eye), want)
    assert torch.equal(rt_.rhs_tall_t(X, eye), want)


def test_rhs_tall_refuses_a_strided_matrix(cuda):
    from rcppml_tpu_torch.ops import rhs_tall as rt_
    A = torch.ones(64, 40, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rt_.rhs_tall(torch.ones(3, 40, device=cuda), A.T)


def _fused_inputs(m, n, k, device):
    from rcppml_tpu_torch import rng
    from rcppml_tpu_torch.utils.simulate import simulate_nmf
    A = simulate_nmf(m, n, min(k, 10), noise=0.5, dropout=0.5, seed=2)["A"]
    return (torch.from_numpy(A).to(device),
            torch.from_numpy(rng.fill_uniform(1, k, m)).to(device),
            torch.from_numpy(rng.fill_uniform(1, k, n, offset=k * m)).to(
                device))


def _half_step_errors(fa, A, W0, H0, iters, **kw):
    """The kernel's own trajectory, one iteration per call: H against the
    twin's H update from the same W, then W_T, d and the loss against the
    twin's W update from the kernel's H.  The largest error of each, as a
    share of the twin's largest entry."""
    bf16 = kw.get("a_bf16", False)
    A_mm, trata = fa.widened(A, bf16), (A * A).sum()
    l1_w, l1_h, l2_w, l2_h = (kw.get(key, 0.0) for key in
                              ("l1_w", "l1_h", "l2_w", "l2_h"))
    W, H = W0, H0
    worst = dict(W=0.0, H=0.0, d=0.0, loss=0.0)
    for _ in range(iters):
        Wk, Hk, dk, lk = fa.fused_als(A, W, H, maxit=1, **kw)
        Hp, _ = fa.h_update_plain(A_mm, W, fa.seed_inverse_plain(W, l2_h),
                                  a_bf16=bf16, l1_h=l1_h, l2_h=l2_h)
        Wp, dp, _, lp = fa.w_update_plain(
            A_mm, Hk, fa.seed_inverse_plain(H, l2_w), trata, a_bf16=bf16,
            l1_w=l1_w, l2_w=l2_w)
        for name, out, plain in (("W", Wk, Wp), ("H", Hk, Hp), ("d", dk, dp),
                                 ("loss", lk[0], lp)):
            worst[name] = max(worst[name], float((out - plain).abs().max())
                              / float(plain.abs().max()))
        W, H = Wk, Hk
    return worst


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("pen", [False, True], ids=["plain", "L1L2"])
@pytest.mark.parametrize("m,n,k", [
    (256, 200, 6), (131, 77, 5), (1500, 900, 50), (400, 300, 128),
    (64, 50, 1),
    (300, 260, 138), (300, 260, 150),
    # the k x k section's routes (ops/fused_als.py::refine_plan): one row
    # of the block design's threads and two, the last k of one block and the
    # first of a cluster of two, a cluster of four at its largest, device
    # memory (at 300 x 260 the bfloat16 loss after twenty iterations parts
    # from the twin's own trajectory by 1.6e-2 already before this design:
    # k = 128 and 129 run on a larger matrix)
    (200, 150, 32), (200, 150, 33), (600, 500, 128), (600, 500, 129),
    (300, 260, 139), (600, 500, 256), (600, 500, 257)])
def test_fused_als_kernel_matches_plain(cuda, m, n, k, pen, bf16):
    from rcppml_tpu_torch.ops import fused_als as fa
    A, W0, H0 = _fused_inputs(m, n, k, cuda)
    kw = dict(a_bf16=bf16, **(dict(l1_w=0.01, l1_h=0.02, l2_w=0.05,
                                   l2_h=0.03) if pen else {}))
    before = fa.fused_als.launches, fa.fused_als.calls
    one = fa.fused_als(A, W0, H0, maxit=1, **kw)
    torch.cuda.synchronize()
    assert fa.fused_als.launches == before[0] + fa.phase_count(1)
    assert fa.fused_als.calls == before[1] + 1
    one_plain = fa.fused_als_plain(A, W0, H0, maxit=1, **kw)
    for name, out, plain in zip("WHd", one, one_plain):
        if bf16 and name != "H":
            # W and d come from H rounded to bfloat16, where a last-bit
            # difference between the kernel's H and the twin's rounds the
            # other way: the half steps below feed the twin the kernel's H
            continue
        assert float((out - plain).abs().max()) <= \
            1e-4 * float(plain.abs().max()), name
    # every half step of twenty iterations, float32 and bfloat16 alike
    steps = _half_step_errors(fa, A, W0, H0, 20, **kw)
    assert max(steps.values()) <= 1e-4, steps
    many = fa.fused_als(A, W0, H0, maxit=20, **kw)
    again = fa.fused_als(A, W0, H0, maxit=20, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(many, again))
    plain = fa.fused_als_plain(A, W0, H0, maxit=20, **kw)
    assert bool(torch.isfinite(many[3]).all())
    # twenty iterations in one call against the twin's own trajectory.  So
    # far above the data's rank (k > 128) the Gram is close to singular and
    # the iterations grow the flipped bfloat16 roundings (4.7e-2 seen at
    # k=138, where every half step above agrees to 1.1e-5); at k=150 they
    # grow float32's last bits too (1.9e-3 at the twentieth loss, every half
    # step within 1e-4), so there the bar is the bfloat16 one of k <= 128
    if bf16:
        rtol = 1e-2 if k <= 128 else 1e-1
    else:
        rtol = 1e-3 if k <= 138 else 1e-2
    torch.testing.assert_close(many[3], plain[3], rtol=rtol, atol=0.0)


def test_fused_vmem_fit_is_one_call_and_launches_no_other_kernel(cuda):
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.ops import cd_nnls, fused_als as fa, rhs_tall as rt_
    from rcppml_tpu_torch.utils.simulate import simulate_nmf
    A = simulate_nmf(400, 300, 8, noise=0.5, seed=1)["A"]
    before = (fa.fused_als.launches, fa.fused_als.calls,
              cd_nnls.cd_nnls_shared.launches, rt_.rhs_tall.launches)
    kw = dict(fused_vmem=True, maxit=12, tol=0, seed=1)
    res = rtt.nmf(A, 8, **kw)                 # a host array goes to the card
    assert (fa.fused_als.launches, fa.fused_als.calls) == \
        (before[0] + fa.phase_count(12), before[1] + 1)
    assert cd_nnls.cd_nnls_shared.launches == before[2]
    assert rt_.rhs_tall.launches == before[3]
    assert res.iterations == 12 and res.converged is False
    assert np.isfinite(res.loss_history).all()
    assert res.loss_history[-1] < res.loss_history[0]
    again = rtt.nmf(A, 8, **kw)
    for f in ("W", "d", "H", "loss_history"):
        np.testing.assert_array_equal(getattr(res, f), getattr(again, f))
    on_cpu = rtt.nmf(A, 8, device="cpu", **kw)
    np.testing.assert_allclose(res.loss_history, on_cpu.loss_history,
                               rtol=1e-3)
    # past k = 138 the k x k section works in device memory: still one call
    wide = np.random.RandomState(0).rand(150, 145).astype(np.float32)
    before = fa.fused_als.calls
    res = rtt.nmf(wide, 140, fused_vmem=True, tol=0, maxit=2)
    assert fa.fused_als.calls == before + 1
    assert np.isfinite(res.loss_history).all()


def test_bf16_data_fit_launches_the_tall_products(cuda):
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.ops import rhs_tall as rt_
    from rcppml_tpu_torch.utils.simulate import simulate_nmf
    A = torch.from_numpy(simulate_nmf(400, 300, 8, noise=0.5,
                                      seed=1)["A"]).to(cuda)
    before = rt_.rhs_tall.launches, rt_.rhs_tall_t.launches
    res = rtt.nmf(A, 8, bf16_data=True, maxit=6, tol=0, seed=1)
    assert (rt_.rhs_tall.launches, rt_.rhs_tall_t.launches) == \
        (before[0] + 6, before[1] + 6)
    full = rtt.nmf(A, 8, maxit=6, tol=0, seed=1)
    assert (rt_.rhs_tall.launches, rt_.rhs_tall_t.launches) == \
        (before[0] + 6, before[1] + 6)           # float32 A: torch.matmul
    np.testing.assert_allclose(res.loss_history, full.loss_history, rtol=2e-2)
    on_cpu = rtt.nmf(A.cpu(), 8, bf16_data=True, maxit=6, tol=0, seed=1)
    np.testing.assert_allclose(res.loss_history, on_cpu.loss_history,
                               rtol=1e-2)


# ---------------------------------------------------------------------------
# Per-column weighted Gram + RHS, and the Cholesky solve + clip
# ---------------------------------------------------------------------------

def _wg5_inputs(k, m, bc, real, device, seed=0):
    rs = np.random.RandomState(seed + k + m + bc)
    F = (np.abs(rs.normal(size=(k, m))) * (rs.uniform(size=(k, m)) < 0.7)
         ).astype(np.float32)
    w = (rs.uniform(0.0, 2.0, size=(m, bc)) if real
         else rs.uniform(size=(m, bc)) >= 0.1).astype(np.float32)
    A = rs.poisson(0.4, size=(m, bc)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (F, w, A)]


@pytest.mark.parametrize("k,m,bc,real", [
    (1, 50, 1, True), (7, 333, 1, False), (16, 1001, 77, False),
    (20, 2638, 33, True), (130, 700, 40, False), (200, 300, 9, True),
])
def test_weighted_gram_kernel_matches_plain(cuda, k, m, bc, real):
    from rcppml_tpu_torch.ops import weighted_gram as wg5
    F, w, A = _wg5_inputs(k, m, bc, real, cuda)
    before = wg5.weighted_gram.launches
    Gb, b = wg5.weighted_gram(F, w, A)
    Gb2, b2 = wg5.weighted_gram(F, w, A)
    torch.cuda.synchronize()
    assert wg5.weighted_gram.launches == before + 2
    assert torch.equal(Gb, Gb2) and torch.equal(b, b2)
    Gp, bp = wg5.weighted_gram_plain(F, w, A)
    assert Gb.shape == (bc, k, k) and b.shape == (k, bc)
    assert float((Gb - Gp).abs().max()) <= 2e-5 * float(Gp.abs().max())
    assert float((b - bp).abs().max()) <= 2e-5 * max(float(bp.abs().max()),
                                                     1e-30)


def test_weighted_gram_kernel_reads_column_blocks_in_place(cuda):
    """w and A as column blocks of wider matrices (unit column stride, a
    longer row stride) and as transposed views (copied by the wrapper)."""
    from rcppml_tpu_torch.ops import weighted_gram as wg5
    F, w, A = _wg5_inputs(12, 400, 90, True, cuda)
    whole = wg5.weighted_gram(F, w, A)
    part = wg5.weighted_gram(F, w[:, 20:50], A[:, 20:50])
    assert torch.equal(part[0], whole[0][20:50])
    assert torch.equal(part[1], whole[1][:, 20:50])
    turned = wg5.weighted_gram(F, w.T.contiguous().T, A.T.contiguous().T)
    assert torch.equal(turned[0], whole[0]) and torch.equal(turned[1],
                                                            whole[1])


def test_weighted_gram_route_of_the_masked_solve(cuda, monkeypatch):
    """Beyond the Khatri-Rao budget ``linalg.weighted_gram_and_rhs`` launches
    the kernel on the card; within it, it launches none."""
    from rcppml_tpu_torch.ops import linalg, weighted_gram as wg5
    F, w, A = _wg5_inputs(9, 300, 21, False, cuda)
    before = wg5.weighted_gram.launches
    within = linalg.weighted_gram_and_rhs(F, w, A)
    assert wg5.weighted_gram.launches == before
    monkeypatch.setattr(linalg, "KR_BUDGET_FLOATS", 10.0)
    beyond = linalg.weighted_gram_and_rhs(F, w, A)
    assert wg5.weighted_gram.launches == before + 1
    for a, c in zip(within, beyond):
        assert float((a - c).abs().max()) <= 2e-5 * float(a.abs().max())


def test_weighted_gram_refuses_what_it_cannot_launch(cuda):
    from rcppml_tpu_torch.ops import weighted_gram as wg5
    F, w, A = _wg5_inputs(8, 64, 5, True, cuda)
    with pytest.raises(TypeError, match="float32"):
        wg5.weighted_gram(F.double(), w, A)
    with pytest.raises(ValueError, match="do not fit"):
        wg5.weighted_gram(F, w[:-1], A)
    with pytest.raises(ValueError, match="is on"):
        wg5.weighted_gram(F, w.cpu(), A)
    # the tile's shared memory does not grow with k: k = 2000, which the
    # first design refused, launches and agrees with the twin
    F, w, A = _wg5_inputs(2000, 40, 3, True, cuda)
    Gb, b = wg5.weighted_gram(F, w, A)
    Gp, bp = wg5.weighted_gram_plain(F, w, A)
    assert float((Gb - Gp).abs().max()) <= 2e-5 * float(Gp.abs().max())
    assert float((b - bp).abs().max()) <= 2e-5 * float(bp.abs().max())


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("bc", [1, 54, 68])
@pytest.mark.parametrize("k", [1, 5, 13, 105, 138, 200])
def test_weighted_gram_tile_edges(cuda, monkeypatch, k, bc, splits):
    """The one-triangle tile (csrc/tri_gram.cuh) at k that is no multiple
    of its 16 x 8 tiles, at one column and at the masked k=128 fit's blocks,
    with the reduction over m in one range and split in three; w and A as
    column blocks of wider matrices for odd k.  Within 2e-5 of the twin's
    largest entry, both triangles bitwise equal, bitwise repeatable."""
    from rcppml_tpu_torch.ops import weighted_gram as wg5
    m = 1500
    plan = wg5.plan_weighted_gram

    def forced(k_, m_, bc_, sms=132):
        wc, _, _ = plan(k_, m_, bc_, sms)
        chunk = -(-(-(-m_ // splits)) // 32) * 32
        return wc, -(-m_ // chunk), chunk

    monkeypatch.setattr(wg5, "plan_weighted_gram", forced)
    wide = bc + (40 if k % 2 else 0)
    F, w, A = _wg5_inputs(k, m, wide, k % 3 == 0, cuda)
    if k % 2:
        w, A = w[:, 17:17 + bc], A[:, 17:17 + bc]
    Gb, b = wg5.weighted_gram(F, w, A)
    again = wg5.weighted_gram(F, w, A)
    torch.cuda.synchronize()
    assert torch.equal(Gb, again[0]) and torch.equal(b, again[1])
    assert torch.equal(Gb, Gb.transpose(1, 2))
    Gp, bp = wg5.weighted_gram_plain(F, w, A)
    assert float((Gb - Gp).abs().max()) <= 2e-5 * float(Gp.abs().max())
    assert float((b - bp).abs().max()) <= 2e-5 * max(float(bp.abs().max()),
                                                     1e-30)


def _chol_system(k, n, device, seed=0, rank=None):
    rs = np.random.RandomState(seed + k + n)
    p = 4 * k if rank is None else rank
    F = rs.normal(size=(k, p)).astype(np.float32)
    G = (F @ F.T / p).astype(np.float32)
    B = rs.normal(size=(k, n)).astype(np.float32)
    return torch.from_numpy(G).to(device), torch.from_numpy(B).to(device)


@pytest.mark.parametrize("nonneg,ub", [(True, 0.0), (False, 0.0),
                                       (True, 0.05), (False, 0.05)])
@pytest.mark.parametrize("k,n", [
    (1, 1), (1, 300), (5, 1), (20, 2638), (64, 129), (138, 700),
    (241, 50),        # L beyond the shared memory of a block, in both kernels
    (300, 33),
])
def test_cholesky_clip_kernel_matches_plain_bitwise(cuda, k, n, nonneg, ub):
    from rcppml_tpu_torch.ops import cholesky_clip as cc
    G, B = _chol_system(k, n, cuda)
    before = cc.cholesky_clip.launches
    out = cc.cholesky_clip(G, B, nonneg=nonneg, upper_bound=ub)
    torch.cuda.synchronize()
    assert cc.cholesky_clip.launches == before + 1
    assert torch.equal(out, cc.cholesky_clip_plain(G, B, nonneg=nonneg,
                                                   upper_bound=ub))
    lib = torch.cholesky_solve(B, torch.linalg.cholesky(G))
    lib = lib.clamp_min(0.0) if nonneg else lib
    lib = lib.clamp_max(ub) if ub > 0 else lib
    assert float((out - lib).abs().max()) <= 1e-4 * max(
        float(lib.abs().max()), 1e-30)


@pytest.mark.parametrize("n", [1, 33, 2639])
@pytest.mark.parametrize("k", [1, 2, 15, 16, 17, 31, 32, 33, 64, 65])
def test_cholesky_clip_lane_group_edges_bitwise(cuda, k, n):
    """The one-launch route at the edges of its design: one lane, one warp
    of factor rows (k = 32) and one past it, the route's last k (64) and one
    past it (two kernels); one column, one warp of columns and one past it,
    a column past a block; with and without nonneg and upper_bound."""
    from rcppml_tpu_torch.ops import cholesky_clip as cc
    G, B = _chol_system(k, n, cuda, seed=1)
    assert (cc.plan_cholesky_clip(k, n).lanes > 0) == (k <= cc.LANES_MAX_K)
    for nonneg, ub in ((True, 0.0), (False, 0.0), (True, 0.05),
                       (False, 0.05)):
        out = cc.cholesky_clip(G, B, nonneg=nonneg, upper_bound=ub)
        again = cc.cholesky_clip(G, B, nonneg=nonneg, upper_bound=ub)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        assert torch.equal(out, cc.cholesky_clip_plain(
            G, B, nonneg=nonneg, upper_bound=ub)), (nonneg, ub)


@pytest.mark.parametrize("k,n", [(20, 2639), (50, 610), (64, 257)])
def test_cholesky_clip_every_plan_bitwise(cuda, monkeypatch, k, n):
    """Every group width (1 to 32 lanes) and block (1 to 8 warps) that the
    plan may choose, and the two-kernel route, give the twin's bits."""
    from rcppml_tpu_torch.ops import cholesky_clip as cc
    G, B = _chol_system(k, n, cuda, seed=2)
    plain = cc.cholesky_clip_plain(G, B)
    plans = [cc.CholPlan(0, 0, 128, 0, 0, -(-n // 128))]
    for lanes in (1, 2, 4, 8, 16, 32):
        rows = next((r for r in cc.LANE_ROWS if r >= -(-k // lanes)), None)
        for warps in (1, 2, 4, 8):
            threads = 32 * warps
            ldx = cc.tile_stride(threads // lanes, lanes)
            shared = 4 * k * ((k | 1) + ldx)
            if rows is not None and shared <= cc.SHARED_OPTIN:
                plans.append(cc.CholPlan(lanes, rows, threads, ldx, shared,
                                         -(-n // (threads // lanes))))
    for plan in plans:
        monkeypatch.setattr(cc, "plan_cholesky_clip",
                            lambda k_, n_, sms=132, plan=plan: plan)
        out = cc.cholesky_clip(G, B)
        torch.cuda.synchronize()
        assert torch.equal(out, plain), plan


@pytest.mark.parametrize("k", [8, 20, 50, 64, 65])
def test_cholesky_clip_pivot_rule_on_both_routes(cuda, k):
    """A zero Gram and a Gram of rank k / 2 (pivots at or below 1e-30,
    replaced by G's diagonal entry or 1e-30): finite, and the twin's bits,
    at k on both sides of the route threshold."""
    from rcppml_tpu_torch.ops import cholesky_clip as cc
    B = _chol_system(k, 300, cuda)[1]
    for G in (torch.zeros((k, k), device=cuda),
              _chol_system(k, 300, cuda, seed=3, rank=max(1, k // 2))[0]):
        out = cc.cholesky_clip(G, B, nonneg=False)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        assert torch.equal(out, cc.cholesky_clip_plain(G, B, nonneg=False))


def test_cholesky_clip_floors_a_pivot_that_is_not_positive(cuda):
    """Where ``torch.linalg.cholesky`` raises, the kernel replaces a pivot
    that is not above 1e-30 by G's diagonal entry (1e-30 where that is not
    above it either) and returns the twin's finite solution; the fit's entry
    adds the ridge that keeps a rank-deficient Gram solvable."""
    from rcppml_tpu_torch.ops import cholesky_clip as cc, solvers
    G = torch.zeros((6, 6), device=cuda)
    B = torch.ones((6, 4), device=cuda)
    with pytest.raises(Exception):
        torch.linalg.cholesky(G)
    out = cc.cholesky_clip(G, B)
    assert torch.isfinite(out).all()
    assert torch.equal(out, cc.cholesky_clip_plain(G, B))
    indefinite = torch.tensor([[1.0, 2.0, 0.0], [2.0, 1.0, 0.5],
                               [0.0, 0.5, 3.0]], device=cuda)
    out = cc.cholesky_clip(indefinite, B[:3], nonneg=False)
    assert torch.isfinite(out).all()
    assert torch.equal(out, cc.cholesky_clip_plain(indefinite, B[:3],
                                                   nonneg=False))
    G, B = _chol_system(20, 500, cuda, rank=10)
    out = solvers.cholesky_clip_batch(G, B)
    assert torch.isfinite(out).all()
    assert torch.equal(out, cc.cholesky_clip_plain(solvers._ridged(G), B))


def test_rank_one_fit_ends_finite_on_the_card_and_the_cpu(cuda):
    """A rank-1 matrix's ridged Grams are close to singular: the card
    (kernel 6) and the CPU (``cholesky_ex``, or kernel 6's twin where LAPACK
    refuses) both run the fit to its end with finite losses and factors."""
    import rcppml_tpu_torch as rtt
    rs = np.random.default_rng(0)
    A = np.outer(rs.random(200), rs.random(150)).astype(np.float32)
    for device in (cuda, "cpu"):
        res = rtt.nmf(A, 10, maxit=10, tol=0, seed=1, device=device)
        assert np.isfinite(res.loss_history).all(), device
        assert np.isfinite(res.W).all() and np.isfinite(res.H).all()


def test_cholesky_clip_refuses_what_it_cannot_launch(cuda):
    from rcppml_tpu_torch.ops import cholesky_clip as cc
    G, B = _chol_system(8, 5, cuda)
    with pytest.raises(TypeError, match="float32"):
        cc.cholesky_clip(G.double(), B)
    with pytest.raises(ValueError, match="do not fit"):
        cc.cholesky_clip(G[:-1], B)
    with pytest.raises(ValueError, match="is on"):
        cc.cholesky_clip(G.cpu(), B)


def test_cholesky_fit_launches_the_kernel_twice_per_iteration(cuda,
                                                              monkeypatch):
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.ops import cholesky_clip as cc
    from rcppml_tpu_torch.utils.simulate import simulate_nmf
    A = torch.from_numpy(simulate_nmf(400, 300, 8, seed=1)["A"]).to(cuda)

    def no_linalg(*args, **kwargs):
        raise AssertionError("torch.linalg.cholesky on the card's path")

    before = cc.cholesky_clip.launches
    with monkeypatch.context() as mp:
        mp.setattr(torch.linalg, "cholesky", no_linalg)
        res = rtt.nmf(A, 8, maxit=6, tol=0, seed=1)
    assert cc.cholesky_clip.launches == before + 2 * 6
    on_cpu = rtt.nmf(A.cpu(), 8, maxit=6, tol=0, seed=1)
    assert cc.cholesky_clip.launches == before + 2 * 6
    np.testing.assert_allclose(res.loss_history, on_cpu.loss_history,
                               rtol=1e-4)


def test_masked_and_cv_fits_on_the_card(cuda):
    """CV with the CD solver launches kernel 2 once per column block; the
    holdout mask is the host's; the card's fit agrees with the CPU's."""
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch import rng
    from rcppml_tpu_torch.ops import cd_nnls_batched as cdb
    from rcppml_tpu_torch.utils.simulate import simulate_nmf
    for seed, inv_prob in ((0, 10), (2**63 + 5, 7)):
        assert np.array_equal(
            rng.is_holdout(seed, 301, 200, inv_prob, cuda).cpu().numpy(),
            rng.holdout_mask(seed, 301, 200, inv_prob))
    A = torch.from_numpy(simulate_nmf(400, 300, 8, noise=0.5,
                                      seed=1)["A"]).to(cuda)
    kw = dict(test_fraction=0.1, cv_seed=1, maxit=6, tol=0, cv_patience=7,
              seed=1)
    before = cdb.cd_nnls_batched.launches
    res = rtt.nmf(A, 8, solver="cd", **kw)
    assert cdb.cd_nnls_batched.launches == before + 2 * 6
    assert res.misc["host_syncs"] == 6
    for fit_kw in (dict(solver="cd"), dict()):
        on_card = rtt.nmf(A, 8, **fit_kw, **kw)
        on_cpu = rtt.nmf(A.cpu(), 8, **fit_kw, **kw)
        np.testing.assert_allclose(on_card.loss_history, on_cpu.loss_history,
                                   rtol=1e-4)
        np.testing.assert_allclose(on_card.test_loss_history,
                                   on_cpu.test_loss_history, rtol=1e-4)


# ---------------------------------------------------------------------------
# Truncated SVD, SVD-seeded NMF, the projections and the profiled IRLS fit
# ---------------------------------------------------------------------------

def _planted(m=300, n=200, rank=8, seed=0, nonneg=False):
    """A matrix with eight well-separated singular values 10 * 0.7^i plus
    noise (nonnegative: its absolute value)."""
    rs = np.random.RandomState(seed)
    U, _ = np.linalg.qr(rs.randn(m, rank))
    V, _ = np.linalg.qr(rs.randn(n, rank))
    A = (U * (10.0 * 0.7 ** np.arange(rank))) @ V.T + 0.01 * rs.randn(m, n)
    return (np.abs(A) if nonneg else A).astype(np.float32)


def _aligned(port, ref):
    sign = np.sign(np.sum(np.asarray(port, np.float64) * ref, axis=0))
    sign[sign == 0] = 1.0
    return port * sign


SVD_ON_CARD = {
    "lanczos": dict(method="lanczos"),
    "irlba": dict(method="irlba"),
    "randomized": dict(method="randomized"),
    "pca": dict(method="lanczos", center=True),
    "krylov_nonneg": dict(method="krylov", nonneg=True),
    "krylov_cv": dict(method="krylov", test_fraction=0.1),
    "deflation": dict(method="deflation"),
    "deflation_nonneg_L1": dict(method="deflation", nonneg=True, L1=0.01),
    "deflation_robust": dict(method="deflation", robust=True),
    "deflation_masked": dict(method="deflation", mask="matrix"),
    "deflation_cv": dict(method="deflation", test_fraction=0.1),
    "auto_rank": dict(k="auto", k_max=12),
}


@pytest.mark.parametrize("case", list(SVD_ON_CARD))
def test_svd_on_the_card_matches_the_cpu(cuda, case):
    """Each method on the card against the port on the CPU: d within rtol
    1e-4 (1e-3 for the robust deflation, whose float32 iteration is
    chaotic), sign-aligned U, V within 1e-3, the same k_selected and CV
    trajectory length; the SVD launches no hand-written kernel."""
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.ops import cd_nnls, cholesky_clip
    kw = dict(SVD_ON_CARD[case])
    k = kw.pop("k", 5)
    A = _planted(nonneg="nonneg" in case)
    if kw.get("mask") == "matrix":
        kw["mask"] = np.random.RandomState(4).rand(*A.shape) < 0.1
    before = (cd_nnls.cd_nnls_shared.launches,
              cholesky_clip.cholesky_clip.launches)
    card = rtt.svd(torch.from_numpy(A).to(cuda), k, **kw)
    assert (cd_nnls.cd_nnls_shared.launches,
            cholesky_clip.cholesky_clip.launches) == before
    cpu = rtt.svd(A, k, device="cpu", **kw)
    assert card.k_selected == cpu.k_selected
    robust = "robust" in case
    np.testing.assert_allclose(card.d, cpu.d, rtol=1e-3 if robust else 1e-4,
                               atol=1e-4 * float(cpu.d.max()))
    if not robust:
        for name in ("U", "V"):
            p, r = getattr(card, name), getattr(cpu, name)
            np.testing.assert_allclose(_aligned(p, r), r, atol=1e-3)
    assert len(card.misc.get("test_loss_trajectory", [])) == \
        len(cpu.misc.get("test_loss_trajectory", []))


def test_new_entry_points_run_on_the_card_by_default(cuda):
    """A host array with no ``device=`` goes to the card: the same result
    as the tensor already there, and the card's kernels launch."""
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.ops import cholesky_clip
    A = np.abs(_planted())
    on_card = rtt.svd(torch.from_numpy(A).to(cuda), 4)
    np.testing.assert_array_equal(rtt.svd(A, 4).d, on_card.d)
    model = rtt.nmf(A, 4, maxit=3, tol=0, seed=1)
    before = cholesky_clip.cholesky_clip.launches
    H = rtt.nnls(A, w=model.W)
    assert cholesky_clip.cholesky_clip.launches == before + 1
    np.testing.assert_array_equal(
        rtt.nnls(torch.from_numpy(A).to(cuda), w=model.W), H)
    assert rtt.predict(model, A).shape == (4, A.shape[1])
    assert np.isfinite(rtt.evaluate(model, A))
    assert rtt.mse(model, A) == rtt.evaluate(model, torch.from_numpy(A).to(
        cuda))


NNLS_ON_CARD = {
    "cholesky": (dict(), "cholesky_clip"),
    "cholesky_upper_bound": (dict(upper_bound=0.05), "cholesky_clip"),
    "cd": (dict(solver="cd"), "cd_nnls_shared"),
    "L1": (dict(L1=0.01), "cd_nnls_shared"),
    "k40": (dict(k=40), "cd_nnls_shared"),
    "warm_start": (dict(warm_start=True), "cd_nnls_shared"),
    "kl": (dict(loss="kl"), "cd_nnls_batched"),
    "nb_theta_per_row": (dict(loss="nb", theta="row"), "cd_nnls_batched"),
    "gp_theta_per_col": (dict(loss="gp", theta="col"), "cd_nnls_batched"),
    "kl_fused_wgram": (dict(loss="kl", fused=True), "weighted_gram_rhs"),
}


@pytest.mark.parametrize("route", list(NNLS_ON_CARD))
def test_nnls_routes_on_the_card_match_the_cpu(cuda, route, monkeypatch):
    """Each ``nnls`` route launches its kernel on the card, repeats bit for
    bit and agrees with its CPU result within 1e-4 of the largest entry."""
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.ops import (cd_nnls, cd_nnls_batched,
                                      cholesky_clip, wgram)
    from rcppml_tpu_torch.utils.simulate import simulate_nmf
    wrappers = {"cholesky_clip": cholesky_clip.cholesky_clip,
                "cd_nnls_shared": cd_nnls.cd_nnls_shared,
                "cd_nnls_batched": cd_nnls_batched.cd_nnls_batched,
                "weighted_gram_rhs": wgram.weighted_gram_rhs}
    kw, kernel = NNLS_ON_CARD[route]
    kw = dict(kw)
    sim = simulate_nmf(900, 400, 6, seed=3)
    A = np.round(sim["A"] * 4).astype(np.float32)
    k = kw.pop("k", 6)
    rs = np.random.RandomState(k)
    W = sim["W"] if k == 6 else rs.uniform(0.1, 1, (900, k)).astype(
        np.float32)
    theta = kw.pop("theta", None)
    if theta is not None:
        kw["theta"] = rs.uniform(0.5, 5.0, 900 if theta == "row" else 400)
    if kw.pop("warm_start", False):
        kw["warm_start"] = 0.9 * rtt.nnls(A, w=W, device="cpu")
    if kw.pop("fused", False):
        monkeypatch.setenv("RCPPML_FUSED_WGRAM", "1")
    before = wrappers[kernel].launches
    X = rtt.nnls(A, w=W, device="cuda", **kw)
    assert wrappers[kernel].launches > before
    np.testing.assert_array_equal(rtt.nnls(A, w=W, device="cuda", **kw), X)
    ref = rtt.nnls(A, w=W, device="cpu", **kw)
    assert np.abs(X - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("seed", ["lanczos", "irlba"])
def test_svd_seeded_fit_on_the_card(cuda, seed):
    """The init on the card within 1e-4 of the CPU port's on a matrix with
    a well-separated spectrum; the fit launches kernel 6 twice an
    iteration."""
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.models import nmf as nmf_mod
    from rcppml_tpu_torch.ops import cholesky_clip
    A = _planted(nonneg=True)
    cfg = rtt.build_config(5, seed=seed)
    on_card = nmf_mod.init_factors(cfg, *A.shape,
                                   A=torch.from_numpy(A).to(cuda))
    on_cpu = nmf_mod.init_factors(cfg, *A.shape, A=torch.from_numpy(A))
    for a, b in zip(on_card, on_cpu):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    before = cholesky_clip.cholesky_clip.launches
    res = rtt.nmf(A, 5, seed=seed, maxit=6, tol=0)
    assert cholesky_clip.cholesky_clip.launches == before + 2 * 6
    cpu = rtt.nmf(A, 5, seed=seed, maxit=6, tol=0, device="cpu")
    np.testing.assert_allclose(res.loss_history, cpu.loss_history,
                               rtol=1e-4)


def test_profiled_irls_fit_on_the_card(cuda):
    """profile=True with an IRLS loss: the history and factors of the
    unprofiled fit on the card, bit for bit."""
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.utils.simulate import simulate_nmf
    A = torch.from_numpy(np.round(simulate_nmf(600, 300, 6, seed=2)["A"]
                                  * 4)).to(cuda)
    plain = rtt.nmf(A, 6, loss="kl", maxit=8, tol=0, seed=1)
    prof = rtt.nmf(A, 6, loss="kl", maxit=8, tol=0, seed=1, profile=True)
    np.testing.assert_array_equal(prof.loss_history, plain.loss_history)
    np.testing.assert_array_equal(prof.W, plain.W)
    assert prof.profile["iterations"] == 8 and prof.profile["mode"] == \
        "fused-segmented"


def _planted_groups(m, n, levels, seed):
    """Columns in 2**levels groups on a binary tree of gene programs, every
    rank-2 split between groups (``tests/test_torch_clustering.py``)."""
    rs = np.random.RandomState(seed)
    labels = np.arange(n) * 2 ** levels // n
    depth = rs.uniform(0.8, 1.2, n)
    A = rs.uniform(0, 0.5, (m, n))
    for lev in range(1, levels + 1):
        blocks = np.array_split(rs.permutation(m), 2 ** lev)
        for b, rows in enumerate(blocks):
            prog = 2.0 ** (levels - lev) * rs.uniform(0.5, 1.5, len(rows))
            cols = np.flatnonzero(labels >> (levels - lev) == b)
            A[np.ix_(rows, cols)] += prog[:, None] * depth[cols]
    return A.astype(np.float32), labels


def test_bipartition_and_dclust_on_the_card_match_the_cpu(cuda):
    """A host array goes to the card; the split and the tree equal the CPU
    port's (ids and samples), v and dist within 1e-4, bitwise repeatable on
    the card; at most maxit // 10 host reads a split."""
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.models import clustering
    A, labels = _planted_groups(1200, 400, 3, seed=6)
    reads = clustering._rank2_als.host_reads
    card = rtt.bipartition(A, seed=3)
    assert clustering._rank2_als.host_reads - reads <= 10
    cpu = rtt.bipartition(A, seed=3, device="cpu")
    np.testing.assert_array_equal(card.samples1, cpu.samples1)
    assert np.abs(card.v - cpu.v).max() <= 1e-4 * np.abs(cpu.v).max()
    assert abs(card.dist - cpu.dist) <= 1e-4
    np.testing.assert_array_equal(rtt.bipartition(A, seed=3).v, card.v)
    tree = rtt.dclust(torch.from_numpy(A).to(cuda), min_samples=30)
    want = rtt.dclust(A, min_samples=30, device="cpu")
    assert [c.id for c in tree] == [c.id for c in want]
    for a, b in zip(tree, want):
        np.testing.assert_array_equal(a.samples, b.samples)
        assert abs(a.dist - b.dist) <= 1e-4
    assert all(len(np.unique(labels[c.samples])) == 1 for c in tree)


@pytest.mark.parametrize("loss", ["mse", "kl"])
def test_checkpointed_fits_on_the_card_are_the_uninterrupted_fit(
        cuda, loss, tmp_path):
    """In segments, and stopped and resumed: W, d, H and the history bit for
    bit the uninterrupted fit on the card, with as many launches of its
    kernel (kernel 6 for MSE, kernel 2 for KL)."""
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.ops import cd_nnls_batched, cholesky_clip
    from rcppml_tpu_torch.utils.simulate import simulate_nmf
    A = simulate_nmf(900, 400, 6, seed=3)["A"]
    if loss == "kl":
        A = np.round(A * 4).astype(np.float32)
    A = torch.from_numpy(A).to(cuda)
    kernel = (cholesky_clip.cholesky_clip if loss == "mse"
              else cd_nnls_batched.cd_nnls_batched)
    kw = dict(loss=loss, tol=0, seed=1)
    before = kernel.launches
    plain = rtt.nmf(A, 6, maxit=12, **kw)
    plain_launches = kernel.launches - before
    path = str(tmp_path / "ck.npz")
    before = kernel.launches
    seg = rtt.nmf(A, 6, maxit=12, checkpoint_path=path, checkpoint_every=5,
                  **kw)
    assert kernel.launches - before == plain_launches > 0
    path2 = str(tmp_path / "resume.npz")
    rtt.nmf(A, 6, maxit=6, checkpoint_path=path2, checkpoint_every=4, **kw)
    resumed = rtt.nmf(A, 6, maxit=12, checkpoint_path=path2,
                      checkpoint_every=4, **kw)
    for res in (seg, resumed):
        for name in ("W", "d", "H", "loss_history"):
            np.testing.assert_array_equal(getattr(res, name),
                                          getattr(plain, name))


STREAM_ON_CARD = {"mse": dict(), "cd": dict(solver="cd"),
                  "kl": dict(loss="kl"),
                  "cv": dict(test_fraction=0.1, cv_seed=2, solver="cd")}
# the KL stream's card-against-CPU W gap over these data seeds as well
STREAM_KL_SEEDS = (5, 6, 7)


def _stream_card_against_cpu(case, seed, tmp_path):
    """A ``.spz`` stream on the card (sparse panels densified there, the
    wire cache) against the same stream on the CPU port: the loss history
    within 1e-4 and W within 2e-3 of its largest entry (for KL within 1e-2,
    the card-against-CPU bar of the in-memory IRLS fits, chip_smoke.py
    phase 8 (v): its weights amplify the rounding), through the kernel of
    the case; the uncached and wire-cached streams on the card agree within
    1e-5.  Prints the W gap as a share of the largest entry."""
    import scipy.sparse as sp
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.io.loaders import SpzLoader
    from rcppml_tpu_torch.models.nmf_chunked import nmf_chunked
    from rcppml_tpu_torch.ops import (cd_nnls, cd_nnls_batched,
                                      cholesky_clip, coo_densify)
    rs = np.random.RandomState(seed)
    A = sp.random(700, 900, density=0.08, random_state=rs, format="csc",
                  dtype=np.float32)
    A.data = np.ceil(A.data * 6)
    path = str(tmp_path / "a.spz")
    rtt.st_write(A, path, chunk_cols=128)
    kw = STREAM_ON_CARD[case]
    cfg = rtt.build_config(5, maxit=6, tol=0, seed=1, **kw)
    kernel = (cd_nnls_batched.cd_nnls_batched
              if "loss" in kw or "test_fraction" in kw
              else cd_nnls.cd_nnls_shared if kw
              else cholesky_clip.cholesky_clip)
    before = kernel.launches
    densified = coo_densify.coo_densify.launches
    card = nmf_chunked(SpzLoader(path), cfg, panel_cache=False)
    assert kernel.launches > before
    # every sparse panel on the card is densified by the kernel
    assert coo_densify.coo_densify.launches - densified == \
        card.misc["stream"]["densified"] > 0
    host = nmf_chunked(SpzLoader(path), cfg, panel_cache=False,
                       device="cpu")
    wire = nmf_chunked(SpzLoader(path), cfg, panel_cache="wire")
    np.testing.assert_allclose(card.loss_history, host.loss_history,
                               rtol=1e-4)
    factor_tol = 1e-2 if "loss" in kw else 2e-3
    gap = np.abs(card.W - host.W).max() / np.abs(host.W).max()
    print(f"stream {case}, data seed {seed}: card W within {gap:.3e} of the "
          f"CPU W's largest entry (bar {factor_tol})")
    assert gap <= factor_tol
    assert np.abs(wire.W - card.W).max() < 1e-5
    assert abs(wire.train_loss - card.train_loss) <= \
        1e-5 * abs(card.train_loss)


@pytest.mark.parametrize("case", list(STREAM_ON_CARD))
def test_streaming_fit_on_the_card_matches_the_cpu(cuda, case, tmp_path):
    _stream_card_against_cpu(case, 4, tmp_path)


@pytest.mark.parametrize("seed", STREAM_KL_SEEDS)
def test_streaming_kl_on_the_card_matches_the_cpu_over_seeds(cuda, seed,
                                                             tmp_path):
    _stream_card_against_cpu("kl", seed, tmp_path)


# csrc/coo_densify.cu at the hcabm40k stream's panels (forward 5,000 x 512
# with about 422K entries, transposed 40,000 x 512 with about 3.4M) and at
# its edges: (nrows, ncols, density, row type, value type)
DENSIFY_CASES = {
    "forward": (5000, 512, 0.165, "int16", "uint8"),
    "transposed": (40000, 512, 0.165, "int16", "uint8"),
    "uint16_values": (40000, 512, 0.02, "int16", "uint16"),
    "float_values": (3073, 13, 0.3, "int16", "float32"),
    "int32_rows": (70000, 9, 0.05, "int32", "uint8"),
    "single_column": (6000, 1, 0.5, "int16", "uint8"),
    "no_entries": (100, 17, 0.0, "int16", "uint8"),
}


def _coo_panel(nrows, ncols, density, row_type, val_kind, seed=0):
    """A panel's wire triples in canonical CSC order, as the streaming
    engine ships them, with every 37th column (from the second) empty."""
    rs = np.random.RandomState(seed)
    counts = rs.binomial(nrows, density, size=ncols).astype(np.int32)
    counts[1::37] = 0
    rows = np.concatenate([np.zeros(0, np.int64)] + [
        np.sort(rs.choice(nrows, c, replace=False)) for c in counts])
    rows_t = torch.from_numpy(rows.astype(np.uint16).view(np.int16)) \
        if row_type == "int16" else torch.from_numpy(rows.astype(np.int32))
    nnz = len(rows)
    vals_t = {"uint8": lambda: torch.from_numpy(
                  rs.randint(1, 256, nnz).astype(np.uint8)),
              "uint16": lambda: torch.from_numpy(
                  rs.randint(1, 65536, nnz).astype(np.uint16).view(np.int16)),
              "float32": lambda: torch.from_numpy(
                  rs.standard_normal(nnz).astype(np.float32))}[val_kind]()
    return rows_t, torch.from_numpy(counts), vals_t


@pytest.mark.parametrize("case", list(DENSIFY_CASES))
def test_coo_densify_kernel_matches_plain_bitwise(cuda, case):
    from rcppml_tpu_torch.ops import coo_densify as cd
    nrows = DENSIFY_CASES[case][0]
    wire = _coo_panel(*DENSIFY_CASES[case])
    plain = cd.coo_densify(*wire, nrows)
    before = cd.coo_densify.launches
    got = cd.coo_densify(*(t.to(cuda) for t in wire), nrows)
    torch.cuda.synchronize()
    assert cd.coo_densify.launches == before + 1
    assert got.is_cuda and got.shape == plain.shape
    assert torch.equal(got.cpu().view(torch.int32), plain.view(torch.int32))


def test_coo_densify_refuses_triples_on_two_devices(cuda):
    from rcppml_tpu_torch.ops import coo_densify as cd
    rows, counts, vals = _coo_panel(*DENSIFY_CASES["int32_rows"])
    with pytest.raises(ValueError, match="coo_densify"):
        cd.coo_densify(rows.to(cuda), counts, vals.to(cuda), 70000)


# csrc/transpose_panels.cu at the hcabm40k stream's panels (forward 5,000 x
# 512 with a last one of 5,000 x 64, transposed 40,000 x 512 with a last one
# of 40,000 x 392), a transposed width that is no multiple of 4 (one float a
# thread against 16-byte forward panels) and a ragged small case: (m,
# forward widths, transposed widths)
TRANSPOSE_CASES = {
    "main_path": (5000, [512] * 78 + [64], [512] * 9 + [392]),
    "odd_ncols": (600, [64, 64, 32], [255, 345]),
    "ragged": (45, [7, 13, 1, 9], [17, 17, 11]),
}


@pytest.mark.parametrize("case", list(TRANSPOSE_CASES))
def test_transpose_panels_kernel_matches_plain_bitwise(cuda, case):
    """Every transposed panel, one launch each, equals the plain twin's
    bit for bit (the twin on the same forward panels on the card)."""
    from rcppml_tpu_torch.ops import transpose_panels as tp
    m, widths, t_widths = TRANSPOSE_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(7)
    starts = np.concatenate([[0], np.cumsum(widths)[:-1]]).tolist()
    panels = [torch.randn((m, w), generator=gen, device=cuda)
              for w in widths]
    tab = tp.panel_table(panels, starts)
    assert tab.vec == (4 if all(w % 4 == 0 for w in widths) else 1)
    row0 = 0
    for nc in t_widths:
        before = tp.transpose_panels.launches
        got = tp.transpose_panels(tab, row0, nc)
        plain = tp.transpose_panels_plain(tab, row0, nc)
        torch.cuda.synchronize()
        assert tp.transpose_panels.launches == before + 1
        assert got.is_cuda and got.shape == plain.shape == (sum(widths), nc)
        assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
        row0 += nc
    assert row0 == m


def test_transpose_panels_refuses_panels_on_two_devices(cuda):
    from rcppml_tpu_torch.ops import transpose_panels as tp
    F = torch.ones((4, 8))
    with pytest.raises(ValueError, match="transpose_panels"):
        tp.panel_table([F.to(cuda), F], [0, 8])


@pytest.mark.parametrize("case", ["mse", "kl"])
def test_stream_builds_its_transposed_panels_on_the_card(cuda, case,
                                                         tmp_path):
    """A ``.spz`` stream with the dense cache on the card builds every
    transposed panel with the kernel, once, and fits bit for bit what the
    same stream fits when its loader withholds the guarantee and the
    transpose stream is decoded, uploaded and densified."""
    import scipy.sparse as sp
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.io.loaders import SpzLoader
    from rcppml_tpu_torch.models.nmf_chunked import nmf_chunked
    from rcppml_tpu_torch.ops import transpose_panels as tp
    rs = np.random.RandomState(9)
    A = sp.random(700, 900, density=0.165, random_state=rs, format="csc",
                  dtype=np.float32)
    A.data = np.ceil(A.data * 6)
    path = str(tmp_path / "a.spz")
    rtt.st_write(A, path, chunk_cols=128)
    cfg = rtt.build_config(5, maxit=6, tol=0, seed=1,
                           **({"loss": "kl"} if case == "kl" else {}))
    before = tp.transpose_panels.launches
    built = nmf_chunked(SpzLoader(path), cfg, panel_cache=True)
    launched = tp.transpose_panels.launches - before
    withheld = SpzLoader(path)
    withheld.exact_transpose = lambda: False
    read = nmf_chunked(withheld, cfg, panel_cache=True)
    trp = withheld.num_chunks(True)
    assert launched == built.misc["stream"]["transposed_on_card"] == trp
    assert read.misc["stream"]["transposed_on_card"] == 0
    for f in ("W", "d", "H", "loss_history"):
        assert np.array_equal(getattr(built, f), getattr(read, f)), f


# ---------------------------------------------------------------------------
# the graph engine (models/graph.py): the deep layer's solves at the pbmc3k
# net's shapes (k2 = 8 against k1 = 20 columns, and against the samples)
# ---------------------------------------------------------------------------

GRAPH_LAYER2 = [(8, 20), (8, 2638)]


@pytest.mark.parametrize("k,n", GRAPH_LAYER2)
def test_graph_layer2_solves_bitwise(cuda, k, n):
    from rcppml_tpu_torch.ops import cd_nnls
    from rcppml_tpu_torch.ops import cholesky_clip as cc
    G, B = _chol_system(k, n, cuda, seed=k + n)
    for nonneg in (True, False):
        out = cc.cholesky_clip(G, B, nonneg=nonneg)
        torch.cuda.synchronize()
        assert torch.equal(out, cc.cholesky_clip_plain(G, B, nonneg=nonneg))
    G, B_res, X0 = _system(k, n, k * n, cuda)
    for l1 in (0.0, 0.25):
        out = cd_nnls.cd_nnls_shared(G, B_res, X0, l1, 5e-6, nonneg=True,
                                     maxit=100)
        torch.cuda.synchronize()
        assert torch.equal(out, cd_nnls.cd_nnls_shared_plain(
            G, B_res, X0, l1, 5e-6, nonneg=True, maxit=100))


def _graph_net(A, solver):
    from rcppml_tpu_torch.models import graph as tg
    inp = tg.Input(A, "x")
    l2 = tg.NMFLayer(tg.NMFLayer(inp, 20, name="L1", solver=solver), 8,
                     name="L2", solver=solver)
    return tg.factor_net(inp, l2, maxit=8, tol=0.0, seed=42)


@pytest.mark.parametrize("solver,kernel", [("auto", "cholesky_clip"),
                                           ("cd", "cd_nnls_shared")])
def test_graph_fused_net_on_the_card_matches_the_cpu(cuda, solver, kernel):
    """The 2-layer net's outer ALS on the card: the solver's kernel twice a
    warmup iteration and twice a layer a sweep, no host read at tol=0,
    bitwise repeatable, within 1e-4 in loss and 1e-2 of the factors'
    largest entry of the same net on the CPU."""
    from rcppml_tpu_torch.models import graph as tg
    from rcppml_tpu_torch.ops import cd_nnls, cholesky_clip
    from rcppml_tpu_torch.utils.simulate import simulate_nmf
    fn = {"cholesky_clip": cholesky_clip.cholesky_clip,
          "cd_nnls_shared": cd_nnls.cd_nnls_shared}[kernel]
    A = simulate_nmf(1200, 400, 20, noise=0.5, dropout=0.9, seed=3)["A"]
    net = _graph_net(torch.from_numpy(A).to(cuda), solver)
    before, reads = fn.launches, tg._outer_als.host_reads
    res = tg.fit(net)
    assert net._fused_fn is not None
    assert fn.launches - before == 2 * sum(net._warm_iterations) + 4 * 8
    assert tg._outer_als.host_reads == reads
    again = tg.fit(net)
    cpu = tg.fit(_graph_net(A, solver), device="cpu")
    assert res.total_iterations == cpu.total_iterations == 8
    np.testing.assert_allclose(res.total_loss, cpu.total_loss, rtol=1e-4)
    for name in ("L1", "L2"):
        for f in ("W", "d", "H"):
            a, b = getattr(res[name], f), getattr(cpu[name], f)
            np.testing.assert_array_equal(a, getattr(again[name], f))
            assert np.abs(a - b).max() <= 1e-2 * np.abs(b).max(), (name, f)


def test_multimodal_fit_is_the_stacked_fit_bitwise(cuda):
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.utils.simulate import simulate_nmf
    A = torch.from_numpy(simulate_nmf(900, 300, 10, noise=0.5, seed=4)[
        "A"]).to(cuda)
    multi = rtt.nmf([A[:600], A[600:]], 10, maxit=10, tol=0, seed=42)
    single = rtt.nmf(A, 10, maxit=10, tol=0, seed=42)
    lr = multi["L1"]
    np.testing.assert_array_equal(lr.W_blocks["modal1"], single.W[:600])
    np.testing.assert_array_equal(lr.W_blocks["modal2"], single.W[600:])
    np.testing.assert_array_equal(lr.H, single.H)
    np.testing.assert_array_equal(lr.d, single.d)


def test_one_by_one_mesh_over_nccl_is_the_plain_fit(cuda):
    """A (1, 1) mesh at world size 1 over NCCL: the MSE fit is the plain fit
    bit for bit, with kernel 6 launched twice an iteration (no collective
    runs on an axis of one rank)."""
    import socket
    import torch.distributed as dist
    import rcppml_tpu_torch as rtt
    from rcppml_tpu_torch.ops import cholesky_clip
    from rcppml_tpu_torch.parallel import multihost
    from rcppml_tpu_torch.utils.simulate import simulate_nmf
    A = torch.from_numpy(simulate_nmf(1200, 400, 20, noise=0.5, dropout=0.9,
                                      seed=3)["A"]).to(cuda)
    plain = rtt.nmf(A, 20, maxit=10, tol=0, seed=1)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    info = multihost.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        assert info["backend"] == "nccl" and info["process_count"] == 1
        mesh = rtt.default_mesh()
        assert mesh.shape == {"rows": 1, "cols": 1}
        before = cholesky_clip.cholesky_clip.launches
        res = rtt.nmf(A, 20, maxit=10, tol=0, seed=1, mesh=mesh)
        assert cholesky_clip.cholesky_clip.launches - before == 20
    finally:
        dist.destroy_process_group()
        multihost._RANK_DEVICE.clear()
    for name in ("W", "d", "H", "loss_history"):
        np.testing.assert_array_equal(getattr(res, name),
                                      getattr(plain, name))


def test_two_ranks_share_the_card_over_gloo(cuda, tmp_path):
    """Two processes on card 0 join over gloo, each passing only its column
    half through ``shard_host_data`` on a (1, 2) mesh: the fit equals the
    single-card fit (rtol 1e-4, atol 1e-5), kernel 6 launched twice an
    iteration on each rank's block."""
    import os
    import subprocess
    import sys
    import rcppml_tpu_torch as rtt
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_multiproc_worker.py")
    out = tmp_path / "mp.npz"
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), str(tmp_path / "store"), str(out),
         "cuda"], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log, _ = p.communicate()
        logs.append(log)
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    z = np.load(out)
    rs = np.random.RandomState(0)
    A = np.abs(rs.rand(24, 32)).astype(np.float32)
    ref = rtt.nmf(torch.from_numpy(A).to(cuda), 4, seed=42, maxit=20, tol=0,
                  sort_model=False)
    assert int(z["iterations"]) == ref.iterations
    assert int(z["launches"]) == 2 * 20
    np.testing.assert_allclose(z["W"], ref.W, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(z["H"], ref.H, rtol=1e-4, atol=1e-5)
