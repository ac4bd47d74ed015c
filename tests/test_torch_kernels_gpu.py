"""The CD NNLS CUDA kernel against its plain twin, on the card.

Every test here needs a CUDA card with compute capability 9.0 and skips
without one.  The file imports no JAX, so it runs on a machine that has none:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \\
        tests/test_torch_kernels_gpu.py

Parity contract: the kernel rounds each operation as PyTorch's eager twin
does (no FMA contraction, IEEE division), so results are bitwise equal.
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
