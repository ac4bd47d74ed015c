"""The plain reference recovers a planted exact factorisation, follows
one iteration by hand, and takes a fit's last step again from its own
factors."""

import pytest
import torch

import harness
from conftest import BENCH


def planted(m=80, n=60, k=4, seed=3):
    gen = torch.Generator().manual_seed(seed)
    W = torch.rand((m, k), generator=gen, dtype=torch.float64) + 0.1
    H = torch.rand((k, n), generator=gen, dtype=torch.float64) + 0.1
    return W, H, W @ H


@pytest.mark.parametrize("name", ["mse"])
def test_recovers_planted(name):
    ref = harness.load_module(BENCH / "reference" / f"{name}.py")
    W, H, A = planted()
    out = ref.fit(A, W + 0.05, {"k": 4, "nmf": {"maxit": 30}})
    recon = torch.from_numpy(out["W"] * out["d"][None, :] @ out["H"])
    assert float((recon - A).norm() / A.norm()) < 1e-3
    hist = out["loss_history"]
    assert hist[-1] < 1e-6 * float((A * A).sum())
    assert list(out["d"]) == sorted(out["d"], reverse=True)


def test_mse_one_iteration_by_hand():
    """One iteration of the MSE reference is the clipped ridged least
    squares of each side, checked with numpy's dense solve."""
    import numpy as np
    ref = harness.load_module(BENCH / "reference" / "mse.py")
    _, _, A = planted(m=30, n=20, k=3)
    W0 = torch.rand((30, 3), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    out = ref.fit(A, W0, {"k": 3, "nmf": {"maxit": 1}})
    a = A.numpy()

    def clipped_ls(F, B):          # F (k, rows), B (rows, cols)
        G = F @ F.T
        G = G + 1e-6 * np.trace(G) / 3 * np.eye(3)
        return np.clip(np.linalg.solve(G, F @ B), 0, None)
    H = clipped_ls(W0.numpy().T, a)
    H = H / H.sum(axis=1, keepdims=True)
    Wt = clipped_ls(H, a.T)
    d = Wt.sum(axis=1)
    order = np.argsort(-d)
    assert np.allclose(out["d"], d[order], rtol=1e-9)
    assert np.allclose(out["H"], H[order], rtol=1e-9, atol=1e-12)


def test_w_update_of_the_references_own_fit():
    """Taken again from the reference's own final H, the last W update
    returns its W diag(d)."""
    import numpy as np
    ref = harness.load_module(BENCH / "reference" / "mse.py")
    _, _, A = planted(m=40, n=30, k=3)
    W0 = torch.rand((40, 3), generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    out = ref.fit(A, W0, {"k": 3, "nmf": {"maxit": 4}})
    Wd = ref.w_update(A, torch.from_numpy(out["H"]))
    assert np.allclose(Wd, out["W"] * out["d"][None, :], rtol=1e-9,
                       atol=1e-12)
