"""The port's ``NMFResult`` methods against the JAX package's, on the CPU.

The S4-method equivalents (``subset_factors``, ``subset``, ``[]``, ``t``,
``prod``, ``head``, ``summary``, ``align_to``) run on the same factors in
both packages: a model the JAX package fitted, carried to the port by
``convert.nmf_result_from_reference``.  Each result equals the JAX one
(arrays bit for bit: these are numpy operations on the same arrays).  The
dataclass fields follow the reference's order, so a positional
construction means the same in both packages, and ``plot_summary`` takes
``summary(group_by)`` as documented.
"""

import dataclasses

import numpy as np
import pytest

import rcppml_tpu as rt
from rcppml_tpu.result import NMFResult as RefNMFResult

import rcppml_tpu_torch as rtt
from rcppml_tpu_torch import convert
from rcppml_tpu_torch.result import NMFResult
from rcppml_tpu_torch.utils.simulate import simulate_nmf

M, N, K = 50, 40, 5
FIELDS = ("W", "d", "H", "iterations", "converged", "train_loss",
          "test_loss", "best_iter", "loss_history", "test_loss_history",
          "theta", "dispersion", "pi_row", "pi_col", "row_names",
          "col_names")


@pytest.fixture(scope="module")
def models():
    A = simulate_nmf(M, N, K, seed=4)["A"]
    ref = rt.nmf(A, K, maxit=5, tol=0, seed=1)
    ref.row_names = np.asarray([f"g{i}" for i in range(M)])
    ref.col_names = np.asarray([f"c{j}" for j in range(N)])
    other = rt.nmf(A, K, maxit=5, tol=0, seed=9)
    return (ref, convert.nmf_result_from_reference(ref), other,
            convert.nmf_result_from_reference(other))


def _same(port, ref):
    assert isinstance(port, NMFResult) and isinstance(ref, RefNMFResult)
    for f in FIELDS:
        a, b = getattr(port, f), getattr(ref, f)
        if a is None or b is None:
            assert a is None and b is None, f
        elif isinstance(b, np.ndarray):
            assert np.array_equal(np.asarray(a), b), f
        elif isinstance(b, float) and np.isnan(b):
            assert np.isnan(a), f
        else:
            assert a == b, f


def test_field_order_is_the_references():
    assert [f.name for f in dataclasses.fields(NMFResult)] == \
        [f.name for f in dataclasses.fields(RefNMFResult)]


CALLS = {
    "subset_factors": lambda r: r.subset_factors([3, 0]),
    "subset_factors_scalar": lambda r: r.subset_factors(2),
    "subset_rows": lambda r: r.subset(rows=[1, 4, 9]),
    "subset_cols": lambda r: r.subset(cols=np.arange(5, 15)),
    "subset_both": lambda r: r.subset(rows=[0, 2], cols=[3, 1]),
    "getitem_factors": lambda r: r[[1, 2]],
    "getitem_rows_cols": lambda r: r[[0, 5, 7], [2, 3]],
    "t": lambda r: r.t(),
    "t_t": lambda r: r.t().t(),
}


@pytest.mark.parametrize("call", list(CALLS))
def test_result_methods_match_reference(call, models):
    ref, port, _, _ = models
    _same(CALLS[call](port), CALLS[call](ref))


def test_t_carries_misc_and_swaps_axis_fields(models):
    ref, port, _, _ = models
    ref.pi_row, port.pi_row = np.arange(M, dtype=np.float32), \
        np.arange(M, dtype=np.float32)
    try:
        got, want = port.t(), ref.t()
        _same(got, want)
        assert np.array_equal(got.pi_col, np.arange(M))
        assert got.misc.keys() == want.misc.keys()
        assert got.misc is not port.misc
    finally:
        ref.pi_row = port.pi_row = None


@pytest.mark.parametrize("n", [3, 6, 100])
def test_prod_and_head_match_reference(models, n):
    ref, port, _, _ = models
    assert np.array_equal(port.prod(), ref.prod())
    assert np.array_equal(port.prod(), port.reconstruct())
    assert np.array_equal(port.head(n), ref.head(n))


@pytest.mark.parametrize("groups", [
    np.repeat(["b", "a", "c", "d"], N // 4),
    np.arange(N) % 3,
    np.asarray(["x"] * N)])
def test_summary_matches_reference_and_plots(models, groups):
    ref, port, _, _ = models
    got = port.summary(groups)
    assert got.shape == (K, len(np.unique(groups)))
    assert np.array_equal(got, ref.summary(groups))
    import matplotlib
    matplotlib.use("Agg")
    fig = rtt.plot_summary(got)
    assert fig is not None


@pytest.mark.parametrize("method", ["cosine", "cor"])
def test_align_to_matches_reference(models, method):
    ref, port, ref_other, port_other = models
    # a permuted copy aligns back to the original order
    perm = [3, 0, 4, 1, 2]
    _same(port.subset_factors(perm).align_to(port, method=method),
          ref.subset_factors(perm).align_to(ref, method=method))
    assert np.array_equal(
        port.subset_factors(perm).align_to(port, method=method).W, port.W)
    # and another fit aligns as in the JAX package
    _same(port_other.align_to(port, method=method),
          ref_other.align_to(ref, method=method))


def test_align_to_errors_match_reference(models):
    ref, port, _, _ = models
    errors = []
    for a, b in ((port, port.subset_factors([0, 1])),
                 (ref, ref.subset_factors([0, 1]))):
        with pytest.raises(ValueError) as exc:
            a.align_to(b)
        errors.append(str(exc.value))
        with pytest.raises(ValueError, match="align method"):
            a.align_to(a, method="euclid")
    assert errors[0] == errors[1]
