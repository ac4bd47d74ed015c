"""The port's clustering (``bipartition``, ``dclust``, ``consensus_nmf``,
``bipartite_match``, ``align_factors``) against the JAX package's, on the
CPU.

Both packages get the same seeded numpy inputs.  Tolerances:

* ``bipartition``: ``samples1`` / ``samples2`` equal, ``v`` within 1e-4 of
  max|v|, ``dist`` within 1e-4 and the centers within 1e-4 of their largest
  entry, against both of the JAX package's branches (the device-resident
  one and the host one with its numpy ``_rel_cosine``; the port computes
  the separation as the device branch does, so the host branch's ``dist``
  is held to the tolerance, not bit for bit).
* ``dclust``: on planted groups whose every split falls between groups (a
  sample near v = 0 could land on either side when two implementations
  round differently), the same ids and sample sets, ``dist`` within 1e-4.
* ``bipartite_match`` / ``align_factors``: equal results (host copies).
* ``consensus_nmf``: the consensus matrix within 1e-12, the labels equal,
  the cophenetic correlation within 1e-6, on separated data; the
  ``knn_jaccard`` data has groups of knn + 1 = 16 samples, so that every
  neighbour set is a group (no tie decides one).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from rcppml_tpu.models import clustering as ref

import rcppml_tpu_torch as rtt
from rcppml_tpu_torch.models import clustering

TOL = 1e-4


def planted_groups(m, n, levels, seed=0, noise=0.5):
    """Cells in 2**levels groups on a binary tree of gene programs: at level
    l each group expresses the gene block of its path's prefix with weight
    2**(levels - l), so every rank-2 split falls between groups."""
    rs = np.random.RandomState(seed)
    labels = np.arange(n) * 2 ** levels // n
    depth = rs.uniform(0.8, 1.2, n)
    A = rs.uniform(0, noise, (m, n))
    for lev in range(1, levels + 1):
        blocks = np.array_split(rs.permutation(m), 2 ** lev)
        for b, rows in enumerate(blocks):
            prog = 2.0 ** (levels - lev) * rs.uniform(0.5, 1.5, len(rows))
            cols = np.flatnonzero(labels >> (levels - lev) == b)
            A[np.ix_(rows, cols)] += prog[:, None] * depth[cols]
    return A.astype(np.float32), labels


def disjoint_groups(m, groups, per, seed):
    """``groups`` groups of ``per`` samples, each on its own gene block."""
    rs = np.random.RandomState(seed)
    labels = np.arange(groups * per) // per
    A = rs.uniform(0, 0.1, (m, groups * per))
    for g, rows in enumerate(np.array_split(rs.permutation(m), groups)):
        cols = np.flatnonzero(labels == g)
        A[np.ix_(rows, cols)] += (rs.uniform(0.5, 1.5, len(rows))[:, None]
                                  * rs.uniform(0.8, 1.2, len(cols))[None, :])
    return A.astype(np.float32), labels


def two_blobs(seed=0, m=30, n1=40, n2=50):
    """The JAX package's own test matrix (tests/test_clustering.py)."""
    rs = np.random.RandomState(seed)
    c1 = rs.rand(m) * 2
    c2 = rs.rand(m) * 2 + np.r_[np.ones(m // 2) * 3, np.zeros(m - m // 2)]
    A1 = np.abs(c1[:, None] + 0.1 * rs.randn(m, n1))
    A2 = np.abs(c2[:, None] + 0.1 * rs.randn(m, n2))
    return np.hstack([A1, A2]).astype(np.float32)


def _same_split(port, want, centers=True):
    np.testing.assert_array_equal(port.samples1, want.samples1)
    np.testing.assert_array_equal(port.samples2, want.samples2)
    assert (port.size1, port.size2) == (want.size1, want.size2)
    assert np.abs(port.v - want.v).max() <= TOL * np.abs(want.v).max()
    assert abs(port.dist - want.dist) <= TOL
    if centers:
        for a, b in ((port.center1, want.center1),
                     (port.center2, want.center2)):
            assert np.abs(a - b).max() <= TOL * np.abs(b).max()


@pytest.mark.parametrize("branch", ["device", "host", "host_samples"])
@pytest.mark.parametrize("seed", [0, 1, 42])
def test_bipartition_matches_reference(branch, seed):
    A = two_blobs()
    samples = None
    if branch == "device":
        want = ref.bipartition(jnp.asarray(A), seed=seed)
    elif branch == "host":
        want = ref.bipartition(A, seed=seed)
    else:
        samples = np.arange(5, 85, 2)
        want = ref.bipartition(A, seed=seed, samples=samples)
    port = rtt.bipartition(A, seed=seed, samples=samples, device="cpu")
    _same_split(port, want)


@pytest.mark.parametrize("kw", [dict(maxit=5), dict(tol=1e-2),
                                dict(calc_dist=False), dict(nonneg=False)])
def test_bipartition_options_match_reference(kw):
    A, _ = planted_groups(50, 64, 2, seed=4)
    want = ref.bipartition(jnp.asarray(A), seed=3, **kw)
    port = rtt.bipartition(A, seed=3, device="cpu", **kw)
    _same_split(port, want, centers=kw.get("calc_dist", True))
    if not kw.get("calc_dist", True):
        assert port.dist == -1.0 and port.center1 is None


def test_bipartition_takes_sparse_and_tensor_input_and_repeats():
    A = two_blobs(seed=3)
    first = rtt.bipartition(sp.csc_matrix(A), seed=7, device="cpu")
    again = rtt.bipartition(torch.from_numpy(A), seed=7)
    np.testing.assert_array_equal(first.v, again.v)
    np.testing.assert_array_equal(first.samples1, again.samples1)
    assert first.dist == again.dist


@pytest.mark.parametrize("maxit", [5, 10, 35, 100])
def test_bipartition_reads_the_host_once_a_block(maxit):
    A = two_blobs(seed=2)
    before = clustering._rank2_als.host_reads
    # tol < 0: no block ends the loop early (1 - cor can round below 0)
    rtt.bipartition(A, seed=1, maxit=maxit, tol=-1.0, device="cpu")
    assert clustering._rank2_als.host_reads - before == max(1, maxit // 10)


def test_entry_points_go_to_the_card_by_default(monkeypatch):
    """A host array with no ``device=`` runs on the card; without one that
    raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = two_blobs()
    for call in (lambda: rtt.bipartition(A),
                 lambda: rtt.dclust(A, min_samples=20),
                 lambda: rtt.consensus_nmf(A, 2, n_runs=1, maxit=2)):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            call()


def _same_tree(port, want):
    assert [c.id for c in port] == [c.id for c in want]
    for a, b in zip(port, want):
        np.testing.assert_array_equal(a.samples, b.samples)
        assert (a.size, a.leaf) == (b.size, b.leaf)
        assert abs(a.dist - b.dist) <= TOL
        assert np.abs(a.center - b.center).max() <= TOL * np.abs(
            b.center).max()


@pytest.mark.parametrize("levels,n,min_samples", [(3, 96, 7), (4, 160, 6)])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_dclust_matches_reference_on_planted_groups(levels, n, min_samples,
                                                    seed):
    A, labels = planted_groups(60, n, levels, seed=seed)
    want = ref.dclust(A, min_samples=min_samples, seed=3)
    port = rtt.dclust(A, min_samples=min_samples, seed=3, device="cpu")
    _same_tree(port, want)
    # the partition covers every column exactly once, and each leaf is one
    # planted group
    leaves = np.concatenate([c.samples for c in port])
    assert sorted(leaves.tolist()) == list(range(n))
    assert len(port) == 2 ** levels
    assert all(len(np.unique(labels[c.samples])) == 1 for c in port)


@pytest.mark.parametrize("kw", [dict(min_samples=25), dict(min_samples=40),
                                dict(max_depth=2), dict(maxit=20, seed=9)])
def test_dclust_options_match_reference(kw):
    A, _ = planted_groups(60, 160, 4, seed=2)
    kw = {"min_samples": 6, **kw}
    want = ref.dclust(A, **kw)
    _same_tree(rtt.dclust(A, device="cpu", **kw), want)
    assert all(c.size >= kw["min_samples"] or c.id == "0" for c in want)


@pytest.mark.parametrize("min_dist,leaves", [(0.002, 8), (0.02, 4),
                                             (0.2, 2)])
def test_dclust_min_dist_matches_reference(min_dist, leaves):
    """Thresholds between the tree's levels of separation (about 0.46 at
    the root, 0.04, 0.006 and 0.0005 below), so that no split sits near
    one: the same splits are refused in both packages."""
    A, _ = planted_groups(60, 160, 4, seed=2)
    want = ref.dclust(A, min_samples=6, seed=3, min_dist=min_dist)
    port = rtt.dclust(A, min_samples=6, seed=3, min_dist=min_dist,
                      device="cpu")
    _same_tree(port, want)
    assert len(want) == leaves


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bipartite_match_and_align_factors_match_reference(seed):
    rs = np.random.RandomState(seed)
    cost = rs.rand(6, 6)
    want, port = ref.bipartite_match(cost), rtt.bipartite_match(cost)
    assert port["cost"] == want["cost"]
    np.testing.assert_array_equal(port["pairs"], want["pairs"])
    assert rtt.bipartiteMatch is rtt.bipartite_match
    W = np.abs(rs.rand(40, 5))
    W2 = W[:, rs.permutation(5)] + 0.01 * rs.rand(40, 5)
    perm_w, cos_w = ref.align_factors(W, W2)
    perm_p, cos_p = rtt.align(W, W2)
    np.testing.assert_array_equal(perm_p, perm_w)
    np.testing.assert_array_equal(cos_p, cos_w)


@pytest.mark.parametrize("method,per,k", [("hard", 20, 2), ("hard", 20, 3),
                                          ("knn_jaccard", 16, 2),
                                          ("knn_jaccard", 16, 3)])
@pytest.mark.parametrize("seed", [5, 6])
def test_consensus_nmf_matches_reference(method, per, k, seed):
    A, _ = disjoint_groups(40, 4, per, seed)
    kw = dict(n_runs=4, maxit=40, method=method)
    want = ref.consensus_nmf(A, k, **kw)
    port = rtt.consensus_nmf(A, k, device="cpu", **kw)
    assert port["consensus"].dtype == np.float64
    assert np.abs(port["consensus"] - want["consensus"]).max() <= 1e-12
    np.testing.assert_array_equal(port["labels"], want["labels"])
    assert abs(port["cophenetic"] - want["cophenetic"]) <= 1e-6
    assert port["k"] == k and len(port["runs"]) == 4
    np.testing.assert_array_equal(np.diag(port["consensus"]), 1.0)


def test_knn_jaccard_orders_ties_by_index():
    """A duplicated column ties at distance 0: the stable sort keeps the
    lower index first, and the sample itself is dropped only where it comes
    first."""
    H = torch.tensor([[1.0, 1.0, 5.0, 9.0], [0.0, 0.0, 1.0, 2.0]])
    jac = clustering._knn_jaccard(H, 1)
    # neighbours: 0 -> 1; 1 -> 1 (itself: 0 sorts before it); 2 -> 0 (0, 1
    # and 3 tie at 17); 3 -> 2
    assert jac.dtype == torch.float64
    np.testing.assert_array_equal(jac.numpy(), [[1, 1, 0, 0], [1, 1, 0, 0],
                                                [0, 0, 1, 0], [0, 0, 0, 1]])
