"""The port's whole-fit Newton-Schulz ALS path against the JAX package's, on
the CPU.

The Pallas kernels cannot run here (their specs name TPU memory), so the JAX
side is what the JAX package's own tests use off the TPU: ``_ns_als_xla`` for
``fused_als_vmem`` and ``jnp.dot(..., precision=HIGHEST)`` for the two
tall-skinny products.  On the CPU the port's wrappers run their plain twins.

Tolerances.  float32: loss rtol 1e-4 + 10 * eps * tr(A'A) (the Gram-trick
cancellation floor), W_T / H / d within 2e-3 of their largest entry, the MSE
path's bar.  bfloat16 data: loss rtol 1e-2, factors 2e-2, because an operand
that differs in its last float32 bit can round to another bfloat16.  The
bfloat16 cases use noisy data, whose loss stays well above
2^-8 * tr(A'A), the cancellation floor of a loss whose cross term saw
rounded data.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import rcppml_tpu as rt
from rcppml_tpu.models import nmf as ref_nmf
from rcppml_tpu.ops import linalg as ref_linalg

import rcppml_tpu_torch as rtt
from rcppml_tpu_torch import convert, rng
from rcppml_tpu_torch.ops import _build, fused_als, linalg, rhs_tall
from rcppml_tpu_torch.utils.simulate import simulate_nmf

EPS32 = float(np.finfo(np.float32).eps)
SHAPES = {"256x200": (256, 200, 6), "131x77": (131, 77, 5)}
PENALTIES = dict(l1_w=0.01, l1_h=0.02, l2_w=0.05, l2_h=0.03)


def _noisy(m, n, k, seed=3):
    return simulate_nmf(m, n, k, noise=0.5, seed=seed)["A"]


def _planted(m=160, n=120, k=5, noise=0.0, seed=0):
    rs = np.random.RandomState(seed)
    W = np.abs(rs.normal(size=(m, k))).astype(np.float32)
    H = np.abs(rs.normal(size=(k, n))).astype(np.float32)
    A = W @ H
    if noise:
        A = A + noise * rs.rand(m, n).astype(np.float32)
    return np.maximum(A, 0.0).astype(np.float32)


def _start(m, n, k, seed=1):
    return (rng.fill_uniform(seed, k, m),
            rng.fill_uniform(seed, k, n, offset=k * m))


def _close(port, ref, tol):
    p, r = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert p.shape == r.shape
    err = np.abs(p - r).max() / np.abs(r).max()
    assert err < tol, err


def _loss_close(port, ref, A, bf16):
    p, r = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert p.shape == r.shape and np.isfinite(p).all()
    trAtA = float((np.asarray(A, np.float64) ** 2).sum())
    allow = (1e-2 if bf16 else 1e-4) * np.abs(r) + 10 * EPS32 * trAtA
    assert np.all(np.abs(p - r) <= allow), np.abs(p - r) / allow


# ---------------------------------------------------------------------------
# Build: headers are part of a library's name
# ---------------------------------------------------------------------------

def test_header_edit_changes_library_path(tmp_path, monkeypatch):
    (tmp_path / "kern.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "other.cu").write_text("// no include\n")
    (tmp_path / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("kern"), _build.library_path("other")
    assert before[0] == _build.library_path("kern")      # stable
    (tmp_path / "shared.cuh").write_text("// v2\n")
    after = _build.library_path("kern"), _build.library_path("other")
    assert after[0] != before[0] and after[1] != before[1]
    (tmp_path / "kern.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert _build.library_path("kern") != after[0]
    assert _build.library_path("other") == after[1]
    (tmp_path / "new.cuh").write_text("// another header\n")
    assert _build.library_path("other") != after[1]


def test_every_source_and_header_is_found():
    assert {"rhs_tall", "fused_als"} <= set(_build.kernel_names())
    assert (_build.CSRC / "rhs_tall.cuh").exists()
    for name in ("rhs_tall", "fused_als"):
        source = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "rhs_tall.cuh"' in source


# ---------------------------------------------------------------------------
# Kernels 7 and 8: the plain twins against jnp.dot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 6, 50])
@pytest.mark.parametrize("shape", [(256, 200), (131, 77)],
                         ids=["256x200", "131x77"])
def test_rhs_tall_twins_match_jnp_dot(shape, k, bf16):
    m, n = shape
    rs = np.random.RandomState(k + m)
    A = (rs.rand(m, n) * (rs.rand(m, n) < 0.3)).astype(np.float32)
    F = rs.rand(k, m).astype(np.float32)
    H = rs.rand(k, n).astype(np.float32)
    if bf16:
        A_j = jnp.asarray(A).astype(jnp.bfloat16)
        ref_f = jnp.dot(jnp.asarray(F).astype(jnp.bfloat16), A_j,
                        preferred_element_type=jnp.float32)
        ref_t = jax.lax.dot_general(
            jnp.asarray(H).astype(jnp.bfloat16), A_j,
            (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32)
        A_t = torch.from_numpy(A).to(torch.bfloat16)
    else:
        hi = jax.lax.Precision.HIGHEST
        ref_f = jnp.dot(jnp.asarray(F), jnp.asarray(A), precision=hi)
        ref_t = jnp.dot(jnp.asarray(H), jnp.asarray(A).T, precision=hi)
        A_t = torch.from_numpy(A)
    before = rhs_tall.rhs_tall.launches, rhs_tall.rhs_tall_t.launches
    out_f = rhs_tall.rhs_tall(torch.from_numpy(F), A_t)
    out_t = rhs_tall.rhs_tall_t(torch.from_numpy(H), A_t)
    # a CPU tensor runs the twin: no launch is counted
    assert before == (rhs_tall.rhs_tall.launches,
                      rhs_tall.rhs_tall_t.launches)
    assert out_f.dtype == out_t.dtype == torch.float32
    assert out_f.shape == (k, n) and out_t.shape == (k, m)
    _close(out_f.numpy(), ref_f, 1e-5)
    _close(out_t.numpy(), ref_t, 1e-5)
    assert torch.equal(out_f,
                       rhs_tall.rhs_tall_plain(torch.from_numpy(F), A_t))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_linalg_rhs_matches_reference(bf16):
    """``rhs`` of both operand layouts the loop gives it: A and the
    transposed view A.T, float32 and bfloat16."""
    rs = np.random.RandomState(0)
    A = rs.rand(60, 40).astype(np.float32)
    F, H = rs.rand(4, 60).astype(np.float32), rs.rand(4, 40).astype(np.float32)
    A_j, A_t = jnp.asarray(A), torch.from_numpy(A)
    if bf16:
        A_j, A_t = A_j.astype(jnp.bfloat16), A_t.to(torch.bfloat16)
    _close(linalg.rhs(torch.from_numpy(F), A_t).numpy(),
           ref_linalg.rhs(jnp.asarray(F), A_j), 1e-5)
    _close(linalg.rhs(torch.from_numpy(H), A_t.T).numpy(),
           ref_linalg.rhs(jnp.asarray(H), A_j.T), 1e-5)


@pytest.mark.parametrize("bad", ["shape", "dtype", "small_dtype"])
def test_rhs_tall_rejects_bad_operands(bad):
    F, A = torch.ones(3, 8), torch.ones(8, 5)
    if bad == "shape":
        with pytest.raises(ValueError, match="do not fit"):
            rhs_tall.rhs_tall(F, torch.ones(7, 5))
        with pytest.raises(ValueError, match="do not fit"):
            rhs_tall.rhs_tall_t(F, A)
    elif bad == "dtype":
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            rhs_tall.rhs_tall(F, A.to(torch.float64))
    else:
        with pytest.raises(TypeError, match="small operand"):
            rhs_tall.rhs_tall(F.to(torch.bfloat16), A)


@pytest.mark.parametrize("R,J,k", [(13714, 2638, 20), (2638, 13714, 20),
                                   (3867, 610, 50), (610, 3867, 50),
                                   (77, 1001, 1), (1001, 77, 128),
                                   (13714, 20, 20), (100000, 64, 150)])
def test_plan_splits_covers_the_reduction(R, J, k):
    splits, chunk = rhs_tall.plan_splits(R, J, k)
    assert splits >= 1 and chunk % rhs_tall.TILE_DEPTH == 0
    assert splits * chunk >= R > (splits - 1) * chunk
    assert (splits, chunk) == rhs_tall.plan_splits(R, J, k)
    capped, _ = rhs_tall.plan_splits(R, J, k, max_splits=4)
    assert capped <= 4


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("R,J,k", [(13714, 2638, 20), (2638, 13714, 20),
                                   (3867, 610, 50), (610, 3867, 50),
                                   (77, 1001, 1), (1001, 77, 128),
                                   (13714, 20, 20), (100000, 64, 150)])
def test_plan_tall_covers_the_reduction(R, J, k, bf16):
    """Stream-K: the runs of the blocks cover every (tile, stage) unit once,
    in order, in lengths that differ by at most one, and touch at most two
    tiles each."""
    depth = rhs_tall.TALL_DEPTH[torch.bfloat16 if bf16 else torch.float32]
    blocks = rhs_tall.plan_tall(R, J, k, bf16)
    assert blocks == rhs_tall.plan_tall(R, J, k, bf16)
    tiles, spt = -(-J // rhs_tall.TALL_COLS), -(-R // depth)
    assert tiles <= blocks <= max(tiles, 2 * rhs_tall.H100_SMS)
    assert blocks <= tiles * spt
    runs = rhs_tall.tall_runs(R, J, bf16, blocks)
    units = [(t, f + i) for pieces in runs for t, f, n in pieces
             for i in range(n)]
    assert units == [(t, s) for t in range(tiles) for s in range(spt)]
    lengths = [sum(n for _, _, n in pieces) for pieces in runs]
    assert max(lengths) - min(lengths) <= 1 and min(lengths) >= 1
    assert max(len(pieces) for pieces in runs) <= 2
    # the same number of blocks on every multiprocessor: two at the pbmc3k
    # shape (runs that follow the 21 tiles of B = F A, runs across the 108
    # of B = H A^T), one at the movielens shape, whose runs would otherwise
    # be two or three stages long
    sms = rhs_tall.H100_SMS
    want = {(13714, 2638): 2 * sms - 12, (2638, 13714): 2 * sms,
            (3867, 610): sms - 2, (610, 3867): sms - 8}
    if (R, J) in want:
        assert blocks == want[(R, J)]
    if blocks % tiles == 0:
        assert all(len(pieces) == 1 for pieces in runs)
    assert rhs_tall.pieces_floats(k, blocks) == 2 * blocks * k * 128


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_small_ld_gives_whole_stages(bf16):
    size = 2 if bf16 else 4
    for R in (1, 3, 7, 8, 9, 2638, 13714):
        ld = rhs_tall.small_ld(R, bf16)
        # whole stages of 256 bytes
        assert ld >= R and (ld * size) % 256 == 0 and (ld - R) * size < 256
        assert rhs_tall.small_floats(5, R, bf16) * 4 == \
            (1 if bf16 else 2) * 5 * ld * size


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_prepare_small_is_what_the_product_reads(bf16):
    """The small operand prepared for the tall product: rounded to bfloat16
    to nearest even, or split into TF32 parts that add up to it."""
    rs = np.random.RandomState(4)
    X = rs.normal(size=(5, 37)).astype(np.float32)
    # ties of bfloat16 and of TF32 (10 fraction bits)
    X[0, :4] = [1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, 1 + 2.0 ** -11,
                -(1 + 3 * 2.0 ** -11)]
    ld = rhs_tall.small_ld(37, bf16)
    buf = rhs_tall.prepare_small(torch.from_numpy(X), bf16)
    assert buf.shape == (rhs_tall.small_floats(5, 37, bf16),)
    if bf16:
        rows = buf.view(torch.bfloat16).view(5, ld)
        assert not rows[:, 37:].float().any()
        got = rows[:, :37]
        assert torch.equal(got, torch.from_numpy(X).to(torch.bfloat16))
        assert got[0, :2].float().tolist() == [1.0, 1 + 2.0 ** -6]
        return
    assert not buf.view(2, 5, ld)[:, :, 37:].any()
    hi, lo = buf.view(2, 5, ld)[:, :, :37]
    for part in (hi, lo):
        assert not (part.numpy().view(np.uint32) & 0x1FFF).any()
    # to nearest, ties away from zero
    assert hi[0, 2:4].tolist() == [1 + 2.0 ** -10, -(1 + 2 * 2.0 ** -10)]
    assert np.all(np.abs(hi.numpy() - X) <= 2.0 ** -11 * np.abs(X))
    assert np.all(np.abs(hi.numpy().astype(np.float64) + lo.numpy() - X)
                  <= 2.0 ** -22 * np.abs(X))


# ---------------------------------------------------------------------------
# Kernel 3: the plain twin against _ns_als_xla
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("pen", [False, True], ids=["plain", "L1L2"])
@pytest.mark.parametrize("maxit", [1, 20])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_fused_als_plain_matches_ns_als_xla(shape, maxit, pen, bf16):
    m, n, k = SHAPES[shape]
    A = _noisy(m, n, k)
    W_T0, H0 = _start(m, n, k)
    kw = dict(maxit=maxit, a_bf16=bf16, **(PENALTIES if pen else {}))
    ref = ref_nmf._ns_als_xla(jnp.asarray(A), jnp.asarray(W_T0),
                              jnp.asarray(H0), **kw)
    before = fused_als.fused_als.launches
    port = fused_als.fused_als(torch.from_numpy(A), torch.from_numpy(W_T0),
                               torch.from_numpy(H0), **kw)
    assert fused_als.fused_als.launches == before        # the twin ran
    _loss_close(port[3].numpy(), ref[3], A, bf16)
    for p, r in zip(port[:3], ref[:3]):
        _close(p.numpy(), r, 2e-2 if bf16 else 2e-3)


def test_fused_als_checks_its_operands():
    A, W, H = torch.ones(8, 6), torch.ones(2, 8), torch.ones(2, 6)
    with pytest.raises(ValueError, match="do not fit"):
        fused_als.fused_als(A, W, torch.ones(2, 7), maxit=2)
    with pytest.raises(ValueError, match="maxit"):
        fused_als.fused_als(A, W, H, maxit=0)
    with pytest.raises(TypeError, match="float32"):
        fused_als.fused_als(A.to(torch.bfloat16), W, H, maxit=2)


def test_phase_count_and_workspace_layout():
    assert fused_als.phase_count(20) == 264
    m, n, k = 13714, 2638, 20
    plan, offsets, total = fused_als._workspace(m, n, k, True, False, 132)
    assert len(plan) == 6 and len(offsets) == 13
    assert plan[4] == fused_als.refine_plan(k)[:3]
    # a partial Gram a cluster of blocks (or a split of the FMA tile)
    assert all(s * c * (fused_als.GRAM_CLUSTER if cl else 1) >= R
               for (s, c), R, cl in zip(plan[2:4], (m, n), plan[5]))
    assert plan[:2] == [(rhs_tall.plan_tall(m, n, k, False, 132), 0),
                        (rhs_tall.plan_tall(n, m, k, False, 132), 0)]
    assert offsets[3] - offsets[2] == rhs_tall.pieces_floats(k, plan[0][0])
    assert plan[2][0] <= fused_als.GRAM_MAX_SPLITS
    assert offsets[0] == 0 and np.all(np.diff(offsets) >= 0)
    assert total > offsets[-1]
    # without an L1 shift on W its shifted right-hand side takes no room
    assert fused_als._workspace(m, n, k, False, False, 132)[2] \
        == total - k * m
    # the factors prepared as the products' small operands come first, each
    # row on 16 bytes: two planes of TF32 parts, or bfloat16 values
    assert offsets[1] == rhs_tall.small_floats(k, m, False)
    assert offsets[2] - offsets[1] == rhs_tall.small_floats(k, n, False)
    plan_b, offsets_b, total_b = fused_als._workspace(m, n, k, True, True,
                                                      132)
    assert plan_b[:2] == [(rhs_tall.plan_tall(m, n, k, True, 132), 0),
                          (rhs_tall.plan_tall(n, m, k, True, 132), 0)]
    assert offsets_b[1] == rhs_tall.small_floats(k, m, True)
    assert offsets_b[2] - offsets_b[1] == rhs_tall.small_floats(k, n, True)
    assert offsets_b[1] % 4 == 0 and offsets_b[2] % 4 == 0


# ---------------------------------------------------------------------------
# The path: rtt.nmf(..., fused_vmem=True) against rt.nmf(..., fused_vmem=True)
# ---------------------------------------------------------------------------

PATH_CASES = {
    "f32": dict(),
    "bf16": dict(bf16_data=True),
    "L1L2": dict(L1=(0.01, 0.02), L2=(0.05, 0.03)),
    "maxit1": dict(maxit=1),
    "unsorted": dict(sort_model=False),
}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("case", list(PATH_CASES))
def test_fused_vmem_fit_matches_reference(case, shape):
    m, n, k = SHAPES[shape]
    A = _noisy(m, n, k)
    kw = dict(seed=2, maxit=20, tol=0.0, fused_vmem=True)
    kw.update(PATH_CASES[case])
    ref = rt.nmf(A, k, **kw)
    port = rtt.nmf(A, k, device="cpu", **kw)
    bf16 = bool(kw.get("bf16_data"))
    assert port.iterations == ref.iterations == kw["maxit"]
    assert port.converged is False and ref.converged is False
    _loss_close(port.loss_history, ref.loss_history, A, bf16)
    for name in ("W", "d", "H"):
        _close(getattr(port, name), getattr(ref, name),
               2e-2 if bf16 else 2e-3)
    assert np.isclose(port.train_loss, ref.train_loss,
                      rtol=1e-2 if bf16 else 1e-4)
    if kw["maxit"] > 1:
        assert np.isfinite(port.final_tol)
        # the relative step between the last two losses, each of them known
        # to the loss tolerance
        assert abs(port.final_tol - ref.final_tol) <= (2.5e-2 if bf16
                                                       else 2.5e-4)


def test_fused_vmem_result_shape_contract():
    A = _planted()
    res = rtt.nmf(A, 5, seed=1, maxit=30, tol=0.0, sort_model=False,
                  fused_vmem=True, device="cpu")
    assert res.iterations == 30
    assert res.converged is False          # fixed-iteration contract
    assert len(res.loss_history) == 30
    assert np.all(np.isfinite(res.loss_history))
    assert np.isfinite(res.final_tol)
    assert res.W.shape == (160, 5) and res.H.shape == (5, 120)
    assert np.all(res.W >= 0) and np.all(res.H >= 0) and np.all(res.d > 0)
    assert res.loss_history[-1] < res.loss_history[0]
    assert res.misc["config"].fused_vmem


def test_fused_vmem_deterministic():
    A = _planted(seed=5)
    kw = dict(seed=9, maxit=40, tol=0.0, sort_model=False, fused_vmem=True,
              device="cpu")
    r1, r2 = rtt.nmf(A, 5, **kw), rtt.nmf(A, 5, **kw)
    np.testing.assert_array_equal(r1.W, r2.W)
    np.testing.assert_array_equal(r1.H, r2.H)
    np.testing.assert_array_equal(r1.loss_history, r2.loss_history)


def test_fused_vmem_recovers_planted_rank_and_reaches_the_default_loss():
    A = _planted()
    res = rtt.nmf(A, 5, seed=7, maxit=200, tol=0.0, sort_model=False,
                  fused_vmem=True, device="cpu")
    rel = np.linalg.norm(A - res.reconstruct()) / np.linalg.norm(A)
    assert np.isfinite(rel) and rel < 0.05, rel
    # another solver (Newton-Schulz inverse, not Cholesky), the same ALS
    # fixed point: on noisy data the converged losses agree to 1e-2
    A = _planted(noise=0.3, seed=3)
    kw = dict(seed=7, maxit=300, tol=0.0, sort_model=False, device="cpu")
    base, fv = rtt.nmf(A, 5, **kw), rtt.nmf(A, 5, fused_vmem=True, **kw)
    b, f = base.loss_history[-1], fv.loss_history[-1]
    assert abs(b - f) / abs(b) < 1e-2, (b, f)


@pytest.mark.parametrize("kw,frag", [
    (dict(tol=1e-4), "tol"),
    (dict(tol=0.0, L21=(0.0, 0.1)), "tier-2 penalties"),
    (dict(tol=0.0, loss="kl"), "MSE"),
    (dict(tol=0.0, test_fraction=0.1, cv_seed=1), "CV"),
    (dict(tol=0.0, projective=True), "variants"),
    (dict(tol=0.0, symmetric=True), "variants"),
    (dict(tol=0.0, norm="L2"), "norms"),
    (dict(tol=0.0, nonneg=(True, False)), "nonneg"),
    (dict(tol=0.0, upper_bound=(0.0, 2.0)), "tier-2 penalties"),
    (dict(tol=0.0, robust=True), "MSE"),
    (dict(tol=0.0, on_iteration=lambda *a: None), "callback"),
    (dict(tol=0.0, profile=True), "profiling"),
], ids=["tol", "L21", "kl", "cv", "projective", "symmetric", "norm",
        "nonneg", "upper_bound", "robust", "on_iteration", "profile"])
def test_fused_vmem_rejects_unsupported(kw, frag):
    A = _planted(m=120, n=120)
    with pytest.raises(ValueError, match=frag):
        rtt.nmf(A, 5, fused_vmem=True, sort_model=False, device="cpu", **kw)


def test_fused_vmem_and_bf16_reject_mask_zeros_in_the_config():
    with pytest.raises(ValueError, match="CV/masks"):
        rtt.build_config(5, tol=0.0, fused_vmem=True,
                         mask_zeros=True).validate()
    with pytest.raises(ValueError, match="mask"):
        rtt.build_config(5, bf16_data=True, mask_zeros=True).validate()
    with pytest.raises(ValueError, match="bf16_data"):
        rtt.build_config(5, bf16_data=True, loss="kl")


def test_fused_vmem_odd_shapes_and_wide():
    rs = np.random.RandomState(8)
    W = np.abs(rs.normal(size=(97, 7))).astype(np.float32)
    H = np.abs(rs.normal(size=(7, 301))).astype(np.float32)
    A = np.maximum(W @ H + 0.1 * rs.rand(97, 301), 0).astype(np.float32)
    res = rtt.nmf(A, 7, seed=2, maxit=150, tol=0.0, sort_model=False,
                  fused_vmem=True, device="cpu")
    rel = np.linalg.norm(A - res.reconstruct()) / np.linalg.norm(A)
    assert rel < 0.1, rel


def test_fused_vmem_zero_columns_stay_finite():
    A = _planted(seed=4).copy()
    A[:, :10] = 0.0
    res = rtt.nmf(A, 5, seed=2, maxit=60, tol=0.0, sort_model=False,
                  fused_vmem=True, device="cpu")
    assert np.all(np.isfinite(res.W)) and np.all(np.isfinite(res.H))
    assert np.all(np.isfinite(res.loss_history))


def test_fused_vmem_sparse_input_densifies():
    A = _planted(seed=6)
    A[A < np.percentile(A, 60)] = 0.0
    kw = dict(seed=3, maxit=50, tol=0.0, sort_model=False, fused_vmem=True,
              device="cpu")
    res_s, res_d = rtt.nmf(sp.csc_matrix(A), 5, **kw), rtt.nmf(A, 5, **kw)
    np.testing.assert_array_equal(res_s.W, res_d.W)


def test_fused_vmem_degenerate_rank_d_floor():
    # k far above the data's rank: factor rows clipped to zero must give
    # d = 1e-15 (the clamp's floor), never 0 or NaN, as in the JAX package
    # (which rows die differs: the fit is chaotic on rank-one data)
    rs = np.random.RandomState(1)
    u = np.abs(rs.normal(size=(80, 1))).astype(np.float32)
    v = np.abs(rs.normal(size=(1, 60))).astype(np.float32)
    A = (u @ v).astype(np.float32)
    kw = dict(seed=3, maxit=60, tol=0.0, sort_model=False, fused_vmem=True)
    res, ref = rtt.nmf(A, 6, device="cpu", **kw), rt.nmf(A, 6, **kw)
    assert np.all(res.d >= 1e-15) and np.all(np.isfinite(res.d))
    assert np.all(np.isfinite(res.W)) and np.all(np.isfinite(res.H))
    assert (res.d == np.float32(1e-15)).any()
    assert (ref.d == np.float32(1e-15)).any()


def test_fused_vmem_l1_bites():
    A = _planted()
    kw = dict(tol=0.0, fused_vmem=True, seed=7, maxit=60, sort_model=False,
              device="cpu")
    pen = rtt.nmf(A, 5, L1=(0.0, 0.01), L2=(0.05, 0.0), **kw)
    free = rtt.nmf(A, 5, **kw)
    assert (pen.H == 0).mean() >= (free.H == 0).mean()


def test_fused_vmem_size_gate():
    from rcppml_tpu_torch.ops.fused_als import (check_gate, fused_vmem_bytes,
                                                fused_vmem_fits,
                                                kxk_scratch_floats)
    # both data sets' shapes fit, float32 and bfloat16; so does any k: past
    # k = 256 the k x k section moves from the shared memory of one block or
    # a cluster of blocks to device memory, which the bytes count
    assert fused_vmem_fits(13714, 2638, 20, False, 1020)
    assert fused_vmem_fits(3867, 610, 50, True, 1020)
    assert fused_vmem_fits(13714, 2638, 128, False, 100)
    assert fused_vmem_fits(200, 200, 138, False, 100)
    assert fused_vmem_fits(200, 200, 139, False, 100)
    assert fused_vmem_fits(300, 200, 150, False, 100)
    assert kxk_scratch_floats(138) == kxk_scratch_floats(256) == 0
    assert kxk_scratch_floats(257) == 4 * 272 * 268
    assert fused_vmem_bytes(300, 300, 257, False, 100) - fused_vmem_bytes(
        300, 300, 256, False, 100) > 4 * kxk_scratch_floats(257)
    check_gate(300, 200, 150, False, 100)
    # a matrix beyond the card's memory is refused
    assert not fused_vmem_fits(200000, 100000, 20, False, 100)
    assert fused_vmem_fits(200000, 100000, 20, True, 100)
    with pytest.raises(ValueError, match="device memory"):
        check_gate(200000, 100000, 20, False, 100)
    # bytes are monotone in every argument
    b0 = fused_vmem_bytes(1000, 1000, 10, False, 100)
    assert fused_vmem_bytes(2000, 1000, 10, False, 100) > b0
    assert fused_vmem_bytes(1000, 2000, 10, False, 100) > b0
    assert fused_vmem_bytes(1000, 1000, 20, False, 100) > b0
    assert fused_vmem_bytes(1000, 1000, 10, False, 200) > b0
    assert fused_vmem_bytes(1000, 1000, 10, True, 100) < b0


def test_fused_vmem_gate_asks_the_card(monkeypatch):
    """On a CUDA device the gate takes a share of that card's own memory and
    its own count of multiprocessors; the constants stand for the CPU."""
    from types import SimpleNamespace
    from rcppml_tpu_torch.ops import fused_als as fa
    assert fa.device_limit() == fa.device_limit("cpu") == fa.DEVICE_LIMIT
    small = SimpleNamespace(total_memory=16 * 2**30, multi_processor_count=40)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: small)
    assert fa.device_limit("cuda:0") == int(fa.DEVICE_SHARE * 16 * 2**30)
    # 21 GB of float32 A: inside the reference card's share, beyond this one's
    assert fa.fused_vmem_fits(100000, 50000, 20, False, 100)
    assert not fa.fused_vmem_fits(100000, 50000, 20, False, 100, "cuda:0")
    assert fa.fused_vmem_fits(100000, 50000, 20, True, 100, "cuda:0")
    with pytest.raises(ValueError, match="limit 12288 MB"):
        fa.check_gate(100000, 50000, 20, False, 100, "cuda:0")


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("pen", [False, True], ids=["plain", "L1L2"])
def test_plain_half_steps_compose_to_the_twin(pen, bf16):
    """``h_update_plain`` then ``w_update_plain`` from freshly seeded
    inverses is one iteration of ``fused_als_plain``, bit for bit."""
    m, n, k = 131, 77, 5
    A = torch.from_numpy(_noisy(m, n, k))
    W, H = (torch.from_numpy(x) for x in _start(m, n, k))
    pens = PENALTIES if pen else dict.fromkeys(PENALTIES, 0.0)
    A_mm, trata = fused_als.widened(A, bf16), (A * A).sum()
    for _ in range(3):
        ref = fused_als.fused_als_plain(A, W, H, maxit=1, a_bf16=bf16, **pens)
        Hn, _ = fused_als.h_update_plain(
            A_mm, W, fused_als.seed_inverse_plain(W, pens["l2_h"]),
            a_bf16=bf16, l1_h=pens["l1_h"], l2_h=pens["l2_h"])
        Wn, d, _, loss = fused_als.w_update_plain(
            A_mm, Hn, fused_als.seed_inverse_plain(H, pens["l2_w"]), trata,
            a_bf16=bf16, l1_w=pens["l1_w"], l2_w=pens["l2_w"])
        for out, want in zip((Wn, Hn, d, loss), (*ref[:3], ref[3][0])):
            assert torch.equal(out, want)
        W, H = Wn, Hn


def test_fused_vmem_fit_beyond_the_gate_raises(monkeypatch):
    """Nothing dispatches to the default loop instead: a fit beyond the
    device-memory gate (here a gate of 1 MiB) raises on the CPU too."""
    rs = np.random.RandomState(0)
    A = rs.rand(150, 145).astype(np.float32)
    monkeypatch.setattr(fused_als, "DEVICE_LIMIT", 2**20)
    with pytest.raises(ValueError, match="device memory"):
        rtt.nmf(A, 140, fused_vmem=True, tol=0.0, maxit=2, device="cpu")


# ---------------------------------------------------------------------------
# bf16_data on the default path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["cholesky", "cd", "L1", "projective",
                                     "symmetric"])
def test_bf16_data_fit_matches_reference(variant):
    kw = {"cholesky": {}, "cd": dict(solver="cd"), "L1": dict(L1=(0, 0.05)),
          "projective": dict(projective=True, solver="cd"),
          "symmetric": dict(symmetric=True)}[variant]
    A = _noisy(131, 77, 5)
    if variant == "symmetric":
        A = ((A[:77] + A[:77].T) / 2).astype(np.float32)
    common = dict(seed=1, maxit=15, tol=0, bf16_data=True)
    ref = rt.nmf(A, 5, **common, **kw)
    port = rtt.nmf(A, 5, device="cpu", **common, **kw)
    assert port.iterations == ref.iterations == 15
    _loss_close(port.loss_history, ref.loss_history, A, True)
    for name in ("W", "d", "H"):
        _close(getattr(port, name), getattr(ref, name), 2e-2)


def test_bf16_data_changes_the_trailing_digits_only():
    A = _noisy(131, 77, 5)
    kw = dict(seed=1, maxit=15, tol=0, device="cpu")
    full, half = rtt.nmf(A, 5, **kw), rtt.nmf(A, 5, bf16_data=True, **kw)
    assert not np.array_equal(full.loss_history, half.loss_history)
    np.testing.assert_allclose(half.loss_history, full.loss_history,
                               rtol=2e-2)


# ---------------------------------------------------------------------------
# Configs carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(fused_vmem=True, tol=0.0),
                                dict(bf16_data=True),
                                dict(fused_vmem=True, bf16_data=True, tol=0.0,
                                     L1=(0.01, 0.0))],
                         ids=["fused_vmem", "bf16_data", "both"])
def test_config_from_reference_copies_the_opt_in_knobs(kw):
    ref_cfg = rt.build_config(5, seed=3, maxit=7, **kw)
    cfg = convert.config_from_reference(ref_cfg)
    assert cfg.fused_vmem == ref_cfg.fused_vmem == bool(kw.get("fused_vmem"))
    assert cfg.bf16_data == ref_cfg.bf16_data == bool(kw.get("bf16_data"))
    assert cfg == rtt.build_config(5, seed=3, maxit=7, **kw)
    cfg.validate()
