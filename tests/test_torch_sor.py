"""Port parity, statistical outlier removal: `ops/sor.py` against the JAX
package's exact path on the same numpy clouds (the reference's SOR cases
of tests/test_dense.py, each run through both packages).

Tolerance: each point's mean k-NN distance within 1e-5 relative of the
reference's, plus the float32 cancellation of ||q||^2 + ||r||^2 - 2 q.r:
a squared distance is resolved to a few ulps of the squared norms, 4 eps
max|p|^2, which a distance d carries as that over d (the two packages sum
the dot products and the k + 1 distances in other orders; on a cloud 20-40
m out that is 5.7e-5 relative, measured). The keep-masks are equal on every
point whose mean distance is not within 1e-4 (relative) of the keep
threshold; the count of points inside that margin is reported.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereovision_slam_tpu.ops import sor as jsor
from stereovision_slam_torch.ops import sor

torch.set_num_threads(1)

MEAN_TOL = 1e-5
KEEP_MARGIN = 1e-4


def _reference_means(pts, mean_k, max_ref, chunk, seed):
    """The JAX package's per-point mean k-NN distances, by its own
    `_mean_knn_chunk` over the same chunks and reference set."""
    N = len(pts)
    k = min(mean_k, N - 1, min(N, max_ref) - 1)
    if N > max_ref:
        ref = pts[np.random.default_rng(seed).choice(N, max_ref,
                                                      replace=False)]
    else:
        ref = pts
    nc = -(-N // chunk)
    padded = np.zeros((nc * chunk, 3), np.float32)
    padded[:N] = pts
    return np.concatenate([np.asarray(jsor._mean_knn_chunk(
        jnp.asarray(padded[i * chunk:(i + 1) * chunk]), jnp.asarray(ref), k))
        for i in range(nc)])[:N]


def _hold(pts, **kw):
    """The port's keep-mask on the CPU held to the reference's."""
    pts = np.asarray(pts, np.float32)
    want = jsor.statistical_outlier_removal(pts, **kw)
    got = sor.statistical_outlier_removal(pts, device="cpu", **kw)
    assert got.shape == want.shape and got.dtype == np.bool_
    if len(pts) < 3:      # no spread: every point sits at the threshold
        np.testing.assert_array_equal(got, want)
        return got
    args = dict(mean_k=kw.get("mean_k", 50), max_ref=kw.get("max_ref", 16384),
                chunk=kw.get("chunk", 1024), seed=kw.get("seed", 0))
    mine, _ = sor.mean_knn_distances(pts, device="cpu", **args)
    ref = _reference_means(pts, **args)
    cancel = (4 * np.finfo(np.float32).eps * float(np.max(np.sum(
        np.square(pts), axis=1))) / np.maximum(ref, 1e-6))
    assert np.all(np.abs(mine - ref) <= MEAN_TOL * ref + cancel)
    away = sor.threshold_margin(mine, kw.get("std_ratio", 1.0)) > KEEP_MARGIN
    print(f"points within {KEEP_MARGIN} of the keep threshold: "
          f"{int((~away).sum())} of {len(pts)}")
    np.testing.assert_array_equal(got[away], want[away])
    return got


def test_drops_isolated_points():
    rng = np.random.default_rng(3)
    cluster = rng.normal(0.0, 0.5, (2000, 3)).astype(np.float32)
    outliers = np.array([[50., 0., 0.], [0., 80., 0.], [-60., -60., 20.]],
                        np.float32)
    keep = _hold(np.concatenate([cluster, outliers]), mean_k=50,
                 std_ratio=1.0)
    assert not keep[-3:].any()
    assert keep[:-3].mean() > 0.6


def test_subsampled_reference():
    rng = np.random.default_rng(4)
    cluster = rng.normal(0.0, 1.0, (5000, 3)).astype(np.float32)
    outliers = rng.uniform(100, 200, (20, 3)).astype(np.float32)
    keep = _hold(np.concatenate([cluster, outliers]), mean_k=20,
                 std_ratio=1.0, max_ref=1024, chunk=512)
    assert not keep[-20:].any()
    assert keep[:-20].mean() > 0.6


@pytest.mark.parametrize("n", [0, 1, 2])
def test_tiny_inputs(n):
    keep = _hold(np.random.default_rng(n).normal(size=(n, 3)))
    assert keep.shape == (n,)


def test_mean_k_exceeds_reference():
    rng = np.random.default_rng(5)
    keep = _hold(rng.normal(size=(3000, 3)), mean_k=2000, max_ref=512,
                 chunk=512)
    assert keep.mean() > 0.5


def test_no_subsample_bias():
    rng = np.random.default_rng(6)
    pts = rng.uniform(-5, 5, (4000, 3)).astype(np.float32)
    keep = _hold(pts, mean_k=20, std_ratio=1.0, max_ref=1024, chunk=512,
                 seed=7)
    sel = np.zeros(4000, bool)
    sel[np.random.default_rng(7).choice(4000, 1024, replace=False)] = True
    assert abs(keep[sel].mean() - keep[~sel].mean()) < 0.1


def test_far_cloud_and_chunks_per_launch(monkeypatch):
    """A wall 20-40 m out (the dense tool's range, where the float32
    cancellation bites): held to the reference, and the same bits for any
    tile size and any number of tiles per launch."""
    rng = np.random.default_rng(8)
    pts = np.stack([rng.uniform(-10, 10, 3000), rng.uniform(-2, 2, 3000),
                    rng.uniform(20, 40, 3000)], axis=1).astype(np.float32)
    keep = _hold(pts, mean_k=50, max_ref=2048, chunk=256)
    kw = dict(mean_k=50, max_ref=2048, device="cpu")
    whole, _ = sor.mean_knn_distances(pts, chunk=256, **kw)
    for chunk in (256, 1000):
        # one tile a launch: 12 and 3 launches
        monkeypatch.setattr(sor, "LAUNCH_ELEMS", chunk * 2048)
        one, _ = sor.mean_knn_distances(pts, chunk=chunk, **kw)
        np.testing.assert_array_equal(one, whole)
    assert keep.mean() > 0.5


def test_approx_is_refused():
    with pytest.raises(ValueError, match="approx"):
        sor.statistical_outlier_removal(np.zeros((10, 3)), method="approx",
                                        device="cpu")
