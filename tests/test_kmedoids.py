import numpy as np
import pytest
from numpy.testing import assert_array_equal, assert_allclose

from enspara_tpu.cluster import (kmedoids, hybrid, KHybrid, KMedoids,
                                 kcenters)
from enspara_tpu.cluster.kmedoids import _kmedoids_pam_update, _msq
from enspara_tpu.geometry import libdist

# scikit-learn is a test-only dependency; without it the module skips
make_blobs = pytest.importorskip('sklearn.datasets').make_blobs


def test_kmedoids_blobs():
    X, y = make_blobs(n_samples=180, centers=3, cluster_std=0.3,
                      random_state=0)
    res = kmedoids(X, 'euclidean', n_clusters=3, n_iters=5,
                   random_state=0)
    assert len(res.center_indices) == 3
    for blob in range(3):
        assert len(np.unique(res.assignments[y == blob])) == 1
    # medoids must be members with distance ~0 to themselves
    assert np.all(res.distances[np.asarray(res.center_indices)] < 1e-5)


def test_kmedoids_cost_never_increases():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(120, 4))
    res0 = kmedoids(X, 'euclidean', n_clusters=8, n_iters=0 + 1,
                    random_state=3)
    cost_prev = _msq(res0.distances)
    res = res0
    for _ in range(4):
        res = kmedoids(X, 'euclidean', n_iters=1, random_state=4,
                       assignments=res.assignments,
                       distances=res.distances,
                       cluster_center_inds=res.center_indices)
        cost = _msq(res.distances)
        assert cost <= cost_prev + 1e-12
        cost_prev = cost


def test_pam_update_with_explicit_proposals():
    """With a proposal equal to the current medoid, nothing changes;
    with a better medoid, cost decreases."""
    rng = np.random.default_rng(2)
    X = np.concatenate([rng.normal(size=(50, 3)),
                        rng.normal(size=(50, 3)) + 10])
    seed = kcenters(X, 'euclidean', n_clusters=2)
    inds, dists, assigs, centers = _kmedoids_pam_update(
        X, libdist.euclidean,
        list(np.asarray(seed.center_indices)),
        seed.assignments, seed.distances,
        proposals=list(np.asarray(seed.center_indices)))
    assert_array_equal(inds, seed.center_indices)
    assert_array_equal(assigs, seed.assignments)


def test_hybrid_improves_on_kcenters():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(300, 4))
    kc = kcenters(X, 'euclidean', n_clusters=10)
    hy = hybrid(X, 'euclidean', n_iters=5, n_clusters=10,
                random_state=0)
    assert _msq(hy.distances) <= _msq(kc.distances)
    assert len(hy.center_indices) == 10
    assert np.all(hy.distances[np.asarray(hy.center_indices)] < 1e-5)


def test_khybrid_estimator():
    X, y = make_blobs(n_samples=150, centers=3, cluster_std=0.25,
                      random_state=7)
    est = KHybrid('euclidean', n_clusters=3, kmedoids_updates=2,
                  random_state=0).fit(X)
    for blob in range(3):
        assert len(np.unique(est.labels_[y == blob])) == 1


def test_kmedoids_rmsd():
    rng = np.random.default_rng(8)
    base = rng.normal(size=(2, 20, 3)).astype(np.float32) * 2
    frames = np.array([base[i % 2] + rng.normal(size=(20, 3)) * 0.01
                       for i in range(40)], dtype=np.float32)
    res = hybrid(frames, 'rmsd', n_iters=2, n_clusters=2,
                 random_state=0)
    labels = res.assignments
    assert len(np.unique(labels[::2])) == 1
    assert len(np.unique(labels[1::2])) == 1


def test_device_pam_sweeps_reduce_cost():
    from enspara_tpu.cluster.engine_kmedoids import kmedoids_sweeps_device

    rng = np.random.default_rng(10)
    X = np.concatenate([rng.normal(size=(100, 4)) + off
                        for off in (0, 6, 12)]).astype(np.float32)
    seed = kcenters(X, 'euclidean', n_clusters=6)
    c0 = _msq(seed.distances)

    m, d, a = kmedoids_sweeps_device(
        X, 'euclidean', seed.assignments, seed.distances,
        np.asarray(seed.center_indices), n_sweeps=5, seed=0)
    assert _msq(d) <= c0 + 1e-12
    # medoids are members with ~zero self distance
    assert np.all(d[m] < 1e-5)
    # assignments consistent with medoid set
    assert set(np.unique(a)) <= set(range(6))
    # determinism
    m2, d2, a2 = kmedoids_sweeps_device(
        X, 'euclidean', seed.assignments, seed.distances,
        np.asarray(seed.center_indices), n_sweeps=5, seed=0)
    assert_array_equal(m, m2)
    assert_array_equal(a, a2)


def test_device_pam_cache_consistency():
    # after many sweeps with accepts, the carried (d1, a1) state must
    # still equal a brute-force nearest-medoid recompute — this is the
    # invariant the FastPAM second-nearest cache has to preserve
    from enspara_tpu.cluster.engine_kmedoids import kmedoids_sweeps_device

    rng = np.random.default_rng(21)
    X = rng.normal(size=(300, 5)).astype(np.float32)  # no structure:
    # high acceptance churn stresses the cache-repair path
    seed = kcenters(X, 'euclidean', n_clusters=12)
    m, d, a = kmedoids_sweeps_device(
        X, 'euclidean', seed.assignments, seed.distances,
        np.asarray(seed.center_indices), n_sweeps=8, seed=3)
    full = np.linalg.norm(X[:, None, :] - X[m][None, :, :], axis=-1)
    assert_allclose(d, full.min(axis=1), rtol=1e-5, atol=1e-5)
    assert_allclose(full[np.arange(len(X)), a], full.min(axis=1),
                    rtol=1e-5, atol=1e-5)


def test_device_pam_sweeps_rmsd():
    from enspara_tpu.cluster.engine_kmedoids import kmedoids_sweeps_device

    rng = np.random.default_rng(11)
    base = rng.normal(size=(2, 15, 3)).astype(np.float32)
    X = np.array([base[i % 2] + rng.normal(size=(15, 3)) * 0.05
                  for i in range(60)], dtype=np.float32)
    seed = kcenters(X, 'rmsd', n_clusters=2)
    m, d, a = kmedoids_sweeps_device(
        X, 'rmsd', seed.assignments, seed.distances,
        np.asarray(seed.center_indices), n_sweeps=3, seed=1)
    assert _msq(d) <= _msq(seed.distances) + 1e-9
    assert len(np.unique(a[::2])) == 1
    assert len(np.unique(a[1::2])) == 1


def test_hybrid_device_end_to_end():
    from enspara_tpu.cluster import hybrid_device

    rng = np.random.default_rng(12)
    X = np.concatenate([rng.normal(size=(80, 3)) + off
                        for off in (0, 8)]).astype(np.float32)
    seed = kcenters(X, 'euclidean', n_clusters=2)
    res = hybrid_device(X, 'euclidean', n_iters=3, n_clusters=2,
                        seed=0)
    assert len(res.center_indices) == 2
    # PAM refinement should not be worse than the kcenters seed and
    # should land near the per-cluster chi^2_3 mean (~3)
    assert _msq(res.distances) <= _msq(seed.distances) + 1e-9
    assert _msq(res.distances) < 6.0
    labels = res.assignments
    assert len(np.unique(labels[:80])) == 1
    assert len(np.unique(labels[80:])) == 1


def test_kmedoids_n_iters_zero_returns_warm_start():
    """n_iters=0 returns the warm-start state on the host path too
    (r5 review: it returned None while the device path returned a
    ClusterResult)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(60, 4)).astype(np.float32)
    res = kmedoids(X, 'euclidean', n_clusters=3, n_iters=0,
                   random_state=0)
    assert res is not None
    assert len(res.center_indices) == 3
    assert res.assignments.shape == (60,)


def test_hybrid_threads_mesh_to_pam_stage():
    """A caller-pinned mesh must reach the k-medoids stage (r5 review:
    the device sweeps silently fell back to a mesh over ALL
    devices)."""
    import jax
    from jax.sharding import Mesh
    from enspara_tpu.cluster.hybrid import hybrid
    from enspara_tpu.parallel.mesh import FRAME_AXIS

    mesh = Mesh(np.array(jax.devices()[:1]), (FRAME_AXIS,))
    rng = np.random.default_rng(1)
    X = rng.normal(size=(128, 4)).astype(np.float32)
    res = hybrid(X, 'euclidean', n_iters=1, n_clusters=3,
                 random_state=0, mesh=mesh)
    assert len(res.center_indices) == 3
