"""K-centers tests: blob structure, device-vs-host equivalence, RMSD
metric, dist_cutoff stopping, init_centers warm start."""

import numpy as np
import pytest
from numpy.testing import assert_array_equal, assert_allclose

from enspara_tpu.cluster import kcenters, KCenters
from enspara_tpu.cluster.engine import assign_device
from enspara_tpu.cluster.util import assign_to_nearest_center
from enspara_tpu.geometry import libdist
from enspara_tpu.ops import qcp

# scikit-learn is a test-only dependency; without it (as on the machine
# with the card) the module skips instead of breaking collection
make_blobs = pytest.importorskip('sklearn.datasets').make_blobs

def test_kcenters_blobs_structure():
    X, y = make_blobs(n_samples=200, centers=3, cluster_std=0.3,
                      random_state=0)
    res = kcenters(X, 'euclidean', n_clusters=3)
    assert len(res.center_indices) == 3
    assert res.assignments.shape == (200,)
    # every blob maps to exactly one cluster label
    for blob in range(3):
        labels = res.assignments[y == blob]
        assert len(np.unique(labels)) == 1
    assert res.distances.max() < 2.0


def test_kcenters_device_matches_host_loop():
    """Device while_loop must bit-match the generic host loop."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(101, 5)).astype(np.float32)
    dev = kcenters(X, 'euclidean', n_clusters=10)
    host = kcenters(X, lambda A, y: libdist.euclidean(np.asarray(A), y),
                    n_clusters=10)
    assert_array_equal(dev.center_indices, host.center_indices)
    assert_array_equal(dev.assignments, host.assignments)
    assert_allclose(dev.distances, host.distances, rtol=1e-5, atol=1e-6)


def test_kcenters_dist_cutoff_stopping():
    X, _ = make_blobs(n_samples=150, centers=4, cluster_std=0.2,
                      random_state=1)
    res = kcenters(X, 'euclidean', dist_cutoff=1.0)
    assert res.distances.max() <= 1.0
    assert len(res.center_indices) >= 4


def test_kcenters_first_center_is_frame_zero():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(50, 3))
    res = kcenters(X, 'euclidean', n_clusters=2)
    assert res.center_indices[0] == 0


def test_kcenters_rmsd_metric():
    rng = np.random.default_rng(3)
    # 3 conformations, each jittered and randomly rotated
    base = rng.normal(size=(3, 40, 3)).astype(np.float32) * 2
    frames = []
    which = []
    for i in range(90):
        b = i % 3
        x = base[b] + rng.normal(size=(40, 3)) * 0.01
        frames.append(x)
        which.append(b)
    frames = np.array(frames, dtype=np.float32)
    res = kcenters(frames, 'rmsd', n_clusters=3)
    which = np.array(which)
    for b in range(3):
        assert len(np.unique(res.assignments[which == b])) == 1
    assert res.distances.max() < 0.1


def test_kcenters_init_centers():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(80, 4)).astype(np.float32)
    full = kcenters(X, 'euclidean', n_clusters=6)
    warm = kcenters(X, 'euclidean', n_clusters=6,
                    init_centers=[X[i] for i in full.center_indices[:3]])
    # warm start with the first 3 centers discovers the same next ones
    assert_array_equal(full.center_indices[3:],
                       warm.center_indices[3:])
    assert_array_equal(full.assignments, warm.assignments)


def test_kcenters_estimator_api():
    X, _ = make_blobs(n_samples=100, centers=3, random_state=5)
    est = KCenters(metric='euclidean', n_clusters=3).fit(X)
    assert est.labels_.shape == (100,)
    assert len(est.centers_) == 3
    pred = est.predict(X[:10])
    assert_array_equal(pred.assignments, est.labels_[:10])


def test_estimator_predict_new_data():
    """predict() assigns unseen frames to the fitted centers
    (reference: test_cluster.py test_predict)."""
    from sklearn.datasets import make_blobs
    from enspara_tpu.cluster.kcenters import KCenters

    X, y = make_blobs(n_samples=120, centers=3, cluster_std=0.2,
                      random_state=3)
    est = KCenters('euclidean', n_clusters=3).fit(X)
    X2, y2 = make_blobs(n_samples=60, centers=3, cluster_std=0.2,
                        random_state=3)
    res = est.predict(X2)
    assert res.assignments.shape == (60,)
    # frames land with their blob-mates
    for blob in range(3):
        assert len(np.unique(res.assignments[y2 == blob])) == 1
    assert np.all(res.distances >= 0)


def test_predict_before_fit_raises():
    from enspara_tpu.cluster.kcenters import KCenters
    from enspara_tpu.exception import ImproperlyConfigured

    est = KCenters('euclidean', n_clusters=3)
    with pytest.raises(ImproperlyConfigured):
        est.predict(np.zeros((5, 2)))


def test_cluster_result_partition():
    """ClusterResult.partition regroups flat results per trajectory
    (reference: test_cluster_util.py)."""
    from enspara_tpu.cluster.util import ClusterResult

    res = ClusterResult(
        assignments=np.arange(10),
        distances=np.arange(10) * 0.5,
        center_indices=np.array([0, 5]),
        centers=None)
    parts = res.partition([3, 3, 4])
    assert parts.assignments.lengths.tolist() == [3, 3, 4]
    np.testing.assert_array_equal(parts.assignments[2],
                                  np.array([6, 7, 8, 9]))
    np.testing.assert_array_equal(parts.distances[0],
                                  np.array([0.0, 0.5, 1.0]))


def test_assign_device_matches_host():
    rng = np.random.default_rng(6)
    X = rng.normal(size=(77, 6)).astype(np.float32)
    centers = X[[3, 14, 59]]
    a_dev, d_dev = assign_device(X, centers, 'euclidean')
    a_host, d_host = assign_to_nearest_center(
        X, centers, libdist.euclidean)
    assert_array_equal(a_dev, a_host)
    assert_allclose(d_dev, d_host, rtol=1e-5, atol=1e-6)


def test_assign_device_rmsd():
    rng = np.random.default_rng(7)
    frames = rng.normal(size=(30, 25, 3)).astype(np.float32)
    centers = frames[[0, 10, 20]]
    a, d = assign_device(frames, centers, 'rmsd')
    # oracle via float64 kabsch
    want_d = np.array([[qcp.kabsch_rmsd_np(f, c) for c in centers]
                       for f in frames])
    assert_array_equal(a, want_d.argmin(1))
    # fp32 QCP noise floor near rmsd=0 is sqrt(G*eps32/N) ~ 1e-3
    assert_allclose(d, want_d.min(1), rtol=1e-4, atol=1e-3)


def test_kcenters_sharded_matches_single_device():
    """Explicit 1-device vs 8-device mesh equivalence (the analogue
    of the reference's serial-vs-MPI oracle, SURVEY.md §4)."""
    import jax
    from jax.sharding import Mesh
    from enspara_tpu.cluster.engine import kcenters_device
    from enspara_tpu.parallel.mesh import FRAME_AXIS

    rng = np.random.default_rng(11)
    X = rng.normal(size=(203, 6)).astype(np.float32)  # odd n -> padding

    mesh1 = Mesh(np.array(jax.devices()[:1]), (FRAME_AXIS,))
    mesh8 = Mesh(np.array(jax.devices()), (FRAME_AXIS,))

    r1 = kcenters_device(X, 'euclidean', n_clusters=12, mesh=mesh1)
    r8 = kcenters_device(X, 'euclidean', n_clusters=12, mesh=mesh8)

    assert_array_equal(r1.center_indices, r8.center_indices)
    assert_array_equal(r1.assignments, r8.assignments)
    assert_allclose(r1.distances, r8.distances, rtol=1e-6)


def test_kcenters_rmsd_sharded_matches_single_device():
    import jax
    from jax.sharding import Mesh
    from enspara_tpu.cluster.engine import kcenters_device
    from enspara_tpu.parallel.mesh import FRAME_AXIS

    rng = np.random.default_rng(12)
    X = rng.normal(size=(97, 17, 3)).astype(np.float32)

    mesh1 = Mesh(np.array(jax.devices()[:1]), (FRAME_AXIS,))
    mesh8 = Mesh(np.array(jax.devices()), (FRAME_AXIS,))

    r1 = kcenters_device(X, 'rmsd', n_clusters=7, mesh=mesh1)
    r8 = kcenters_device(X, 'rmsd', n_clusters=7, mesh=mesh8)

    assert_array_equal(r1.center_indices, r8.center_indices)
    assert_array_equal(r1.assignments, r8.assignments)
    # atol: near-zero RMSDs (self-distance of centers) sit at the fp32
    # QCP noise floor sqrt(G*eps32/n_atoms) ~ 7e-4 here, and the
    # summation order differs per shard width
    assert_allclose(r1.distances, r8.distances, rtol=1e-5, atol=2e-3)


def test_random_first_center(tmp_path):
    """random_first_center seeds from a random frame (extension: the
    reference declares the flag but raises NotImplementedError).
    Deterministic under random_state; the Gonzalez covering guarantee
    holds for any seed."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(200, 6)).astype(np.float32)
    X[100:] += 8.0                      # two well-separated blobs

    r1 = kcenters(X, 'euclidean', n_clusters=2,
                  random_first_center=True, random_state=7)
    r2 = kcenters(X, 'euclidean', n_clusters=2,
                  random_first_center=True, random_state=7)
    assert list(r1.center_indices) == list(r2.center_indices)
    # both blobs must be covered regardless of the seed frame
    assert len(np.unique(np.asarray(r1.assignments))) == 2

    from enspara_tpu.exception import ImproperlyConfigured
    with pytest.raises(ImproperlyConfigured):
        kcenters(X, 'euclidean', n_clusters=2,
                 random_first_center=True, init_centers=[X[0]])


def test_random_first_center_accepts_randomstate():
    """np.random.RandomState satisfies the sklearn-style random_state
    contract used by hybrid/kmedoids (ADVICE r4: default_rng alone
    rejects RandomState instances)."""
    rng = np.random.default_rng(9)
    X = rng.normal(size=(100, 4)).astype(np.float32)
    r1 = kcenters(X, 'euclidean', n_clusters=2, random_first_center=True,
                  random_state=np.random.RandomState(3))
    r2 = kcenters(X, 'euclidean', n_clusters=2, random_first_center=True,
                  random_state=np.random.RandomState(3))
    assert list(r1.center_indices) == list(r2.center_indices)
