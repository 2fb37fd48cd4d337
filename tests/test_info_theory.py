"""Information-theory tests: joint counts (device einsum vs host
bincount), MI identities, NMI/APC, entropy/divergences, weighted MI,
exposons-from-sasas clustering."""

import numpy as np
import pytest
from numpy.testing import assert_array_equal, assert_allclose

from enspara_tpu.info_theory import (libinfo, mutual_info, entropy,
                                     exposons_from_sasas)
from enspara_tpu.exception import DataInvalid


def test_bincount2d():
    a = np.array([0, 0, 1, 2, 1])
    b = np.array([1, 1, 0, 2, 0])
    H = libinfo.bincount2d(a, b, 3, 3)
    want = np.zeros((3, 3))
    want[0, 1] = 2
    want[1, 0] = 2
    want[2, 2] = 1
    assert_array_equal(H, want)


def test_matrix_bincount2d_device_vs_host():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 3, size=(500, 7))
    b = rng.integers(0, 4, size=(500, 5))
    dev = libinfo._matrix_bincount2d_device(a, b, 3, 4)
    host = libinfo.matrix_bincount2d_np(a, b, 3, 4)
    assert_array_equal(dev, host)
    api = libinfo.matrix_bincount2d(a, b, 3, 4)
    assert_array_equal(api, host)
    assert api.dtype == np.uint32


def test_matrix_bincount2d_mesh_bool_labels():
    """Dichotomized (bool) features through the mesh path: the pad
    sentinel's dtype guard must upcast bools (np.iinfo rejects them)
    so the sharded device path works instead of silently demoting to
    the host loop."""
    from enspara_tpu.parallel.mesh import frame_mesh
    rng = np.random.default_rng(2)
    # 501 frames: not divisible by the device count -> padding engages
    a = rng.integers(0, 2, size=(501, 6)).astype(bool)
    b = rng.integers(0, 2, size=(501, 3)).astype(bool)
    host = libinfo.matrix_bincount2d_np(
        a.astype(np.int32), b.astype(np.int32), 2, 2)
    dev = libinfo._matrix_bincount2d_device(a, b, 2, 2,
                                            mesh=frame_mesh())
    assert_array_equal(np.asarray(dev), host)


def test_matrix_bincount2d_totals():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 3, size=(200, 4))
    jc = libinfo.matrix_bincount2d(a, a, 3, 3)
    # every (f1, f2) joint histogram sums to T
    assert_array_equal(jc.sum(axis=(-1, -2)), np.full((4, 4), 200))
    # diagonal blocks are diagonal matrices (feature vs itself)
    for f in range(4):
        block = jc[f, f]
        assert (block == np.diag(np.diag(block))).all()


def test_mutual_information_identities():
    rng = np.random.default_rng(2)
    # independent features: MI ~ 0; identical features: MI = H
    x = rng.integers(0, 2, size=20000)
    y = rng.integers(0, 2, size=20000)
    a = np.stack([x, y, x], axis=1)
    jc = mutual_info.joint_counts(a, a, 2, 2)
    mi = mutual_info.mutual_information(jc)
    assert mi[0, 1] < 0.001           # independent
    p = np.bincount(x, minlength=2) / len(x)
    H = entropy.shannon_entropy(p, normalize=False)
    assert_allclose(mi[0, 2], H, rtol=1e-6)  # identical -> marginal H
    assert_allclose(mi, mi.T, atol=1e-12)


def test_mi_matrix_and_serial_agree():
    rng = np.random.default_rng(3)
    X = rng.integers(0, 3, size=(1000, 4))
    Xs = [X[:500], X[500:]]
    n = np.full(4, 3)
    fast = mutual_info.mi_matrix(Xs, Xs, n, n, normalize=True)
    slow = mutual_info.mi_matrix_serial(Xs, Xs, n, n, normalize=True)
    assert_allclose(fast, slow, atol=1e-10)


def test_weighted_mi_matches_unweighted():
    """Uniform weights must reproduce the unweighted MI."""
    rng = np.random.default_rng(4)
    X = rng.integers(0, 3, size=(2000, 3))
    w = np.full(2000, 1 / 2000)
    wmi = mutual_info.weighted_mi(X, w, normalize=False)
    jc = mutual_info.joint_counts(X, X, 3, 3)
    mi = mutual_info.mutual_information(jc)
    # weighted_mi computes diagonal = marginal entropy, mi too
    # (fp32 device matmul bounds agreement at ~1e-6)
    assert_allclose(wmi, mi, atol=1e-5)


def test_weighted_mi_weights_matter():
    rng = np.random.default_rng(5)
    X = rng.integers(0, 2, size=(1000, 2))
    w_first = np.zeros(1000)
    w_first[:100] = 1 / 100
    a = mutual_info.weighted_mi(X, w_first, normalize=False)
    b = mutual_info.weighted_mi(X, np.full(1000, 1e-3), normalize=False)
    assert not np.allclose(a, b)


def test_channel_capacity_normalization():
    mi = np.array([[1.0, 0.5], [0.5, 1.0]])
    out = mutual_info.channel_capacity_normalization(mi, 2, 2)
    assert_allclose(out, mi / np.log(2))
    with pytest.raises(DataInvalid):
        mutual_info.channel_capacity_normalization(mi, [2], 2)


def test_nmi_apc_identities():
    rng = np.random.default_rng(6)
    X = rng.integers(0, 3, size=(5000, 4))
    X[:, 1] = X[:, 0]  # perfect correlation
    jc = mutual_info.joint_counts(X, X, 3, 3)
    mi = mutual_info.mutual_information(jc)
    nmi = mutual_info.mi_to_nmi(mi)
    assert_allclose(np.diag(nmi), 1.0)
    assert nmi[0, 1] > 0.99  # identical features -> NMI ~ 1
    apc = mutual_info.mi_to_apc(mi)
    assert apc.shape == mi.shape
    nmi_apc = mutual_info.mi_to_nmi_apc(mi)
    assert nmi_apc.shape == mi.shape


def test_deconvolute_network():
    G_dir = np.array([[0.0, 0.3], [0.3, 0.0]])
    G_obs = G_dir @ np.linalg.inv(np.eye(2) - G_dir)
    got = mutual_info.deconvolute_network(G_obs)
    assert_allclose(got, G_dir, atol=1e-12)


def test_shannon_entropy():
    p = np.array([0.5, 0.5])
    assert_allclose(entropy.shannon_entropy(p), np.log(2))
    assert entropy.shannon_entropy(np.array([1.0, 0.0])) == 0
    # normalization flag
    assert_allclose(entropy.shannon_entropy(np.array([2.0, 2.0])),
                    np.log(2))


def test_kl_js_divergence():
    p = np.array([0.5, 0.5])
    q = np.array([0.9, 0.1])
    assert entropy.kl_divergence(p, p) == 0
    assert entropy.kl_divergence(p, q) > 0
    js_pq = entropy.js_divergence(p, q)
    js_qp = entropy.js_divergence(q, p)
    assert_allclose(js_pq, js_qp)
    # rowwise
    P = np.stack([p, q])
    d = entropy.kl_divergence(P, P)
    assert_array_equal(d, [0, 0])


def test_relative_entropy_msm():
    from enspara_tpu.msm import builders
    P = np.array([[0.9, 0.1], [0.2, 0.8]])
    assert_allclose(entropy.relative_entropy_msm(P, Q=P), 0, atol=1e-12)
    Q = np.array([[0.5, 0.5], [0.5, 0.5]])
    assert entropy.relative_entropy_msm(P, Q=Q) > 0
    # from assignments
    assigns = np.array([[0] * 50 + [1] * 50])
    val = entropy.relative_entropy_msm(P, assignments=assigns,
                                       lag_time=1)
    assert np.isfinite(val)


def test_energy_to_probability():
    u = np.array([0.0, 2.479])
    p = entropy.energy_to_probability(u)
    assert_allclose(p.sum(), 1)
    assert p[0] > p[1]


def test_exposons_from_sasas():
    rng = np.random.default_rng(7)
    n_frames = 400
    switch = rng.integers(0, 2, size=n_frames).astype(bool)
    sasas = np.zeros((n_frames, 6), dtype=np.float32)
    # residues 0-2 open/close together; 3-5 together (anti-phase)
    sasas[switch, :3] = 0.5
    sasas[~switch, 3:] = 0.5
    sasas += rng.random((n_frames, 6)) * 0.005
    weights = np.full(n_frames, 1 / n_frames)
    mi, labels = exposons_from_sasas(sasas, 0.9, weights, 0.02)
    assert mi.shape == (6, 6)
    assert len(set(labels[:3])) == 1
    assert len(set(labels[3:])) == 1


def test_mi_zero_and_nonzero_patterns():
    """Deterministic alternating patterns (reference:
    test_mutual_info.py:108-198): independent alternations give zero
    MI; identical alternations give log(2)."""
    n = 1000
    a = np.zeros((n, 2), dtype=int)
    a[::2, 0] = 1          # feature 0 alternates every frame
    a[::4, 1] = 1
    a[1::4, 1] = 1          # feature 1 alternates every other frame
    mi = mutual_info.mi_matrix([a], [a], [2, 2], [2, 2],
                               normalize=False)
    assert abs(mi[0, 1]) < 1e-3          # independent
    b = np.stack([a[:, 0], a[:, 0]], axis=1)
    mi2 = mutual_info.mi_matrix([b], [b], [2, 2], [2, 2],
                                normalize=False)
    assert_allclose(mi2[0, 1], np.log(2), rtol=1e-6)
    # channel-capacity normalized: exactly 1
    mi3 = mutual_info.mi_matrix([b], [b], [2, 2], [2, 2],
                                normalize=True)
    assert_allclose(mi3[0, 1], 1.0, rtol=1e-6)


def test_check_features_states_validation():
    with pytest.raises(DataInvalid):
        mutual_info.check_features_states(
            [np.zeros((5, 3))], n_states=[2, 2])


def test_joint_counts_reject_negative_states():
    """-1 sentinels would be silently dropped by the one-hot device
    path (undercounted MI) while the host fallback crashes — both now
    fail loudly up front (r5 review)."""
    from enspara_tpu.info_theory import libinfo

    a = np.array([[0], [1], [-1], [1]])
    b = np.array([[0], [1], [0], [1]])
    with pytest.raises(AssertionError, match='non-negative'):
        libinfo.matrix_bincount2d(a, b, 2, 2)


def test_matrix_bincount2d_device_failure_propagates(monkeypatch):
    """A failing device joint count raises; it is not swapped for the
    host bincount loop behind the caller's back."""
    def boom():
        def run(*args, **kwargs):
            raise RuntimeError('device joint count failed')
        return run

    monkeypatch.setattr(libinfo, '_chunk_counts_jit', boom)
    a = np.zeros((50, 2), np.int32)
    with pytest.raises(RuntimeError, match='device joint count failed'):
        libinfo.matrix_bincount2d(a, a, 2, 2)


def test_matrix_bincount2d_long_time_axis_takes_host_loop(monkeypatch):
    """Only a time axis beyond the device's int32 accumulator takes the
    host loop, and it gives the same counts."""
    def device(*args, **kwargs):
        raise AssertionError('device path taken')

    rng = np.random.default_rng(5)
    a = rng.integers(0, 3, size=(64, 3))
    b = rng.integers(0, 2, size=(64, 2))
    want = libinfo.matrix_bincount2d(a, b, 3, 2)
    monkeypatch.setattr(libinfo, '_MAX_DEVICE_T', 64)
    monkeypatch.setattr(libinfo, '_matrix_bincount2d_device', device)
    assert_array_equal(libinfo.matrix_bincount2d(a, b, 3, 2), want)


def test_weighted_mi_device_failure_propagates(monkeypatch):
    """Above the size gate a failing device matmul raises instead of
    falling back to the dense host einsum."""
    import jax

    def boom(*args, **kwargs):
        raise RuntimeError('device one-hot failed')

    monkeypatch.setattr(jax.nn, 'one_hot', boom)
    T, F = 300_000, 7                       # size*s_max > 2**22 gate
    feats = np.zeros((T, F), np.int8)
    feats[::2] = 1
    with pytest.raises(RuntimeError, match='device one-hot failed'):
        mutual_info.weighted_mi(feats, np.full(T, 1.0 / T))


def test_weighted_mi_accepts_bool_features_on_device_path():
    """exposons passes bool exposure masks; one_hot on bools raises in
    jax, so the device path (engaged above the size gate) must cast
    (r5 review: the raise silently routed every large exposons run
    into a dense O(T F^2 s^2) host einsum). Small inputs take the
    float64 einsum for oracle-exact parity; above the gate the fp32
    device path must agree with it to fp32 rounding."""
    from enspara_tpu.info_theory.mutual_info import weighted_mi

    rng = np.random.default_rng(4)
    T, F = 300_000, 7                       # size*s_max > 2**22 gate
    feats = rng.random((T, F)) > 0.5        # bool
    w = np.full(T, 1.0 / T)
    out = weighted_mi(feats, w)
    assert out.shape == (F, F)
    assert np.isfinite(out).all()
    # sub-gate slice agrees through the einsum path
    small = weighted_mi(feats[:2000], np.full(2000, 1 / 2000.0))
    assert small.shape == (F, F)
