import numpy as np
import pytest
from numpy.testing import assert_allclose

from enspara_tpu.msm import builders
from enspara_tpu.msm.eigen_device import (eigenspectrum_reversible,
                                          implied_timescales_device)
from enspara_tpu.msm.transition_matrices import eigenspectrum
from enspara_tpu.msm.timescales import implied_timescales


def _reversible(n, seed=0):
    rng = np.random.default_rng(seed)
    C = rng.integers(1, 50, size=(n, n)).astype(float)
    _, T, pi = builders.mle(C)
    return T, pi


def test_eigh_path_matches_host():
    T, pi = _reversible(40)
    vals_h, vecs_h = eigenspectrum(T, n_eigs=6, left=True)
    vals_d, vecs_d = eigenspectrum_reversible(T, pi=pi, n_eigs=6,
                                              method='eigh')
    assert_allclose(vals_d, vals_h, atol=1e-5)
    assert_allclose(vecs_d[:, 0], vecs_h[:, 0], atol=1e-6)
    # remaining left eigenvectors equal up to sign
    for k in range(1, 6):
        a, b = vecs_d[:, k], vecs_h[:, k]
        s = np.sign(a @ b)
        assert_allclose(a * s / np.linalg.norm(a),
                        b / np.linalg.norm(b), atol=1e-4)


def test_no_pi_falls_back_to_host():
    T, pi = _reversible(10)
    vals, vecs = eigenspectrum_reversible(T, pi=None, n_eigs=3)
    vals_h, _ = eigenspectrum(T, n_eigs=3, left=True)
    assert_allclose(vals, vals_h, atol=1e-12)


def test_lobpcg_path_matches_eigh_on_clustered_spectrum():
    """Block-metastable T: 6 eigenvalues clustered within 2e-4 of each
    other near 1 — the hard case for iterative solvers. The guarded
    LOBPCG + fp64 Rayleigh-Ritz refinement must recover the full
    metastable block to timescale accuracy."""
    import scipy.sparse

    rng = np.random.default_rng(7)
    n, nb = 1200, 6
    C = np.zeros((n, n))
    labels = rng.integers(0, nb, n)
    for i in range(n):
        same = labels == labels[i]
        C[i, same] = rng.integers(5, 30, same.sum())
        cross = rng.choice(np.where(~same)[0], 5, replace=False)
        C[i, cross] = 1
    _, T, pi = builders.transpose(C)

    ve, Ue = eigenspectrum_reversible(T, pi=pi, n_eigs=6,
                                      method='eigh')
    vl, Ul = eigenspectrum_reversible(scipy.sparse.csr_matrix(T),
                                      pi=pi, n_eigs=6,
                                      method='lobpcg')
    # metastable eigenvalues to 1e-5 (timescale-grade accuracy)
    assert_allclose(vl, ve, atol=1e-5)
    # eq populations
    assert_allclose(Ul[:, 0], Ue[:, 0], atol=1e-6)
    # metastable eigenvectors up to sign (subspace rotation within the
    # near-degenerate cluster allows modest per-vector tolerance)
    for k in range(1, 6):
        a, b = Ue[:, k], Ul[:, k]
        cos = abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos > 0.999, 'vector %d cos %.5f' % (k, cos)


def _sparse_gapless_msm(n, seed=3, extra_per_state=6):
    """Connected sparse reversible MSM with a GAPLESS top spectrum
    (chain backbone + random expander links): modes 2..k sit in the
    bulk with ~1/n spacing — the pathological case where filtered
    subspace iteration cannot converge and the ARPACK fallback must
    fire."""
    import scipy.sparse

    rng = np.random.default_rng(seed)
    ij = [np.stack([np.arange(n - 1), np.arange(1, n)])]
    vals = [rng.integers(1, 20, n - 1).astype(float)]
    m = extra_per_state * n
    ij.append(np.stack([rng.integers(0, n, m), rng.integers(0, n, m)]))
    vals.append(rng.integers(1, 5, m).astype(float))
    ij = np.concatenate(ij, axis=1)
    v = np.concatenate(vals)
    C = scipy.sparse.coo_matrix((v, (ij[0], ij[1])), shape=(n, n))
    C = (C + C.T).tocsr()
    _, T, pi = builders.transpose(C)
    return scipy.sparse.csr_matrix(T), np.asarray(pi)


def _sparse_metastable_msm(n, n_blocks=25, seed=3, extra_per_state=6):
    """Sparse reversible MSM with realistic metastable structure
    (BASELINE config 5's shape): see
    ``synthetic_data.sparse_metastable_counts``."""
    import scipy.sparse

    from enspara_tpu.msm.synthetic_data import sparse_metastable_counts

    C = sparse_metastable_counts(n, n_blocks=n_blocks, seed=seed,
                                 extra_per_state=extra_per_state)
    _, T, pi = builders.transpose(C)
    return scipy.sparse.csr_matrix(T), np.asarray(pi)


def _arpack_oracle(T, pi, k):
    import scipy.sparse
    import scipy.sparse.linalg

    sqrt_pi = np.sqrt(pi)
    S = scipy.sparse.diags(sqrt_pi) @ T @ \
        scipy.sparse.diags(1.0 / sqrt_pi)
    S = ((S + S.T) * 0.5).tocsc().astype(np.float64)
    w = scipy.sparse.linalg.eigsh(S, k=k, which='LA',
                                  return_eigenvectors=False)
    return np.sort(w)[::-1]


def test_lobpcg_refined_10k_states_vs_arpack():
    """VERDICT r1 item 4 / BASELINE config 5: the 20 slowest modes of
    a 10^4-state sparse MSM on the device path must match host ARPACK
    with asserted residuals — not just 'close', but with a per-mode
    residual certificate below 1e-9."""
    n, k = 10_000, 21
    T, pi = _sparse_metastable_msm(n)

    vals, vecs, info = eigenspectrum_reversible(
        T, pi=pi, n_eigs=k, method='lobpcg', return_info=True)

    assert info['method'] == 'filtered'
    assert not info['fallback'], \
        'refinement should converge on a metastable sparse MSM'
    assert info['residuals'].max() < 1e-9, info['residuals']

    w_ref = _arpack_oracle(T, pi, k)
    assert_allclose(vals, w_ref, atol=1e-10)

    # top-20 implied timescales (lag 1) agree
    ts = -1.0 / np.log(vals[1:])
    ts_ref = -1.0 / np.log(w_ref[1:])
    assert_allclose(ts, ts_ref, rtol=1e-6)

    # eq populations recover pi
    assert_allclose(vecs[:, 0], pi, atol=1e-9)


@pytest.mark.slow
def test_lobpcg_refined_100k_states_vs_arpack():
    """Slow-tier scale point: 10^5 states."""
    n, k = 100_000, 21
    T, pi = _sparse_metastable_msm(n, seed=11)
    vals, _, info = eigenspectrum_reversible(
        T, pi=pi, n_eigs=k, method='lobpcg', return_info=True)
    assert info['residuals'].max() < 1e-9, info['residuals']
    w_ref = _arpack_oracle(T, pi, k)
    assert_allclose(vals, w_ref, atol=1e-10)


def test_filtered_grows_block_on_gapless_spectrum():
    """A gapless (expander) spectrum stalls a fixed-block filter by
    construction: the wanted modes sit in a bulk with ~1/n spacing.
    The adaptive solver must converge with certificates anyway — by
    starting with a block wide enough to see a usable gap, or by
    detecting the stall and growing the block until it does — with
    no silent unconverged modes and no unnecessary ARPACK handoff."""
    n, k = 5000, 6
    T, pi = _sparse_gapless_msm(n, seed=5)
    vals, _, info = eigenspectrum_reversible(
        T, pi=pi, n_eigs=k, method='filtered', return_info=True)
    assert not info['fallback'], info
    assert info['residuals'].max() < 1e-9
    w_ref = _arpack_oracle(T, pi, k)
    assert_allclose(vals, w_ref, atol=1e-10)


def test_lobpcg_falls_back_to_arpack_when_budget_exhausted():
    """With a zero refinement budget and an unreachable tolerance the
    solver must not return unconverged modes silently — it hands the
    problem to host ARPACK and still meets the residual contract."""
    n, k = 5000, 6
    T, pi = _sparse_metastable_msm(n, seed=5)
    vals, _, info = eigenspectrum_reversible(
        T, pi=pi, n_eigs=k, method='lobpcg', tol=1e-14, max_refine=0,
        return_info=True)
    assert info['fallback']
    w_ref = _arpack_oracle(T, pi, k)
    assert_allclose(vals, w_ref, atol=1e-10)


def test_singular_gram_falls_back_to_arpack(monkeypatch):
    """A numerically singular Gram matrix inside the stage-2
    generalized Rayleigh-Ritz (hard filters can collapse the block
    onto a few eigendirections) must route to the ARPACK fallback,
    not crash the pipeline."""
    import scipy.linalg

    real_eigh = scipy.linalg.eigh

    def breaking_eigh(a, b=None, **kw):
        if b is not None:
            raise np.linalg.LinAlgError('leading minor not positive '
                                        'definite (simulated)')
        return real_eigh(a, **kw)

    monkeypatch.setattr(scipy.linalg, 'eigh', breaking_eigh)
    n, k = 5000, 6
    T, pi = _sparse_metastable_msm(n, seed=5)
    vals, _, info = eigenspectrum_reversible(
        T, pi=pi, n_eigs=k, method='lobpcg', return_info=True)
    assert info['fallback']
    w_ref = _arpack_oracle(T, pi, k)
    assert_allclose(vals, w_ref, atol=1e-10)


def test_implied_timescales_device_matches_host():
    rng = np.random.default_rng(1)
    assigns = rng.integers(0, 5, size=(3, 400))
    host = implied_timescales(assigns, [1, 2, 4],
                              method=builders.mle, n_times=2)
    dev = implied_timescales_device(assigns, [1, 2, 4],
                                    method=builders.mle, n_times=2)
    assert_allclose(dev, host, rtol=1e-3)


def test_implied_timescales_batched_matches_host():
    """The single-launch all-lags path (traced-lag counting + batched
    transpose builder + batched eigh) matches the host per-lag loop
    with the transpose builder, for sliding and strided windows, ragged
    rows, and prior counts."""
    from enspara_tpu.msm.eigen_device import implied_timescales_batched
    from enspara_tpu.ra import RaggedArray

    rng = np.random.default_rng(2)
    rows = [rng.integers(0, 6, size=n) for n in (400, 377, 512)]
    assigns = RaggedArray(rows)
    lags = [1, 2, 5, 9]

    host = implied_timescales(assigns, lags, method=builders.transpose,
                              n_times=3)
    dev = implied_timescales_batched(assigns, lags, n_times=3)
    assert_allclose(dev, host, rtol=2e-3)

    host_s = implied_timescales(assigns, [2, 4], n_times=3,
                                method=builders.transpose,
                                sliding_window=False)
    dev_s = implied_timescales_batched(assigns, [2, 4], n_times=3,
                                       sliding_window=False)
    assert_allclose(dev_s, host_s, rtol=2e-3)

    import functools
    pm = functools.partial(builders.transpose, prior_counts=0.1)
    host_p = implied_timescales(assigns, [1, 3], n_times=2, method=pm)
    dev_p = implied_timescales_batched(assigns, [1, 3], n_times=2,
                                       prior_counts=0.1)
    assert_allclose(dev_p, host_p, rtol=2e-3)


def test_implied_timescales_batched_lag_sharded_matches_unsharded():
    """Sharding the lag axis over the 8-device mesh (replicated
    assignments, GSPMD-partitioned vmap) must reproduce the unsharded
    batched scan exactly — including a lag count that does not divide
    the mesh (padding shards)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from enspara_tpu import ra
    from enspara_tpu.msm.eigen_device import implied_timescales_batched
    from enspara_tpu.parallel.mesh import FRAME_AXIS

    rng = np.random.RandomState(2)
    rows = [rng.randint(0, 5, size=n) for n in (300, 211, 97)]
    assigns = ra.RaggedArray(rows)
    mesh = Mesh(np.array(jax.devices()[:8]), (FRAME_AXIS,))

    for lags in ([1, 2, 3, 4, 5, 6, 7, 8], [2, 5, 9]):   # even + ragged
        base = implied_timescales_batched(assigns, lags, n_times=3)
        shrd = implied_timescales_batched(assigns, lags, n_times=3,
                                          mesh=mesh)
        assert shrd.shape == base.shape == (len(lags), 3)
        np.testing.assert_allclose(shrd, base, rtol=1e-6, atol=1e-9)


def test_arpack_method_and_auto_dispatch():
    """'auto' routes large sparse k<<n spectra to host ARPACK Lanczos
    (the measured best engine at that shape; see eigen_device.py
    dispatch note) with residual certificates attached."""
    n, k = 10_000, 21
    T, pi = _sparse_metastable_msm(n)

    vals, vecs, info = eigenspectrum_reversible(
        T, pi=pi, n_eigs=k, method='auto', return_info=True)
    assert info['method'] == 'arpack'
    assert info['residuals'].shape == (k,)
    assert info['residuals'].max() < 1e-9, info['residuals']

    w_ref = _arpack_oracle(T, pi, k)
    assert_allclose(vals, w_ref, atol=1e-10)
    assert_allclose(vecs[:, 0], pi, atol=1e-9)

    # small/dense shapes keep the device eigh path
    Ts, pis = _sparse_metastable_msm(1024, n_blocks=8)
    _, _, info_s = eigenspectrum_reversible(
        Ts, pi=pis, n_eigs=5, method='auto', return_info=True)
    assert info_s['method'] == 'eigh'


def test_transpose_timescales_device_matches_host_pipeline():
    """The fused device MSM tail (counts -> transpose builder ->
    pi-symmetrized eigh in one program) must agree with the host
    pipeline builders.transpose + eigenspectrum_reversible."""
    from enspara_tpu.msm import builders
    from enspara_tpu.msm.eigen_device import transpose_timescales_device

    rng = np.random.default_rng(11)
    C = rng.integers(0, 40, size=(200, 200)).astype(np.float64)

    ts, vals, phi = transpose_timescales_device(C, n_eigs=9, lag_time=5)

    _, T, pi = builders.transpose(C)
    ref_vals, ref_phi = eigenspectrum_reversible(
        T, pi=pi, n_eigs=9, method='eigh')

    assert vals.shape == (9,) and phi.shape == (200, 9)
    assert_allclose(vals, ref_vals, atol=1e-4)
    assert_allclose(phi[:, 0], ref_phi[:, 0], atol=1e-5)   # eq pops
    expected_ts = -5.0 / np.log(ref_vals[1:])
    assert_allclose(ts, expected_ts, rtol=1e-3)


def test_stage1_exception_falls_back_to_arpack(monkeypatch):
    """A device error in stage 1 propagates: it is not swapped for the
    host ARPACK engine behind the caller's back."""
    import scipy.sparse

    from enspara_tpu.msm import eigen_device as ed

    T, pi = _sparse_metastable_msm(3000)

    def boom(S, n_eigs, **kw):
        raise RuntimeError('synthetic stage-1 failure')

    monkeypatch.setattr(ed, '_filtered_subspace_device', boom)
    with pytest.raises(RuntimeError, match='synthetic stage-1 failure'):
        ed.eigenspectrum_reversible(
            scipy.sparse.csr_matrix(T), pi=pi, n_eigs=5,
            method='filtered', return_info=True)


def test_stage1_nonfinite_block_falls_back_to_arpack(monkeypatch):
    """A block the fp32 filter drove to non-finite values (a numerical
    breakdown, not a device fault) goes to the ARPACK engine, and the
    returned info says so."""
    import scipy.sparse

    from enspara_tpu.msm import eigen_device as ed

    T, pi = _sparse_metastable_msm(3000)

    def nan_block(S, n_eigs, **kw):
        return np.full((S.shape[0], n_eigs + 4), np.nan), {}

    monkeypatch.setattr(ed, '_filtered_subspace_device', nan_block)
    vals, _, info = ed.eigenspectrum_reversible(
        scipy.sparse.csr_matrix(T), pi=pi, n_eigs=5,
        method='filtered', return_info=True)
    assert info['fallback']
    ref_vals, _ = ed.eigenspectrum_reversible(
        scipy.sparse.csr_matrix(T), pi=pi, n_eigs=5, method='arpack')
    assert np.abs(vals - ref_vals).max() < 1e-9


def test_bucketed_ell_shape_identity():
    from enspara_tpu.msm.eigen_device import bucketed_ell_shape

    # same-decade chains collide; padding waste stays small
    a = bucketed_ell_shape(100_000, 33)
    b = bucketed_ell_shape(101_000, 38)
    assert a == b
    for n in (1000, 5000, 97_000, 500_000):
        n_pad, w_pad = bucketed_ell_shape(n, 17)
        assert n_pad >= n and (n_pad - n) / n < 0.13
        assert w_pad >= 17 and w_pad % 8 == 0


def test_transpose_tail_zero_count_states():
    """max_n_states padding routinely leaves zero-count rows; the
    fused tail must not NaN-poison the spectrum (r5 review)."""
    from enspara_tpu.msm.eigen_device import transpose_timescales_device

    C = np.array([[5, 2, 0], [1, 4, 0], [0, 0, 0]], dtype=np.float64)
    ts, vals, vecs = transpose_timescales_device(C, n_eigs=2)
    assert np.isfinite(np.asarray(vals)).all()
    assert np.isfinite(np.asarray(ts)).all()
    # agrees with the host engine on the live 2x2 block
    from enspara_tpu.msm import builders
    from enspara_tpu.msm.eigen_device import eigenspectrum_reversible
    _, T, pi = builders.transpose(C[:2, :2])
    ref_vals, _ = eigenspectrum_reversible(T, pi=pi, n_eigs=2,
                                           method='eigh')
    np.testing.assert_allclose(np.asarray(vals)[:2], ref_vals,
                               atol=1e-5)


def test_implied_timescales_device_nonreversible_fallback():
    """builders.normalize produces non-reversible T: the device path
    must fall back to the general host eigensolver instead of
    force-symmetrizing the spectrum (r5 review), and negative
    eigenvalues must yield NaN like the host path."""
    from enspara_tpu.msm import builders
    from enspara_tpu.msm.eigen_device import implied_timescales_device
    from enspara_tpu.msm.timescales import implied_timescales

    rng = np.random.default_rng(2)
    # strongly non-reversible cyclic chain
    a = np.zeros(600, dtype=int)
    state = 0
    for i in range(600):
        a[i] = state
        state = (state + 1) % 4 if rng.random() < 0.9 \
            else rng.integers(4)
    a = a[None, :]

    dev = implied_timescales_device(a, [1, 2], builders.normalize,
                                    n_times=2)
    host = implied_timescales(a, [1, 2], builders.normalize, n_times=2)
    np.testing.assert_allclose(dev, host, rtol=1e-4, equal_nan=True)


def test_mle_device_contracts():
    """Zero-count states raise like the host kernel (instead of a
    silent NaN T), and tol actually stops the sweep loop
    (r5 review)."""
    import warnings

    import pytest
    from enspara_tpu.exception import ConvergenceWarning
    from enspara_tpu.msm import builders

    with pytest.raises(ValueError, match='[Tt]rim'):
        builders.mle_device(np.array([[2.0, 0.0], [0.0, 0.0]]))

    rng = np.random.default_rng(0)
    C = rng.integers(1, 50, size=(12, 12)).astype(float)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter('always')
        builders.mle_device(C, tol=1e-30, max_iter=1)
    assert any(isinstance(x.message, ConvergenceWarning) for x in w)
    # converged result still matches the host kernel
    _, T_dev, pi_dev = builders.mle_device(C)
    _, T_host, pi_host = builders.mle(C)
    np.testing.assert_allclose(np.asarray(T_dev), np.asarray(T_host),
                               atol=5e-4)
