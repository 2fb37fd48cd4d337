"""TPT tests with the reference's oracle values
(reference: enspara/test/test_tpt_fluxes.py)."""

import warnings

import numpy as np
import scipy.sparse
from numpy.testing import (assert_array_equal, assert_array_almost_equal,
                           assert_allclose)

from enspara_tpu.tpt import (committors, mfpts, reactive_fluxes,
                             net_fluxes, reactive_populations, paths,
                             top_path)

ARR_TYPES = [np.array, scipy.sparse.lil_matrix, scipy.sparse.csr_matrix,
             scipy.sparse.coo_matrix]


def test_committors_small():
    Tij0 = np.array([[0.5, 0.4, 0.1],
                     [0.25, 0.5, 0.25],
                     [0.1, 0.5, 0.4]])
    for arr_type in ARR_TYPES:
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            Tij = arr_type(Tij0)
        true_committors = np.array([0, 0.5, 1.])
        assert_array_almost_equal(committors(Tij, 0, 2), true_committors)
        assert_array_almost_equal(committors(Tij, [0], [2]),
                                  true_committors)


def test_committors_big():
    Tij0 = np.array([[0.5, 0.4, 0.1, 0.],
                     [0.25, 0.5, 0.2, 0.05],
                     [0.1, 0.15, 0.5, 0.25],
                     [0., 0.1, 0.4, 0.5]])
    for arr_type in ARR_TYPES:
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            Tij = arr_type(Tij0)
        got = np.around(committors(Tij, 0, 3), 5)
        assert_array_equal(got, np.array([0, 0.34091, 0.60227, 1.]))
        got2 = committors(Tij, [0, 2], [3])
        assert_array_almost_equal(got2, np.array([0, 0.1, 0, 1.0]))


def test_committors_large_dense_device_path():
    """n_states >= 64 triggers the device linear solve."""
    rng = np.random.default_rng(0)
    n = 100
    T = rng.random((n, n))
    T /= T.sum(1, keepdims=True)
    q = committors(T, [0], [n - 1])
    q_sp = committors(scipy.sparse.csr_matrix(T), [0], [n - 1])
    assert_array_almost_equal(q, q_sp, 5)
    assert q[0] == 0 and q[n - 1] == 1
    assert np.all((q >= 0) & (q <= 1))


def test_fluxes():
    Tij0 = np.array([[0.5, 0.5, 0],
                     [0.5, 0, 0.5],
                     [0, 0.5, 0.5]])
    true_fluxes = np.zeros((3, 3))
    true_fluxes[0, 1] = 1 / 12.
    true_fluxes[1, 2] = 1 / 12.
    true_fluxes = np.around(true_fluxes, 5)

    for arr_type in ARR_TYPES:
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            Tij = arr_type(Tij0)
        for pops in (np.zeros(3) + 1 / 3., None):
            calc = reactive_fluxes(Tij, 0, 2, populations=pops)
            if hasattr(calc, 'todense'):
                calc = np.array(calc.todense()).astype(np.double)
            assert_array_equal(np.around(calc, 5), true_fluxes)


def test_net_fluxes_nonnegative():
    Tij = np.array([[0.5, 0.4, 0.1],
                    [0.25, 0.5, 0.25],
                    [0.1, 0.5, 0.4]])
    net = net_fluxes(Tij, 0, 2)
    assert np.all(np.asarray(net) >= 0)


def test_reactive_populations():
    Tij = np.array([[0.5, 0.4, 0.1],
                    [0.25, 0.5, 0.25],
                    [0.1, 0.5, 0.4]])
    pops = reactive_populations(Tij, 0, 2)
    assert_array_almost_equal(pops.sum(), 1.0)
    # only the intermediate state carries reactive density
    assert pops[1] == 1.0


def test_mfpts():
    tcounts = np.array([[2, 1, 1], [2, 1, 2], [3, 2, 1]])
    T = tcounts / tcounts.sum(axis=1)[:, None]

    all_mfpts = mfpts(T)
    assert_array_almost_equal(
        all_mfpts,
        np.array([[0., 3.71428571, 3.5],
                  [2.3125, 0., 3.],
                  [2.125, 3.42857143, 0.]]), 5)

    sink_mfpts = mfpts(T, sinks=[0])
    assert_array_almost_equal(sink_mfpts, np.array([0., 2.3125, 2.125]),
                              5)
    # lagtime scaling
    assert_array_almost_equal(mfpts(T, sinks=[0], lagtime=10.),
                              10 * sink_mfpts, 5)


def test_top_path_simple_chain():
    # 0 -> 1 -> 3 carries 0.3; 0 -> 2 -> 3 carries 0.1
    net = np.zeros((4, 4))
    net[0, 1] = 0.3
    net[1, 3] = 0.3
    net[0, 2] = 0.1
    net[2, 3] = 0.1
    path, flux = top_path([0], [3], net)
    assert_array_equal(path, [0, 1, 3])
    assert flux == 0.3


def test_top_path_bottleneck():
    # wide start, narrow middle: bottleneck defines path flux
    net = np.zeros((4, 4))
    net[0, 1] = 1.0
    net[1, 2] = 0.05
    net[2, 3] = 1.0
    net[0, 3] = 0.04
    path, flux = top_path([0], [3], net)
    assert_array_equal(path, [0, 1, 2, 3])
    assert np.isclose(flux, 0.05)


def test_paths_subtract_and_bottleneck():
    net = np.zeros((4, 4))
    net[0, 1] = 0.3
    net[1, 3] = 0.3
    net[0, 2] = 0.1
    net[2, 3] = 0.1
    for scheme in ('subtract', 'bottleneck'):
        p, f = paths([0], [3], net, remove_path=scheme, num_paths=5)
        assert len(p) == 2
        assert_array_equal(p[0], [0, 1, 3])
        assert_array_equal(p[1], [0, 2, 3])
        assert_array_almost_equal(f, [0.3, 0.1])


def test_paths_from_tpt_pipeline():
    """committors -> fluxes -> net fluxes -> paths, end to end."""
    rng = np.random.default_rng(1)
    n = 20
    C = rng.integers(1, 20, size=(n, n))
    from enspara_tpu.msm import builders
    _, T, pi = builders.mle(C.astype(float))
    net = net_fluxes(T, [0], [n - 1], populations=pi)
    p, f = paths([0], [n - 1], np.asarray(net), num_paths=10)
    assert len(p) >= 1
    assert np.all(f > 0)
    assert all(pp[0] == 0 and pp[-1] == n - 1 for pp in p)


def test_refined_solve_matches_direct():
    # fp32 LU + fp64 refinement reaches direct-solve accuracy on a
    # sparse M-matrix system (the committors/mfpts workhorse)
    import scipy.sparse

    from enspara_tpu.tpt import core

    rng = np.random.default_rng(5)
    n = 400
    A = scipy.sparse.random(n, n, density=0.02, random_state=7)
    A = scipy.sparse.eye(n) + 0.5 * A / np.abs(A).sum(axis=1).max()
    A = A.tocsr()
    b = rng.normal(size=(n, 2))
    x = core._refined_solve(A.toarray(), b, A_exact=A)
    assert x is not None
    x_ref = scipy.sparse.linalg.spsolve(A.tocsc(),
                                        scipy.sparse.csc_matrix(b))
    x_ref = np.asarray(x_ref.todense())
    assert_allclose(x, x_ref, rtol=1e-8, atol=1e-10)


def test_committors_sparse_matches_dense_10k_style():
    # ring + shortcuts topology (SuperLU's worst case) at small n:
    # the sparse input path must agree with the dense solve
    import scipy.sparse

    n = 300
    rng = np.random.default_rng(9)
    rows, cols, vals = [], [], []
    for off in (-1, 0, 1):
        idx = np.arange(n)
        rows.append(idx)
        cols.append((idx + off) % n)
        vals.append(np.full(n, 0.3 if off else 0.4))
    m = 3 * n
    rows.append(rng.integers(0, n, m))
    cols.append(rng.integers(0, n, m))
    vals.append(np.full(m, 0.01))
    C = scipy.sparse.coo_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n)).tocsr()
    T = scipy.sparse.diags(1.0 / np.asarray(C.sum(1)).ravel()) @ C

    q_sparse = committors(T, [0], [n // 2])
    q_dense = committors(T.toarray(), [0], [n // 2])
    assert_allclose(q_sparse, q_dense, rtol=1e-6, atol=1e-9)
    assert q_sparse.min() >= 0 and q_sparse.max() <= 1 + 1e-12


def test_dense_on_device_scatter_matches_toarray():
    # the device scatter densification must equal host toarray exactly,
    # and feed _refined_solve to the same answer
    import scipy.sparse

    from enspara_tpu.tpt import core

    rng = np.random.default_rng(17)
    n = 350
    A = scipy.sparse.random(n, n, density=0.03, random_state=3).tolil()
    A[0, 0] = 0.0                       # explicit zero survives tocoo
    A = scipy.sparse.eye(n) + 0.5 * A / np.abs(A).sum(axis=1).max()
    A = A.tocsr()

    dev = np.asarray(core._dense_on_device(A))
    assert_allclose(dev, A.toarray().astype(np.float32), rtol=0, atol=0)

    b = rng.normal(size=n)
    x_dev = core._refined_solve(core._dense_on_device(A), b, A_exact=A)
    x_host = core._refined_solve(A.toarray(), b, A_exact=A)
    assert x_dev is not None and x_host is not None
    assert_allclose(x_dev, x_host, rtol=1e-9, atol=1e-12)


def test_committors_mfpts_large_sparse_cg_path():
    # past the densification cap the reversible pi-symmetrized-CG
    # engine must agree with the direct sparse LU to solver precision,
    # with and without pi given (the no-pi call exercises the ARPACK
    # stationary estimate + reversibility detection)
    from enspara_tpu.msm import builders
    from enspara_tpu.msm.synthetic_data import sparse_metastable_counts
    from enspara_tpu.tpt import core

    n = 20_000
    C = sparse_metastable_counts(n, n_blocks=10, seed=7)
    _, T, pi = builders.transpose(C)
    T = scipy.sparse.csr_matrix(T)
    pi = np.asarray(pi)
    assert T.shape[0] > core._DENSE_SOLVE_MAX_STATES

    sources, sinks = [0, 1], [n - 2, n - 1]
    q = committors(T, sources, sinks, pi=pi)
    q_nopi = committors(T, sources, sinks)

    A, b = core._absorbing_csr_system(
        T, np.asarray(sinks), np.asarray(sources),
        np.asarray(sources + sinks))
    lu = scipy.sparse.linalg.splu(A.tocsc(),
                                  permc_spec='MMD_AT_PLUS_A')
    q_lu = lu.solve(np.asarray(b, dtype=np.float64))
    q_lu[sinks] = 1.0
    assert_allclose(q, q_lu, rtol=1e-9, atol=1e-12)
    # the ARPACK stationary estimate perturbs the symmetrizer by
    # ~1e-9, which propagates linearly into the solution
    assert_allclose(q_nopi, q_lu, rtol=1e-7, atol=1e-10)

    mf = mfpts(T, sinks=sinks, populations=pi)
    c = np.ones(n)
    c[sinks] = 0.0
    A2, _ = core._absorbing_csr_system(
        T, np.asarray(sinks), np.empty(0, dtype=int),
        np.asarray(sinks))
    mf_lu = scipy.sparse.linalg.splu(
        A2.tocsc(), permc_spec='MMD_AT_PLUS_A').solve(c)
    mf_lu[sinks] = 0.0
    assert_allclose(mf, mf_lu, rtol=1e-8, atol=1e-9)


def test_committors_large_sparse_nonreversible_falls_back(monkeypatch):
    # a non-reversible chain past the cap must detect irreversibility
    # and still solve correctly through the direct path. The cap is
    # monkeypatched down instead of exceeding the real 16384: the
    # directed-ring topology is chosen FOR its SuperLU fill-in
    # pathology, which costs ~7 min of suite time at 17k states while
    # exercising the identical dispatch at 4k
    from enspara_tpu.tpt import core as _core
    monkeypatch.setattr(_core, '_DENSE_SOLVE_MAX_STATES', 1000)
    n = 4_000
    rng = np.random.default_rng(5)
    # directed ring with shortcuts: strongly non-reversible
    i = np.arange(n)
    rows = np.concatenate([i, i, rng.integers(0, n, n)])
    cols = np.concatenate([(i + 1) % n, (i + 7) % n,
                           rng.integers(0, n, n)])
    vals = np.concatenate([np.full(n, 5.0), np.full(n, 1.0),
                           rng.random(n)])
    C = scipy.sparse.coo_matrix((vals, (rows, cols)),
                                shape=(n, n)).tocsr()
    T = scipy.sparse.diags(1.0 / np.asarray(C.sum(1)).ravel()) @ C

    from enspara_tpu.tpt import core
    pi_est = core._stationary_estimate(T.tocsr())
    assert pi_est is None or not core._is_reversible(
        T.tocsr(), pi_est)

    sources, sinks = [0], [n // 2]
    q = committors(T, sources, sinks)
    A, b = core._absorbing_csr_system(
        T, np.asarray(sinks), np.asarray(sources),
        np.asarray(sources + sinks))
    q_lu = scipy.sparse.linalg.splu(A.tocsc()).solve(
        np.asarray(b, dtype=np.float64))
    q_lu[sinks] = 1.0
    assert_allclose(q, q_lu, rtol=1e-9, atol=1e-12)


def test_mfpts_large_sparse_takes_cg_not_fallback(caplog):
    """MFPT solutions have |x| ~ 1/gap >> |b|; the CG acceptance must
    scale with |x| (normwise backward error), not |b| — a b-relative
    acceptance rejected converged solves and silently fell back to a
    ~30x slower direct factorization (regression)."""
    import logging

    from enspara_tpu.msm import builders
    from enspara_tpu.msm.synthetic_data import sparse_metastable_counts
    from enspara_tpu.tpt import core

    n = 20_000
    C = sparse_metastable_counts(n, n_blocks=10, seed=3)
    _, T, pi = builders.transpose(C)
    T = scipy.sparse.csr_matrix(T)
    sinks = [n - 2, n - 1]
    with caplog.at_level(logging.INFO, logger='enspara_tpu.tpt.core'):
        mf = mfpts(T, sinks=sinks, populations=np.asarray(pi))
    assert mf.shape == (n,) and (mf[sinks] == 0).all()
    assert not any('stalled' in r.message for r in caplog.records), \
        [r.message for r in caplog.records]


def test_committors_duplicate_sinks_are_deduplicated():
    """Listing a sink twice must not double the committor (the RHS is
    built from UNIQUE sink columns; probabilities cannot exceed 1)."""
    rng = np.random.default_rng(9)
    T = rng.random((6, 6)) + np.eye(6)
    T /= T.sum(axis=1, keepdims=True)
    q1 = committors(T, [0], [5])
    q2 = committors(T, [0], [5, 5])
    assert_allclose(q1, q2, atol=1e-12)
    assert np.all(q2 <= 1.0 + 1e-12)
    # sparse path too
    import scipy.sparse as sp
    q3 = committors(sp.csr_matrix(T), [0], [5, 5])
    assert_allclose(q1, q3, atol=1e-9)


def _failing_device_lu(monkeypatch):
    """Route TPT to its device LU path and make the factorization fail
    the way a device error would."""
    import pytest
    from enspara_tpu.tpt import core as _core

    def boom():
        raise RuntimeError('device LU failed')

    monkeypatch.setattr(_core, 'on_accelerator', lambda: True)
    monkeypatch.setattr(_core, '_lu_jitted', boom)
    return pytest.raises(RuntimeError, match='device LU failed')


def _chain(n=80):
    T = np.diag(np.full(n, 0.5)) + np.diag(np.full(n - 1, 0.25), 1) \
        + np.diag(np.full(n - 1, 0.25), -1)
    T[0, 0] = T[-1, -1] = 0.75
    return T


def test_device_lu_failure_propagates_sparse(monkeypatch):
    """A failing device LU on the sparse committor path raises; it is
    not swapped for the host solver behind the caller's back."""
    with _failing_device_lu(monkeypatch):
        committors(scipy.sparse.csr_matrix(_chain()), [0], [79])


def test_device_lu_failure_propagates_dense(monkeypatch):
    with _failing_device_lu(monkeypatch):
        committors(_chain(), [0], [79])


def test_device_lu_failure_propagates_mfpts(monkeypatch):
    with _failing_device_lu(monkeypatch):
        mfpts(_chain(), sinks=[79])
