"""MSM layer tests.

Golden values follow the reference's precision contract for the
TRIMMABLE dataset (reference: enspara/test/msm_data.py:6-79): exact
transition counts and transition probabilities / equilibrium
populations to 1e-4, for the normalize and transpose builders, with and
without ergodic trimming.
"""

import numpy as np
import pytest
import scipy.sparse
from numpy.testing import assert_array_equal, assert_allclose

from enspara_tpu import exception, msm
from enspara_tpu.msm import builders
from enspara_tpu.msm.transition_matrices import TrimMapping
from enspara_tpu.msm.libmsm import _mle_prinz_dense, _mle_prinz_dense_py

ARR_TYPES = [
    np.array, scipy.sparse.coo_matrix, scipy.sparse.csr_matrix,
    scipy.sparse.csc_matrix, scipy.sparse.lil_matrix,
]

# the TRIMMABLE dataset: 3 trajectories over 4 states with -1 gaps
ASSIGNS = np.array(
    [([0] * 30 + [1] * 20 + [-1] * 10),
     ([2] * 20 + [-1] * 5 + [1] * 35),
     ([0] * 10 + [1] * 30 + [2] * 19 + [3])])

NO_TRIM_NORMALIZE_TCOUNTS = np.array([[38, 2, 0, 0],
                                      [0, 82, 1, 0],
                                      [0, 1, 37, 1],
                                      [0, 0, 0, 0]])
NO_TRIM_NORMALIZE_TPROBS = np.array(
    [[0.95, 0.05, 0., 0.],
     [0., 0.987951, 0.012048, 0.],
     [0., 0.025641, 0.948717, 0.025641],
     [0., 0., 0., 0.]])
NO_TRIM_NORMALIZE_EQ = np.array([0., 0.788068, 0.206606, 0.005326])

NO_TRIM_TRANSPOSE_TCOUNTS = np.array([[38, 1, 0, 0],
                                      [1, 82, 1, 0],
                                      [0, 1, 37, 0.5],
                                      [0, 0, 0.5, 0]])
NO_TRIM_TRANSPOSE_TPROBS = np.array(
    [[0.974358, 0.025641, 0., 0.],
     [0.011904, 0.976190, 0.011905, 0.],
     [0., 0.025974, 0.961038, 0.01299],
     [0., 0., 1., 0.]])
NO_TRIM_TRANSPOSE_EQ = np.array([0.240741, 0.518519, 0.237654, 0.003086])

TRIM_TCOUNTS = np.array([[82, 1], [1, 37]])
TRIM_TPROBS = np.array([[0.987952, 0.012048],
                        [0.026316, 0.973684]])
TRIM_EQ = np.array([0.68595, 0.31405])

IMPLIED_TIMESCALES_NORMALIZE = np.array(
    [[19.495726], [19.615267], [20.094898], [19.796650]])
IMPLIED_TIMESCALES_TRANSPOSE = np.array(
    [[38.497835], [36.990989], [35.478863], [33.960748]])
IMPLIED_TIMESCALES_TRIM_TRANSPOSE = np.array(
    [[25.562856], [24.384637], [23.198114], [22.001933]])


def test_assigns_to_counts_golden():
    C = msm.assigns_to_counts(ASSIGNS, lag_time=1)
    assert scipy.sparse.issparse(C)
    assert_array_equal(C.toarray(), NO_TRIM_NORMALIZE_TCOUNTS)


def test_assigns_to_counts_gap_compaction():
    """-1 frames are stripped BEFORE pairing: transitions bridge gaps."""
    a = np.array([[0, -1, 1]])
    C = msm.assigns_to_counts(a, lag_time=1).toarray()
    assert C[0, 1] == 1


def test_assigns_to_counts_requires_2d():
    from enspara_tpu.exception import DataInvalid
    with pytest.raises(DataInvalid):
        msm.assigns_to_counts(np.array([0, 1, 2]), lag_time=1)
    with pytest.raises(DataInvalid):
        msm.assigns_to_counts(ASSIGNS, lag_time=0)


@pytest.mark.parametrize('arr_type', ARR_TYPES)
def test_normalize_builder_golden(arr_type):
    C = arr_type(NO_TRIM_NORMALIZE_TCOUNTS)
    C_out, T, eq = builders.normalize(C)
    T = T.toarray() if scipy.sparse.issparse(T) else np.asarray(T)
    assert_allclose(T, NO_TRIM_NORMALIZE_TPROBS, atol=1e-4)
    assert_allclose(eq, NO_TRIM_NORMALIZE_EQ, atol=1e-4)


@pytest.mark.parametrize('arr_type', ARR_TYPES)
def test_transpose_builder_golden(arr_type):
    C = arr_type(NO_TRIM_NORMALIZE_TCOUNTS)
    C_out, T, eq = builders.transpose(C)
    C_out = C_out.toarray() if scipy.sparse.issparse(C_out) \
        else np.asarray(C_out)
    T = T.toarray() if scipy.sparse.issparse(T) else np.asarray(T)
    assert_allclose(C_out, NO_TRIM_TRANSPOSE_TCOUNTS, atol=1e-9)
    assert_allclose(T, NO_TRIM_TRANSPOSE_TPROBS, atol=1e-4)
    assert_allclose(eq, NO_TRIM_TRANSPOSE_EQ, atol=1e-4)


def test_msm_normalize_with_trimming_golden():
    m = msm.MSM(lag_time=1, method='normalize', trim=True).fit(ASSIGNS)
    assert_array_equal(np.asarray(
        m.tcounts_.toarray() if scipy.sparse.issparse(m.tcounts_)
        else m.tcounts_), TRIM_TCOUNTS)
    T = m.tprobs_.toarray() if scipy.sparse.issparse(m.tprobs_) \
        else np.asarray(m.tprobs_)
    assert_allclose(T, TRIM_TPROBS, atol=1e-4)
    assert_allclose(m.eq_probs_, TRIM_EQ, atol=1e-4)
    assert m.mapping_ == TrimMapping([(1, 0), (2, 1)])


def test_msm_transpose_no_trim_golden():
    m = msm.MSM(lag_time=1, method='transpose', trim=False).fit(ASSIGNS)
    assert m.n_states_ == 4
    assert m.mapping_ == TrimMapping([(0, 0), (1, 1), (2, 2), (3, 3)])
    assert_allclose(m.eq_probs_, NO_TRIM_TRANSPOSE_EQ, atol=1e-4)


def test_implied_timescales_golden():
    got = msm.implied_timescales(
        ASSIGNS, lag_times=[1, 2, 3, 4], method=builders.normalize,
        n_times=1)
    assert_allclose(got, IMPLIED_TIMESCALES_NORMALIZE, rtol=1e-5)
    # the reference's no-trim transpose golden is slightly stale (its
    # own test computes but never asserts it, test_msm_funcs.py:75-78);
    # match at the reference suite's 1e-3 tolerance
    got = msm.implied_timescales(
        ASSIGNS, lag_times=[1, 2, 3, 4], method=builders.transpose,
        n_times=1)
    assert_allclose(got, IMPLIED_TIMESCALES_TRANSPOSE, rtol=1e-3)
    got = msm.implied_timescales(
        ASSIGNS, lag_times=[1, 2, 3, 4], method=builders.transpose,
        n_times=1, trim=True)
    assert_allclose(got, IMPLIED_TIMESCALES_TRIM_TRANSPOSE, rtol=1e-5)


def test_implied_timescales_parallel_matches_serial():
    serial = msm.implied_timescales(
        ASSIGNS, [1, 2, 3], method=builders.transpose, n_times=1)
    par = msm.implied_timescales(
        ASSIGNS, [1, 2, 3], method=builders.transpose, n_times=1,
        n_procs=3)
    assert_allclose(serial, par)


def test_trim_disconnected_no_renumber():
    mapping, trimmed = msm.trim_disconnected(
        NO_TRIM_NORMALIZE_TCOUNTS, renumber_states=False)
    assert trimmed.shape == (4, 4)
    assert trimmed[0].sum() == 0
    assert mapping == TrimMapping([(1, 1), (2, 2)])


def test_trim_mapping_csv_roundtrip(tmp_path):
    tm = TrimMapping([(1, 0), (2, 1), (5, 2)])
    fn = str(tmp_path / 'mapping.csv')
    tm.save(fn)
    assert TrimMapping.load(fn) == tm


def test_trim_mapping_rejects_malformed_rows(tmp_path):
    fn = str(tmp_path / 'mapping.csv')
    # trailing blank line is tolerated; a wrong-column-count row is not
    with open(fn, 'w') as f:
        f.write('original,mapped\n1,0\n2,1\n\n')
    assert TrimMapping.load(fn) == TrimMapping([(1, 0), (2, 1)])
    with open(fn, 'w') as f:
        f.write('original,mapped\n1,0\n2,1,\n')
    with pytest.raises(exception.DataInvalid):
        TrimMapping.load(fn)


# ------------------------- Prinz MLE ---------------------------------

def _random_counts(rng, n):
    C = rng.integers(1, 50, size=(n, n)).astype(float)
    return C


def test_mle_cpp_matches_python():
    rng = np.random.default_rng(0)
    C = _random_counts(rng, 12)
    T_c, pi_c = _mle_prinz_dense(C)
    T_py, pi_py = _mle_prinz_dense_py(C)
    assert_allclose(T_c, T_py, atol=1e-9)
    assert_allclose(pi_c, pi_py, atol=1e-9)


def test_mle_detailed_balance_and_stochastic():
    rng = np.random.default_rng(1)
    C = _random_counts(rng, 8)
    _, T, pi = builders.mle(C)
    assert_allclose(T.sum(1), np.ones(8), atol=1e-12)
    assert_allclose(pi.sum(), 1.0, atol=1e-12)
    # detailed balance: pi_i T_ij == pi_j T_ji
    flux = pi[:, None] * T
    assert_allclose(flux, flux.T, atol=1e-10)
    # pi is the stationary distribution
    assert_allclose(pi @ T, pi, atol=1e-10)


@pytest.mark.parametrize('arr_type', [np.array, scipy.sparse.coo_matrix])
def test_mle_container_polymorphic(arr_type):
    rng = np.random.default_rng(2)
    C = arr_type(_random_counts(rng, 5))
    C_out, T, eq = builders.mle(C)
    assert isinstance(T, type(C)) or isinstance(T, np.ndarray)


def test_mle_device_reaches_same_fixed_point():
    rng = np.random.default_rng(3)
    C = _random_counts(rng, 10)
    _, T_host, pi_host = builders.mle(C)
    _, T_dev, pi_dev = builders.mle_device(C)
    assert_allclose(np.asarray(T_dev), T_host, atol=5e-4)
    assert_allclose(np.asarray(pi_dev), pi_host, atol=5e-4)


def test_mle_prior_counts():
    rng = np.random.default_rng(4)
    C = _random_counts(rng, 4)
    C_out, T, eq = builders.mle(C, prior_counts=1)
    assert_array_equal(np.asarray(C_out), C + 1)


# ------------------------- other components --------------------------

def test_msm_save_load_roundtrip(tmp_path):
    m = msm.MSM(lag_time=1, method='transpose', trim=True).fit(ASSIGNS)
    path = str(tmp_path / 'msm_dir')
    m.save(path)
    m2 = msm.MSM.load(path)
    assert m2 == m


def test_msm_pickle_roundtrip():
    """MSM objects survive pickling (reference: test_msm_obj.py
    test_msm_roundtrip_pickle)."""
    import pickle

    m = msm.MSM(lag_time=1, method='transpose', trim=True).fit(ASSIGNS)
    m2 = pickle.loads(pickle.dumps(m))
    assert m2 == m


def test_mle_does_not_mutate_counts():
    """The MLE builder must leave the input counts untouched
    (reference: test_msm_funcs.py test_mle_not_in_place)."""
    rng = np.random.default_rng(0)
    C = rng.integers(1, 30, size=(8, 8)).astype(np.float64)
    C_orig = C.copy()
    builders.mle(C)
    assert_allclose(C, C_orig)


def test_eigenspectrum_left_right():
    _, T, _ = builders.transpose(NO_TRIM_NORMALIZE_TCOUNTS)
    vals_l, vecs_l = msm.eigenspectrum(T, n_eigs=3, left=True)
    vals_r, vecs_r = msm.eigenspectrum(T, n_eigs=3, left=False)
    assert_allclose(vals_l, vals_r, atol=1e-12)
    assert_allclose(vals_l[0], 1.0, atol=1e-12)
    # eq populations stationary
    assert_allclose(vecs_l[:, 0] @ T, vecs_l[:, 0], atol=1e-12)


def test_eq_probs_detailed_balance_fast_path():
    from enspara_tpu.msm.transition_matrices import \
        _eq_probs_detailed_balance
    from enspara_tpu.msm.synthetic_data import sparse_metastable_counts

    # reversible (transpose-built) chain: O(nnz) tree walk must agree
    # with the builder's pi and with the ARPACK left eigenvector
    C = sparse_metastable_counts(3000, 4, seed=3)
    _, T, pi_builder = builders.transpose(C)
    pi_fast = _eq_probs_detailed_balance(T)
    assert pi_fast is not None
    assert_allclose(pi_fast, pi_builder, atol=1e-14)
    assert_allclose(msm.eq_probs(T), pi_builder, atol=1e-12)
    # certified stationary: pi T == pi
    assert np.abs(pi_fast @ T - pi_fast).max() < 1e-14

    # non-reversible chain must be detected and refused
    rng = np.random.default_rng(0)
    Cd = scipy.sparse.random(
        150, 150, density=0.2, random_state=1,
        data_rvs=lambda k: rng.integers(1, 10, k).astype(float))
    Cd = (Cd + scipy.sparse.eye(150)).tocsr()
    _, Tn, _ = builders.normalize(Cd)
    assert _eq_probs_detailed_balance(Tn) is None
    pi_n = msm.eq_probs(Tn)             # eigensolver fallback
    assert abs(pi_n.sum() - 1) < 1e-9
    assert np.abs(pi_n @ Tn - pi_n).max() < 1e-9

    # rows not stochastic -> refused
    assert _eq_probs_detailed_balance(np.eye(5) * 0.7) is None
    # symmetric support graph disconnected -> refused (one-way links
    # between two reversible blocks)
    B = np.array(builders.transpose(np.ones((2, 2)))[1])
    Td = np.zeros((4, 4))
    Td[:2, :2] = B * 0.9
    Td[2:, 2:] = B
    Td[0, 2] = 0.2                      # forward-only bridge
    Td /= Td.sum(axis=1, keepdims=True)
    assert _eq_probs_detailed_balance(Td) is None


def test_synthetic_trajectory_distribution():
    T = np.array([[0.9, 0.1], [0.4, 0.6]])
    traj = msm.synthetic_trajectory(T, 0, 8000, random_state=0)
    eq = msm.eq_probs(T)
    frac = (traj == 0).mean()
    assert abs(frac - eq[0]) < 0.05


def test_synthetic_trajectory_rejects_dead_rows():
    # a row with zero outgoing probability must fail loudly, not clamp
    T = np.array([[0.0, 1.0], [0.0, 0.0]])
    with pytest.raises(exception.DataInvalid):
        msm.synthetic_trajectory(T, 0, 10, random_state=0)


def test_synthetic_trajectory_device_distribution():
    T = np.array([[0.9, 0.1], [0.4, 0.6]])
    chains = msm.synthetic_trajectory_device(T, np.zeros(50, int), 300)
    assert chains.shape == (50, 300)
    eq = msm.eq_probs(T)
    frac = (chains[:, 100:] == 0).mean()
    assert abs(frac - eq[0]) < 0.05


def test_synthetic_ensemble_converges_to_eq():
    _, T, eq = builders.transpose(TRIM_TCOUNTS)
    p, obs = msm.synthetic_ensemble(T, np.array([1.0, 0.0]), 2000)
    assert_allclose(p, eq, atol=1e-3)


def test_bootstrap_msms():
    msms = msm.MSMs(ASSIGNS, lag_time=1, method=builders.transpose,
                    n_trials=5, random_state=0)
    assert len(msms) == 5
    for m in msms:
        assert m.n_states_ >= 2


def test_counts_device_matches_host_gapfree():
    rng = np.random.default_rng(5)
    assigns = rng.integers(0, 6, size=(4, 100))
    host = msm.assigns_to_counts(assigns, lag_time=3).toarray()
    mask = np.ones_like(assigns, dtype=bool)
    dev = np.asarray(msm.assigns_to_counts_device(
        assigns, mask, lag_time=3, n_states=6))
    assert_array_equal(host, dev)

    # ragged via padding: mask out the tail of row 0
    mask2 = mask.copy()
    mask2[0, 60:] = False
    assigns2 = [assigns[0][:60]] + [assigns[i] for i in range(1, 4)]
    from enspara_tpu.ra import RaggedArray
    host2 = msm.assigns_to_counts(
        RaggedArray(assigns2), lag_time=3).toarray()
    dev2 = np.asarray(msm.assigns_to_counts_device(
        assigns, mask2, lag_time=3, n_states=6))
    assert_array_equal(host2, dev2)


def test_counts_matmul_path_exact():
    """The one-hot matmul counting path is
    exactly equal to the scatter/bincount path — masks, -1 gaps,
    strided windows, and non-divisible block padding included."""
    rng = np.random.default_rng(11)
    # 4 x 1031 frames: flat pair count not a multiple of the 2048 block
    assigns = rng.integers(-1, 9, size=(4, 1031))
    mask = rng.random(assigns.shape) < 0.9
    for lag, sliding in ((1, True), (4, True), (3, False)):
        scat = np.asarray(msm.assigns_to_counts_device(
            assigns, mask, lag_time=lag, n_states=9,
            sliding_window=sliding, use_matmul=False))
        mm = np.asarray(msm.assigns_to_counts_device(
            assigns, mask, lag_time=lag, n_states=9,
            sliding_window=sliding, use_matmul=True))
        assert_array_equal(scat, mm)
    assert scat.sum() > 0


def test_assigns_to_counts_sharded_matches_host():
    """Trajectory-sharded counting over the 8-device mesh equals the
    host counts on gap-free data (and needs no halo)."""
    from enspara_tpu.msm.transition_matrices import (
        assigns_to_counts, assigns_to_counts_sharded)
    from enspara_tpu.parallel import frame_mesh

    rng = np.random.default_rng(3)
    assigns = rng.integers(0, 7, size=(13, 211))   # 13 rows: pad test
    mask = np.ones_like(assigns, dtype=bool)
    mask[:, 200:] = False                           # ragged tails

    host = assigns_to_counts(
        [row[:200] for row in assigns], max_n_states=7,
        lag_time=3).toarray()
    dev = np.asarray(assigns_to_counts_sharded(
        assigns, mask, 3, 7, mesh=frame_mesh()))
    assert_array_equal(dev, host)


def test_bootstrap_fast_equals_naive():
    """The additive-counts bootstrap path produces MSMs exactly equal
    to re-counting the resampled rows, for the same resampling RNG."""
    from enspara_tpu.msm.bootstrap import MSMs

    fast = MSMs(ASSIGNS, lag_time=1, method='transpose', n_trials=4,
                random_state=42, fast=True)
    slow = MSMs(ASSIGNS, lag_time=1, method='transpose', n_trials=4,
                random_state=42, fast=False)
    assert len(fast) == len(slow) == 4
    for mf, ms in zip(fast, slow):
        assert mf == ms


def test_msm_zip_save_load_roundtrip(tmp_path):
    """Zip-archive persistence (extension: the reference declares
    zipfile= but raises NotImplementedError, msm.py:191/254)."""
    m = msm.MSM(lag_time=1, method=builders.transpose, trim=True)
    m.fit(ASSIGNS)
    zpath = str(tmp_path / 'model.zip')
    m.save(zpath, zipfile=True)
    m2 = msm.MSM.load(zpath)
    assert m2 == m
    # overwrite refused without force
    with pytest.raises(exception.DataInvalid):
        m.save(zpath, zipfile=True)
    m.save(zpath, zipfile=True, force=True)


def test_msm_zip_load_rejects_traversal(tmp_path):
    import zipfile as zf
    evil = str(tmp_path / 'evil.zip')
    with zf.ZipFile(evil, 'w') as z:
        z.writestr('../escape.txt', 'x')
    with pytest.raises(exception.DataInvalid):
        msm.MSM.load(evil)


def test_msm_zip_save_force_replaces_directory(tmp_path):
    m = msm.MSM(lag_time=1, method=builders.transpose, trim=True)
    m.fit(ASSIGNS)
    path = str(tmp_path / 'model')
    m.save(path)                         # directory format
    with pytest.raises(exception.DataInvalid):
        m.save(path, zipfile=True)       # refuses without force
    m.save(path, zipfile=True, force=True)   # replaces the dir
    assert msm.MSM.load(path) == m


def test_sharded_counts_validate_state_range():
    """Out-of-range ids were silently dropped inside shard_map; the
    sharded front door now validates the numpy inputs up front
    (r5 review)."""
    from enspara_tpu.msm.transition_matrices import \
        assigns_to_counts_sharded

    a = np.array([[0, 1, 5, 1]])
    m = np.ones_like(a, dtype=bool)
    with pytest.raises(exception.DataInvalid, match='>= n_states'):
        assigns_to_counts_sharded(a, m, 1, n_states=3)


def test_device_counts_allow_masked_sentinels():
    """Sentinel values under mask=False are legal padding; validation
    must only consider masked-in cells (r5 review)."""
    from enspara_tpu.msm.transition_matrices import (
        assigns_to_counts, assigns_to_counts_device)

    a = np.array([[0, 1, 1, 999], [1, 0, 1, 999]])
    m = np.array([[True, True, True, False],
                  [True, True, True, False]])
    C = np.asarray(assigns_to_counts_device(a, m, 1, 2))
    ref = assigns_to_counts(
        np.where(m, a, -1), lag_time=1, max_n_states=2).toarray()
    # device drops gap-spanning pairs; with the gap at the tail the
    # two agree exactly
    np.testing.assert_array_equal(C, ref)


def test_msm_save_force_replaces_file(tmp_path):
    """force=True replaces a prior zip-format save with a directory
    save (r5 review: rmtree only fired for directories)."""
    from enspara_tpu.msm import MSM, builders

    assigns = np.array([[0, 1, 0, 1, 1, 0]])
    m = MSM(lag_time=1, method=builders.transpose)
    m.fit(assigns)
    import os
    path = str(tmp_path / 'model')
    m.save(path, zipfile=True)
    assert os.path.isfile(path)
    m.save(path, force=True)              # dir-mode over the old file
    assert os.path.isdir(path)
    m2 = MSM.load(path)
    np.testing.assert_allclose(np.asarray(m2.tprobs_.todense())
                               if hasattr(m2.tprobs_, 'todense')
                               else np.asarray(m2.tprobs_),
                               np.asarray(m.tprobs_.todense())
                               if hasattr(m.tprobs_, 'todense')
                               else np.asarray(m.tprobs_))
    # without force, a clear DataInvalid
    with pytest.raises(exception.DataInvalid, match='force'):
        m.save(path)
