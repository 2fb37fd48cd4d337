"""App-level integration tests: run the real CLIs against bundled/
synthetic trajectory data in temp dirs and verify outputs — mirroring
the reference's test_apps_cluster.py strategy."""

import os
import pickle

import numpy as np
import pytest
from numpy.testing import assert_array_equal, assert_allclose

from enspara_tpu import io, ra

REF_DATA = '/root/reference/enspara/test/data'
HAVE_REF = os.path.isdir(REF_DATA)

pytestmark = pytest.mark.skipif(not HAVE_REF,
                                reason='reference data not present')


def runhelper(tmp_path, algorithm='khybrid', extra_args=()):
    from enspara_tpu.apps import cluster as cluster_app

    xtc = os.path.join(REF_DATA, 'frame0.xtc')
    top = os.path.join(REF_DATA, 'native.pdb')

    distances = str(tmp_path / 'distances.h5')
    assignments = str(tmp_path / 'assignments.h5')
    centers = str(tmp_path / 'centers.pkl')
    indices = str(tmp_path / 'center-inds.npy')

    argv = ['cluster',
            '--trajectories', xtc, xtc,
            '--topology', top,
            '--algorithm', algorithm,
            '--cluster-number', '4',
            '--atoms', 'name CA or name C or name N',
            '--distances', distances,
            '--assignments', assignments,
            '--center-features', centers,
            '--center-indices', indices,
            '--random-state', '0',
            ] + list(extra_args)
    cluster_app.main(argv)
    return distances, assignments, centers, indices


def test_cluster_app_khybrid(tmp_path):
    distances, assignments, centers, indices = runhelper(tmp_path)

    a = ra.load(assignments)
    d = ra.load(distances)
    assert a.shape[0] == 2          # two trajectories
    assert len(np.unique(np.asarray(a._data if hasattr(a, '_data')
                                    else a))) == 4
    dd = np.asarray(d._data if hasattr(d, '_data') else d)
    assert (dd >= 0).all()

    with open(centers, 'rb') as f:
        ctr = pickle.load(f)
    assert len(ctr) == 4
    inds = np.load(indices)
    assert inds.shape == (4, 2)


def test_cluster_app_kcenters(tmp_path):
    distances, assignments, centers, indices = runhelper(
        tmp_path, algorithm='kcenters')
    a = ra.load(assignments)
    arr = np.asarray(a._data if hasattr(a, '_data') else a)
    assert set(np.unique(arr)) == {0, 1, 2, 3}
    # both trajectories are the same file -> identical assignments
    a2d = np.asarray(a) if not hasattr(a, '_data') else None
    if a2d is not None:
        assert_array_equal(a2d[0], a2d[1])


def test_cluster_app_with_subsample_reassigns(tmp_path):
    distances, assignments, centers, indices = runhelper(
        tmp_path, algorithm='kcenters',
        extra_args=['--subsample', '5'])
    a = ra.load(assignments)
    arr = np.asarray(a)
    # reassignment covers the FULL dataset despite subsampled clustering
    assert arr.shape == (2, 501)


def _feature_files(tmp_path, fmt='npy'):
    rng = np.random.default_rng(4)
    files = []
    for i, n in enumerate((30, 20)):
        x = np.concatenate([
            rng.normal(0, 0.1, (n // 2, 5)),
            rng.normal(3, 0.1, (n - n // 2, 5))]).astype(np.float32)
        if fmt == 'npy':
            fn = str(tmp_path / ('feat%d.npy' % i))
            np.save(fn, x)
            files.append(fn)
        else:
            files.append(x)
    if fmt == 'h5':
        # h5 features are ONE RaggedArray file with one row per
        # trajectory (reference: cluster/util.py:324)
        fn = str(tmp_path / 'feats.h5')
        ra.save(fn, ra.RaggedArray(files))
        return [fn]
    return files


def _run_feature_cluster(tmp_path, files, extra):
    from enspara_tpu.apps import cluster as cluster_app

    distances = str(tmp_path / 'fd.h5')
    assignments = str(tmp_path / 'fa.h5')
    centers = str(tmp_path / 'fc.npy')
    argv = ['cluster', '--features'] + files + [
        '--distances', distances,
        '--assignments', assignments,
        '--center-features', centers,
        '--random-state', '0'] + list(extra)
    cluster_app.main(argv)
    return distances, assignments, centers


def test_feature_cluster_npy_khybrid(tmp_path):
    """Feature-array clustering from .npy inputs (reference:
    test_apps_cluster.py test_feature_cluster_number_khybrid_npy_input)."""
    files = _feature_files(tmp_path, 'npy')
    _, assignments, centers = _run_feature_cluster(
        tmp_path, files,
        ['--algorithm', 'khybrid', '--cluster-number', '2',
         '--cluster-distance', 'euclidean'])
    a = ra.load(assignments)
    flat = np.concatenate([np.asarray(a[i]) for i in range(2)])
    assert len(np.unique(flat)) == 2
    # the two gaussian blobs separate perfectly
    assert len(np.unique(flat[:15])) == 1
    assert len(np.unique(flat[15:30])) == 1
    assert flat[0] != flat[16]
    ctr = np.load(centers)
    assert ctr.shape == (2, 5)


def test_feature_cluster_manhattan(tmp_path):
    files = _feature_files(tmp_path, 'npy')
    _, assignments, _ = _run_feature_cluster(
        tmp_path, files,
        ['--algorithm', 'kcenters', '--cluster-number', '2',
         '--cluster-distance', 'manhattan'])
    a = ra.load(assignments)
    flat = np.concatenate([np.asarray(a[i]) for i in range(2)])
    assert len(np.unique(flat)) == 2


def test_feature_cluster_radius_h5(tmp_path):
    """Radius-based stopping from h5 feature input (reference:
    test_feature_cluster_radius_based_h5_input)."""
    files = _feature_files(tmp_path, 'h5')
    _, assignments, _ = _run_feature_cluster(
        tmp_path, files,
        ['--algorithm', 'kcenters', '--cluster-radius', '1.0',
         '--cluster-distance', 'euclidean'])
    a = ra.load(assignments)
    flat = np.concatenate([np.asarray(a[i]) for i in range(2)])
    # radius 1.0 splits the two blobs (separation ~6.7 in L2)
    assert len(np.unique(flat)) >= 2


def test_cluster_iterations_rejected_for_kcenters(tmp_path):
    """--cluster-iterations with kcenters must be rejected (reference:
    test_feature_cluster_..._iterations_flag_error)."""
    from enspara_tpu import exception

    files = _feature_files(tmp_path, 'npy')
    with pytest.raises(exception.ImproperlyConfigured):
        _run_feature_cluster(
            tmp_path, files,
            ['--algorithm', 'kcenters', '--cluster-number', '2',
             '--cluster-distance', 'euclidean',
             '--cluster-iterations', '3'])


def test_cluster_precision_flag_validation(tmp_path):
    """--precision bf16 is the k-centers frame-storage knob: only valid for
    kcenters + rmsd. Any other combination must be rejected up front."""
    from enspara_tpu import exception

    files = _feature_files(tmp_path, 'npy')
    # wrong metric (euclidean features)
    with pytest.raises(exception.ImproperlyConfigured):
        _run_feature_cluster(
            tmp_path, files,
            ['--algorithm', 'kcenters', '--cluster-number', '2',
             '--cluster-distance', 'euclidean', '--precision', 'bf16'])
    # wrong algorithm (khybrid), even with rmsd
    with pytest.raises(exception.ImproperlyConfigured):
        runhelper(tmp_path, algorithm='khybrid',
                  extra_args=['--precision', 'bf16'])


def test_kcenters_precision_param_roundtrip():
    """KCenters carries precision through get/set_params; the
    functional kcenters() rejects bf16 off the device rmsd path and
    runs it on that path."""
    from enspara_tpu.cluster import KCenters, kcenters
    from enspara_tpu import exception

    est = KCenters(metric='rmsd', n_clusters=3, precision='bf16')
    assert est.get_params()['precision'] == 'bf16'
    est.set_params(precision='fp32')
    assert est.precision == 'fp32'

    # callable metric => host path => bf16 must be rejected
    X = np.random.default_rng(0).normal(size=(10, 4)).astype(np.float32)
    with pytest.raises(exception.ImproperlyConfigured):
        kcenters(X, lambda a, b: np.abs(a - b).sum(axis=1),
                 n_clusters=2, precision='bf16')

    # the device rmsd path stores bf16 frames on every backend
    xyz = np.random.default_rng(1).normal(
        size=(12, 5, 3)).astype(np.float32)
    res = kcenters(xyz, 'rmsd', n_clusters=2, precision='bf16')
    assert len(res.center_indices) == 2


def test_cluster_app_no_reassign(tmp_path):
    """--subsample with --no-reassign skips the assignment/distance
    writes but still writes centers (reference:
    test_rmsd_cluster_subsample_and_noreassign,
    expect_reassignment=False)."""
    distances, assignments, centers, indices = runhelper(
        tmp_path, algorithm='kcenters',
        extra_args=['--subsample', '5', '--no-reassign'])
    assert not os.path.exists(assignments)
    assert not os.path.exists(distances)
    assert os.path.exists(centers)
    inds = np.load(indices)
    assert inds.shape[1] == 2


def test_cluster_app_multitop_multiselection(tmp_path):
    """Two trajectory sets with different topologies and per-set atom
    selections cluster into one shared state space (reference:
    test_rmsd_cluster_multitop_multiselection)."""
    from enspara_tpu.apps import cluster as cluster_app

    xtc1 = os.path.join(REF_DATA, 'frame0.xtc')
    top1 = os.path.join(REF_DATA, 'native.pdb')
    xtc2 = os.path.join(REF_DATA, 'beta-peptide.xtc')
    top2 = os.path.join(REF_DATA, 'beta-peptide.pdb')

    distances = str(tmp_path / 'd.h5')
    assignments = str(tmp_path / 'a.h5')
    centers = str(tmp_path / 'c.pkl')

    cluster_app.main([
        'cluster',
        '--trajectories', xtc1,
        '--topology', top1,
        '--atoms', 'name C or name N',
        '--trajectories', xtc2,
        '--topology', top2,
        '--atoms', 'name CA and resid 0 to 3',
        '--algorithm', 'kcenters',
        '--cluster-number', '3',
        '--subsample', '5', '--no-reassign',
        '--distances', distances,
        '--assignments', assignments,
        '--center-features', centers])

    with open(centers, 'rb') as f:
        ctr = pickle.load(f)
    assert len(ctr) == 3


def test_reassign_app(tmp_path):
    # first run clustering to get centers
    distances, assignments, centers, indices = runhelper(
        tmp_path, algorithm='kcenters')

    from enspara_tpu.apps import reassign as reassign_app
    xtc = os.path.join(REF_DATA, 'frame0.xtc')
    top = os.path.join(REF_DATA, 'native.pdb')
    out_d = str(tmp_path / 'reassign-distances.h5')
    out_a = str(tmp_path / 'reassign-assignments.h5')
    reassign_app.main([
        'reassign',
        '--centers', centers,
        '--trajectories', xtc,
        '--topology', top,
        '--atoms', 'name CA or name C or name N',
        '--distances', out_d,
        '--assignments', out_a])

    a = np.asarray(ra.load(out_a))
    orig = np.asarray(ra.load(str(tmp_path / 'assignments.h5')))
    assert a.shape == (1, 501)
    assert_array_equal(a[0], orig[0])


def test_implied_timescales_app(tmp_path):
    from enspara_tpu.apps import implied_timescales as it_app

    rng = np.random.default_rng(0)
    assigns = rng.integers(0, 4, size=(3, 200))
    afile = str(tmp_path / 'assigns.h5')
    ra.save(afile, ra.RaggedArray(list(assigns)))

    out = str(tmp_path / 'tscales.npy')
    plot = str(tmp_path / 'tscales.png')
    it_app.main(['implied',
                 '--assignments', afile,
                 '--lag-times', '1:10:2',
                 '--n-eigenvalues', '3',
                 '--out', out,
                 '--plot', plot])
    ts = np.load(out)
    assert ts.shape == (5, 3)
    assert os.path.exists(plot)


def test_collect_cards_app(tmp_path):
    from enspara_tpu.apps import collect_cards as cards_app

    xtc = os.path.join(REF_DATA, 'beta-peptide.xtc')
    top = os.path.join(REF_DATA, 'beta-peptide.pdb')
    matrices = str(tmp_path / 'cards.pkl')
    indices = str(tmp_path / 'inds.csv')
    cards_app.main(['collect_cards',
                    '--trajectories', xtc,
                    '--topology', top,
                    '--matrices', matrices,
                    '--indices', indices])
    with open(matrices, 'rb') as f:
        mats = pickle.load(f)
    assert set(mats) == {'Struc_struc_MI', 'Disorder_disorder_MI',
                         'Struc_disorder_MI', 'Disorder_struc_MI'}
    inds = np.loadtxt(indices, delimiter=',')
    assert inds.shape[1] == 4
    assert mats['Struc_struc_MI'].shape == (len(inds), len(inds))


def test_shannon_entropy_app(tmp_path):
    from enspara_tpu.apps import shannon_entropy as se_app

    xtc = os.path.join(REF_DATA, 'beta-peptide.xtc')
    top = os.path.join(REF_DATA, 'beta-peptide.pdb')
    out = str(tmp_path / 'entropies.csv')
    se_app.main(['entropy',
                 '--trajectories', xtc,
                 '--topology', top,
                 '--entropies', out])
    data = np.loadtxt(out, delimiter=',')
    assert data.shape[1] == 2
    assert (data[:, 1] >= 0).all()
    assert (data[:, 1] <= 1.0 + 1e-9).all()


def test_save_states(tmp_path):
    from enspara_tpu.cluster.save_states import save_states

    xtc = os.path.join(REF_DATA, 'frame0.xtc')
    top = os.path.join(REF_DATA, 'native.pdb')
    rng = np.random.default_rng(1)
    assignments = rng.integers(0, 3, size=(1, 501))
    distances = rng.random((1, 501))
    written = save_states(
        assignments, distances,
        traj_filenames=[xtc],
        output_directory=str(tmp_path / 'PDBs'),
        topology=top, n_confs=1, n_processes=2)
    assert len(written) == 3
    for f in written:
        assert os.path.exists(f)
        t = io.load(f)
        assert t.n_atoms == 22


def test_main_dispatcher(tmp_path):
    from enspara_tpu.apps import main as main_app

    rng = np.random.default_rng(0)
    assigns = rng.integers(0, 4, size=(2, 100))
    afile = str(tmp_path / 'assigns.h5')
    ra.save(afile, ra.RaggedArray(list(assigns)))
    out = str(tmp_path / 'ts.npy')
    main_app.main(['enspara', 'implied',
                   '--assignments', afile,
                   '--lag-times', '1:6:2',
                   '--n-eigenvalues', '2',
                   '--out', out])
    assert os.path.exists(out)


def test_prinz_mle_cpp_speed_sanity():
    """The C++ MLE kernel handles a 500-state matrix in seconds (the
    pure-Python mirror would take minutes)."""
    import time
    from enspara_tpu.msm.libmsm import _mle_prinz_dense, _get_lib
    if _get_lib() is None:
        pytest.skip('native kernel unavailable')
    rng = np.random.default_rng(0)
    C = rng.integers(1, 30, size=(500, 500)).astype(float)
    t0 = time.perf_counter()
    T, pi = _mle_prinz_dense(C)
    el = time.perf_counter() - t0
    assert el < 30
    assert np.allclose(T.sum(1), 1, atol=1e-10)
    flux = pi[:, None] * T
    assert np.allclose(flux, flux.T, atol=1e-8)


def test_reassign_function_multitop_heterogeneous(tmp_path):
    """Reference test_apps_reassign.py:129: different topologies and
    per-dataset atom selections; ragged lengths come back as a
    RaggedArray and duplicate trajectories agree exactly."""
    from enspara_tpu.apps.reassign import reassign

    xtc1 = os.path.join(REF_DATA, 'frame0.xtc')
    top1 = os.path.join(REF_DATA, 'native.pdb')
    cards = os.path.join(os.path.dirname(REF_DATA), 'cards_data')
    xtc2 = os.path.join(cards, 'trj0.xtc')
    top2 = os.path.join(cards, 'PROT_only.pdb')

    topologies = [top1, top2]
    trajectories = [[xtc1, xtc1], [xtc2, xtc2]]
    atoms = ['(name N or name O) and (residue 2 or residue 3)',
             '(name CA) and (residue 3 to 5)']

    t = io.load(top1).top
    full = io.load(xtc1, top=top1)
    centers = [full[i].atom_slice(t.select(atoms[0]))
               for i in range(0, len(full), 50)]

    assigns, dists = reassign(topologies, trajectories, atoms, centers)

    assert isinstance(assigns, ra.RaggedArray)
    assert_array_equal(assigns.lengths, [501, 501, 5001, 5001])
    assert len(assigns) == 4
    assert_array_equal(assigns[0], assigns[1])
    assert_array_equal(np.asarray(assigns[0])[::50],
                       range(len(centers)))
    assert_allclose(np.asarray(dists[0]), np.asarray(dists[1]),
                    atol=1e-3)


def test_reassign_function_uniform_returns_ndarray(tmp_path):
    """Reference test_apps_reassign.py:101: same-length datasets come
    back as plain ndarrays."""
    from enspara_tpu.apps.reassign import reassign

    xtc = os.path.join(REF_DATA, 'frame0.xtc')
    top = os.path.join(REF_DATA, 'native.pdb')
    atoms = '(name N or name C or name CA or name H or name O)'

    t = io.load(top).top
    full = io.load(xtc, top=top)
    centers = [full[i].atom_slice(t.select(atoms))
               for i in range(0, len(full), 50)]

    assigns, dists = reassign(
        [top, top], [[xtc], [xtc]], [atoms] * 2, centers)

    assert type(assigns) is np.ndarray
    assert_array_equal(assigns[0], assigns[1])
    assert_array_equal(assigns[0][::50], range(len(centers)))
    assert_allclose(dists[0], dists[1], atol=1e-3)


def test_reassign_app_multitop(tmp_path):
    """Reference test_apps_reassign.py:70: the CLI accepts repeated
    --trajectories/--topology groups with one selection."""
    from enspara_tpu.apps import reassign as reassign_app

    xtc1 = os.path.join(REF_DATA, 'frame0.xtc')
    top1 = os.path.join(REF_DATA, 'native.pdb')
    cards = os.path.join(os.path.dirname(REF_DATA), 'cards_data')
    xtc2 = os.path.join(cards, 'trj0.xtc')
    top2 = os.path.join(cards, 'PROT_only.pdb')

    sel = '(name N or name C or name CA or name O) and (residue 2)'
    t = io.load(top1).top
    full = io.load(xtc1, top=top1)
    centers = [full[i] for i in range(0, len(full), 50)]
    import pickle as pkl
    ctr_f = str(tmp_path / 'ctrs.pkl')
    with open(ctr_f, 'wb') as f:
        pkl.dump(centers, f)

    out_d = str(tmp_path / 'd.h5')
    out_a = str(tmp_path / 'a.h5')
    reassign_app.main([
        'reassign', '--centers', ctr_f,
        '--trajectories', xtc1, xtc1,
        '--topology', top1,
        '--trajectories', xtc2, xtc2,
        '--topology', top2,
        '--atoms', sel,
        '--distances', out_d, '--assignments', out_a])

    a = ra.load(out_a)
    assert_array_equal(a.lengths, [501, 501, 5001, 5001])


def test_implied_timescales_process_units():
    """Reference test_apps_implied_timescales.py:17: timestep
    inference and validation."""
    from enspara_tpu.apps import implied_timescales as it_app
    from enspara_tpu.exception import ImproperlyConfigured

    cards = os.path.join(os.path.dirname(REF_DATA), 'cards_data')
    trj = os.path.join(cards, 'trj0.xtc')

    with pytest.raises(ImproperlyConfigured):
        it_app.process_units(timestep=10, infer_timestep=trj)

    assert it_app.process_units(timestep=10) == (10, 'ns')
    assert it_app.process_units(None, None) == (1, 'frames')
    assert it_app.process_units() == (1, 'frames')
    assert it_app.process_units(infer_timestep=trj) == (100, 'ns')
    assert it_app.process_units(
        infer_timestep=os.path.join(REF_DATA, 'frame0.xtc')) \
        == (1000, 'ns')
    assert it_app.process_units(
        infer_timestep=os.path.join(REF_DATA, 'frame0.h5')) \
        == (1000, 'ns')


def test_implied_timescales_prior_counts_builder():
    """Reference test_apps_implied_timescales.py:47: the app's
    prior_counts wrapper equals normalize(prior_counts=1/n)."""
    from enspara_tpu.apps import implied_timescales as it_app
    from enspara_tpu.msm.builders import normalize

    C = np.array([[7, 1, 3, 1],
                  [1, 8, 3, 1],
                  [0, 7, 9, 2],
                  [0, 2, 3, 4]])
    C_a, T_a, eq_a = it_app.prior_counts(C)
    C_b, T_b, eq_b = normalize(C, prior_counts=1 / len(C))
    assert_array_equal(C_a, C_b)
    assert_array_equal(np.asarray(T_a), np.asarray(T_b))


def test_unique_state_extraction():
    """Reference test_cluster_util.py:71."""
    from enspara_tpu.cluster import save_states

    rng = np.random.default_rng(0)
    assignments = rng.choice([0, 1, 2, 3, 4], 100000)
    assert_array_equal(save_states.unique_states(assignments),
                       [0, 1, 2, 3, 4])
    # -1 (unassigned) frames are excluded
    assert_array_equal(
        save_states.unique_states(np.array([-1, 0, 2, -1, 2])), [0, 2])


def test_cluster_app_checkpoint_roundtrip(tmp_path):
    """--checkpoint writes the unified clustering checkpoint; a second
    kmedoids run warm-starts from it (and must not be worse)."""
    from enspara_tpu.apps import cluster as cluster_app
    from enspara_tpu.util.checkpoint import load_clustering_checkpoint

    ckpt = str(tmp_path / 'ckpt')
    distances, assignments, centers, indices = runhelper(
        tmp_path, algorithm='khybrid',
        extra_args=['--checkpoint', ckpt])

    state = load_clustering_checkpoint(ckpt)
    d0 = np.asarray(ra.load(distances))
    assert state['metadata']['algorithm'] == 'khybrid'
    assert len(state['center_indices']) == 4
    assert state['distances'].shape[0] == d0.size

    # warm-start kmedoids from the checkpoint
    xtc = os.path.join(REF_DATA, 'frame0.xtc')
    top = os.path.join(REF_DATA, 'native.pdb')
    out_d = str(tmp_path / 'd2.h5')
    cluster_app.main([
        'cluster', '--trajectories', xtc, xtc, '--topology', top,
        '--algorithm', 'kmedoids', '--cluster-number', '4',
        '--cluster-iterations', '2',
        '--atoms', 'name CA or name C or name N',
        '--checkpoint', ckpt,
        '--distances', out_d,
        '--assignments', str(tmp_path / 'a2.h5'),
        '--center-features', str(tmp_path / 'c2.pkl'),
        '--center-indices', str(tmp_path / 'ci2.npy')])

    d2 = np.asarray(ra.load(out_d))
    assert np.mean(d2 ** 2) <= np.mean(d0 ** 2) + 1e-9
    # the checkpoint was refreshed by the second run
    state2 = load_clustering_checkpoint(ckpt)
    assert state2['metadata']['algorithm'] == 'kmedoids'

    # warm-start validation: checkpoint + init-* flags conflict
    import pytest as _pytest
    from enspara_tpu.exception import ImproperlyConfigured
    with _pytest.raises(ImproperlyConfigured):
        cluster_app.main([
            'cluster', '--trajectories', xtc, '--topology', top,
            '--algorithm', 'kcenters', '--cluster-number', '4',
            '--atoms', 'name CA', '--checkpoint', ckpt,
            '--distances', out_d,
            '--assignments', str(tmp_path / 'a3.h5'),
            '--center-features', str(tmp_path / 'c3.pkl')])

def test_main_dispatcher_smfret_subcommands():
    """The dispatcher reaches the smFRET apps (an addition over the
    reference, where they are standalone scripts only)."""
    import pytest

    from enspara_tpu.apps import main as main_app

    for sub in ('smfret-dyes', 'smfret-clouds'):
        with pytest.raises(SystemExit) as exc:
            main_app.main(['enspara', sub, '--help'])
        assert exc.value.code == 0


def test_shannon_entropy_functions_vs_reference():
    """The vectorized per-residue aggregation (bincount segment sums)
    must match the reference app's loop formulations on random data
    (live oracle; the reference module is loaded by path since its
    filename has dashes)."""
    import importlib.util

    from _reference_oracle import HAVE_REF, load_reference
    if not HAVE_REF:
        pytest.skip('reference tree not present')
    load_reference()
    spec = importlib.util.spec_from_file_location(
        'ref_shannon',
        '/root/reference/enspara/apps/compute-shannon-entropy.py')
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)

    from enspara_tpu.apps import shannon_entropy as se

    rng = np.random.default_rng(12)
    for _ in range(10):
        nd = int(rng.integers(4, 60))
        n_resis = int(rng.integers(2, 12))
        rmap = rng.integers(0, n_resis, size=nd).astype(float)
        ent_vals = rng.random(nd)
        np.testing.assert_allclose(
            se.sum_dihedral_entropies(ent_vals, rmap, n_resis),
            ref.sum_dihedral_entropies(ent_vals, rmap, n_resis),
            atol=1e-12)
        n_states = rng.integers(2, 4, size=nd)
        np.testing.assert_allclose(
            se.compute_channel_capacities(n_states, rmap, n_resis),
            ref.compute_channel_capacities(n_states, rmap, n_resis),
            atol=1e-12)
        probs = rng.random((nd, 3))
        probs /= probs.sum(axis=1, keepdims=True)
        np.testing.assert_allclose(
            se.compute_dihedral_shannon_entropy(probs),
            ref.compute_dihedral_shannon_entropy(probs), atol=1e-12)


def test_shannon_entropy_tolerates_odd_residue_numbering():
    """resSeq 0 (negative 0-based id) and numbering gaps must not
    crash the segment sums or desynchronize the entropy/residue-id
    arrays (reference behavior crashes on both)."""
    from enspara_tpu.apps import shannon_entropy as se

    # ids: one out-of-range-low (-1), a gap, one out-of-range-high
    rmap = np.array([-1, 0, 0, 2, 5])
    ent_vals = np.array([10.0, 1.0, 2.0, 3.0, 4.0])
    s = se.sum_dihedral_entropies(ent_vals, rmap, 4)
    assert s.shape == (4,)
    assert s[0] == pytest.approx(3.0)    # -1 and 5 dropped
    assert s[2] == pytest.approx(3.0)

    cc = se.compute_channel_capacities(
        np.array([3, 3, 3, 2, 2]), rmap, 4)
    assert cc.shape == (4,)
    assert cc[1] == 0.0                  # gap residue: no capacity

    # pipeline alignment: entropies and residue ids stay paired even
    # when some residues own no dihedral
    norm = se._normalized_residue_entropies(
        ent_vals, np.array([3, 3, 3, 2, 2]), rmap, 4)
    present = se._present_residues(rmap, 4)
    assert present.tolist() == [0, 2]
    table = np.column_stack([present + 1, norm[present]])
    assert table.shape == (2, 2)


def test_shannon_entropy_offset_and_multichain_numbering(tmp_path):
    """Residues are keyed by topology index, not author resSeq:
    numbering that starts at 100 (or repeats across chains) must
    aggregate per residue and label rows with the author ids —
    the reference's resSeq-1 keying silently drops or merges these."""
    from enspara_tpu import io
    from enspara_tpu.apps import shannon_entropy as se

    template = (('N', 'N', (0.000, 0.000, 0.000)),
                ('CA', 'C', (0.146, 0.000, 0.000)),
                ('C', 'C', (0.198, 0.140, 0.050)))
    lines, serial = [], 1
    for res in range(3):
        for name, elem, (x, y, z) in template:
            lines.append(
                'ATOM  %5d %-4s ALA A%4d    %8.3f%8.3f%8.3f  1.00'
                '  0.00          %2s'
                % (serial, name, res + 100,          # numbering @100
                   (x + 0.38 * res) * 10, y * 10, z * 10, elem))
            serial += 1
    lines += ['TER', 'END', '']
    pdb = str(tmp_path / 'offset.pdb')
    with open(pdb, 'w') as f:
        f.write('\n'.join(lines))

    # one dihedral anchored (by its second atom) in each residue
    atom_inds = np.array([[0, 1, 2, 3], [3, 4, 5, 6], [6, 7, 8, 8]])
    ent_vals = np.array([1.0, 2.0, 3.0])
    norm, resi = se.compute_residue_shannon_entropies(
        ent_vals, pdb, atom_inds, np.array([3, 3, 3]))
    # nothing silently dropped, and labels are the author resSeq
    assert len(norm) == 3
    assert resi.tolist() == [100.0, 101.0, 102.0]
    assert np.all(norm > 0)


def test_cluster_random_state_reaches_kmedoids(tmp_path):
    """--random-state seeds kmedoids medoid proposals (r5 review: the
    kwarg was silently dropped for KMedoids, leaving the documented
    flag a no-op)."""
    files = _feature_files(tmp_path, 'npy')

    def run(tag):
        sub = tmp_path / tag
        sub.mkdir()
        _, assignments, _ = _run_feature_cluster(
            sub, files,
            ['--algorithm', 'kmedoids', '--cluster-number', '2',
             '--cluster-iterations', '2',
             '--cluster-distance', 'euclidean'])
        a = ra.load(assignments)
        return np.concatenate([np.asarray(a[i]) for i in range(2)])

    # _run_feature_cluster always passes --random-state 0: two runs
    # must now be identical (they were not while the kwarg was
    # dropped for kmedoids)
    np.testing.assert_array_equal(run('r1'), run('r2'))


def test_smfret_apps_require_subcommand():
    """No subcommand -> usage error, not AttributeError (r5 review)."""
    import pytest
    from enspara_tpu.apps import smFRET_dye_MC, smFRET_point_clouds

    for mod in (smFRET_dye_MC, smFRET_point_clouds):
        with pytest.raises(SystemExit):
            mod.main([])


def test_collect_cards_rejects_multiple_groups(tmp_path):
    import pytest
    from enspara_tpu.apps import collect_cards
    from enspara_tpu.exception import ImproperlyConfigured

    with pytest.raises((ImproperlyConfigured, SystemExit)):
        collect_cards.main([
            '--trajectories', 'a.xtc', '--topology', 'a.pdb',
            '--trajectories', 'b.xtc', '--topology', 'b.pdb',
            '--matrices', str(tmp_path / 'm.pkl'),
            '--buffer-size', '15'])


def test_feature_cluster_subsample_reassigns(tmp_path):
    """--features with --subsample > 1 must reassign the FULL feature
    set (r5 review: the trajectory-only reassign() crashed on None
    topologies and the run's outputs were lost)."""
    files = _feature_files(tmp_path, 'npy')
    _, assignments, _ = _run_feature_cluster(
        tmp_path, files,
        ['--algorithm', 'kcenters', '--cluster-number', '2',
         '--cluster-distance', 'euclidean', '--subsample', '3'])
    a = ra.load(assignments)
    # reassignment covers EVERY frame, not the subsample
    assert sum(len(np.asarray(a[i])) for i in range(2)) == 50
    flat = np.concatenate([np.asarray(a[i]) for i in range(2)])
    assert len(np.unique(flat)) == 2


def test_kmedoids_warm_start_cli(tmp_path):
    """kmedoids CLI warm start from kcenters outputs via the --init-*
    flags (reference: test_apps_cluster.py:550 test_kmedoids_warm_start):
    one PAM iteration must lower the mean-square cost, and every
    medoid must come from the kcenters cluster it refines."""
    from sklearn.datasets import make_blobs

    from enspara_tpu.cluster import util as cutil
    from enspara_tpu.cluster.kcenters import kcenters
    from enspara_tpu.cluster.kmedoids import _msq

    X, _ = make_blobs(n_samples=100, n_features=3, centers=3,
                      center_box=(0, 100), random_state=3)
    X = X.astype(np.float64)
    lengths = [50, 30, 20]

    result = kcenters(X, 'euclidean', n_clusters=3)

    files = []
    a = ra.RaggedArray(X, lengths=lengths)
    for i in range(len(lengths)):
        fn = str(tmp_path / ('w%d.npy' % i))
        np.save(fn, np.asarray(a[i]))
        files.append(fn)

    init_assig = str(tmp_path / 'init_assignments.h5')
    ra.save(init_assig, result.assignments)
    init_dist = str(tmp_path / 'init_distances.h5')
    ra.save(init_dist, result.distances)
    init_ctrs = str(tmp_path / 'init_center_inds.npy')
    np.save(init_ctrs, np.asarray(result.center_indices))

    distances, assignments, _ = _run_feature_cluster(
        tmp_path, files,
        ['--algorithm', 'kmedoids', '--cluster-number', '3',
         '--cluster-iterations', '1',
         '--cluster-distance', 'euclidean',
         '--init-assignments', init_assig,
         '--init-distances', init_dist,
         '--init-center-inds', init_ctrs])

    a2 = ra.load(assignments)
    assignments2 = np.concatenate(
        [np.asarray(a2[i]) for i in range(len(lengths))])
    dists2 = np.concatenate(
        [np.asarray(r) for r in ra.load(distances)])

    assert _msq(dists2) < _msq(result.distances)

    # after ONE iteration each new medoid still belongs to the
    # kcenters cluster it was proposed from
    ctr_inds2 = cutil.find_cluster_centers(assignments2, dists2)
    np.testing.assert_array_equal(
        result.assignments[ctr_inds2], np.arange(len(ctr_inds2)))


def test_cluster_empty_selection_rejected(tmp_path):
    """A selection matching no atoms is ImproperlyConfigured
    (reference: test_apps_cluster.py:138 test_rmsd_cluster_broken_atoms,
    which uses the out-of-range 'residue -1')."""
    from enspara_tpu.apps import cluster as cluster_app
    from enspara_tpu.exception import ImproperlyConfigured

    # module-level pytestmark already skips when REF_DATA is absent
    with pytest.raises(ImproperlyConfigured):
        cluster_app.main([
            'cluster',
            '--trajectories', os.path.join(REF_DATA, 'frame0.xtc'),
            '--topology', os.path.join(REF_DATA, 'native.pdb'),
            '--cluster-radius', '0.1',
            '--atoms', 'residue -1',
            '--algorithm', 'khybrid',
            '--distances', str(tmp_path / 'd.h5'),
            '--assignments', str(tmp_path / 'a.h5'),
            '--center-features', str(tmp_path / 'c.pkl')])
