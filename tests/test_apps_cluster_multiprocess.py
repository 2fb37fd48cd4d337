"""Full-app multi-process equivalence: the `cluster` CLI under TWO
``jax.distributed`` processes (gloo collectives, 2 virtual CPU devices
each => a 4-device global frame mesh) on the bundled trajectories must
reproduce the single-process run exactly — center indices and
assignments byte-equal, distances to fp tolerance.

This is the analog of the reference's key MPI oracle
(enspara/test/test_apps_cluster_mpi.py:128-139, run under
``mpirun -n 2``): there the ranks stripe the data and byte-equality
follows from identical serial distance code; here the SPMD program is
genuinely different (global-mesh shard_map/GSPMD over 4 devices), so
the assertions pin collective correctness end-to-end through the CLI —
loading, clustering, rank-0 writes, final barrier.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DATA = '/root/reference/enspara/test/data'

pytestmark = pytest.mark.skipif(not os.path.isdir(REF_DATA),
                                reason='reference data not present')

WORKER = r'''
import sys
pid, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]

import jax
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_num_cpu_devices', 2)
jax.config.update('jax_cpu_collectives_implementation', 'gloo')

import os
os.environ['ENSPARA_TPU_COORDINATOR'] = 'localhost:' + port
os.environ['ENSPARA_TPU_NUM_PROCESSES'] = '2'
os.environ['ENSPARA_TPU_PROCESS_ID'] = str(pid)
os.environ['ENSPARA_TPU_PLATFORM'] = 'cpu'

REF_DATA = %r
xtc = os.path.join(REF_DATA, 'frame0.xtc')
top = os.path.join(REF_DATA, 'native.pdb')

from enspara_tpu.apps import cluster as cluster_app
rc = cluster_app.main([
    'cluster',
    '--trajectories', xtc,
    '--topology', top,
    '--algorithm', 'kcenters',
    '--cluster-number', '5',
    '--atoms', 'name CA or name C or name N',
    '--distances', os.path.join(outdir, 'distances.h5'),
    '--assignments', os.path.join(outdir, 'assignments.h5'),
    '--center-features', os.path.join(outdir, 'centers.pkl'),
    '--center-indices', os.path.join(outdir, 'center-inds.npy'),
])
assert rc == 0, rc
assert jax.process_count() == 2
print('WORKER %%d ALL_OK' %% pid, flush=True)
''' % (REF_DATA,)


def _free_port():
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_single_process(tmp_path):
    """Single-process oracle via the library CLI in THIS process."""
    from enspara_tpu.apps import cluster as cluster_app

    outdir = tmp_path / 'single'
    outdir.mkdir()
    rc = cluster_app.main([
        'cluster',
        '--trajectories', os.path.join(REF_DATA, 'frame0.xtc'),
        '--topology', os.path.join(REF_DATA, 'native.pdb'),
        '--algorithm', 'kcenters',
        '--cluster-number', '5',
        '--atoms', 'name CA or name C or name N',
        '--distances', str(outdir / 'distances.h5'),
        '--assignments', str(outdir / 'assignments.h5'),
        '--center-features', str(outdir / 'centers.pkl'),
        '--center-indices', str(outdir / 'center-inds.npy'),
    ])
    assert rc == 0
    return outdir


def test_cluster_cli_two_process_equals_single(tmp_path):
    from enspara_tpu import ra

    mp_out = tmp_path / 'multi'
    mp_out.mkdir()
    worker = tmp_path / 'worker.py'
    worker.write_text(WORKER)
    port = str(_free_port())

    env = dict(os.environ)
    env['PYTHONPATH'] = REPO_ROOT + os.pathsep + env.get('PYTHONPATH',
                                                         '')
    env.pop('XLA_FLAGS', None)  # workers pin devices via jax.config
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), port, str(mp_out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for pid in range(2)]
    outs = []
    for pid, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail('worker %d timed out' % pid)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, 'worker %d failed:\n%s' % (pid, out)
        assert ('WORKER %d ALL_OK' % pid) in out, out

    single = _run_single_process(tmp_path)

    # rank-0-only writes: every output exists exactly once
    for fn in ('distances.h5', 'assignments.h5', 'centers.pkl',
               'center-inds.npy'):
        assert (mp_out / fn).exists(), fn

    ci_mp = np.load(mp_out / 'center-inds.npy')
    ci_1p = np.load(single / 'center-inds.npy')
    np.testing.assert_array_equal(ci_mp, ci_1p)

    a_mp = np.asarray(ra.load(str(mp_out / 'assignments.h5')))
    a_1p = np.asarray(ra.load(str(single / 'assignments.h5')))
    np.testing.assert_array_equal(a_mp, a_1p)

    d_mp = np.asarray(ra.load(str(mp_out / 'distances.h5')))
    d_1p = np.asarray(ra.load(str(single / 'distances.h5')))
    np.testing.assert_allclose(d_mp, d_1p, atol=1e-5)
