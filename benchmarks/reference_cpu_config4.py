#!/usr/bin/env python
"""BASELINE config 4 measured on the REFERENCE implementation.

The reference's TPT stack (committors via spsolve, dense-masked net
fluxes, dense Dijkstra pathways — reference tpt/core.py:40,
tpt/tpt.py:94, tpt/path.py:46/197) is pure single-threaded
numpy/scipy, so timing it on one CPU core is representative of the
reference's real per-core performance — unlike its OpenMP/MPI
clustering paths, which cannot be built here (no Cython/mdtraj).

Stages run one per process invocation so a wall-clock cap can be
enforced from the shell with ``timeout``:

    python reference_cpu_config4.py committors
    python reference_cpu_config4.py netflux
    python reference_cpu_config4.py top_path      # first path only
    python reference_cpu_config4.py paths         # full top-10

Each stage prints one JSON line and merges it into
``reference-cpu-config4-result.json``. Stage inputs that the reference
would itself compute upstream (the net-flux matrix for the path
stages) are produced by our implementation, which is fuzz-tested
exactly equal (tests/test_tpt_fuzz_vs_reference.py), so a stage
timeout upstream does not block measuring the stages below it.
"""

import json
import os
import sys
import time
from os.path import dirname, join

import numpy as np
import scipy.sparse

# the baseline must never touch the accelerator (and our helper stages
# should not compete for it): everything here runs on the host backend,
# pinned through jax.config as well in case jax was imported first.
os.environ['JAX_PLATFORMS'] = 'cpu'
try:
    import jax
    jax.config.update('jax_platforms', 'cpu')
except ImportError:
    pass

sys.path.insert(0, dirname(dirname(__file__)))          # repo root
sys.path.insert(0, join(dirname(dirname(__file__)), 'tests'))

OUT = join(dirname(__file__), 'reference-cpu-config4-result.json')


def _msm_10k():
    """The exact MSM of reference_configs.config4_tpt_10k."""
    n = 10_000
    rng = np.random.RandomState(3)
    rows = np.concatenate([np.arange(n), np.arange(n), np.arange(n)])
    cols = np.concatenate([(np.arange(n) + 1) % n,
                           (np.arange(n) - 1) % n,
                           rng.randint(0, n, n)])
    vals = np.concatenate([np.full(n, 0.45), np.full(n, 0.45),
                           np.full(n, 0.10)])
    C = scipy.sparse.coo_matrix((vals, (rows, cols)), (n, n)).tocsr()
    C = C + scipy.sparse.eye(n) * 0.05
    T = scipy.sparse.diags(1.0 / np.asarray(C.sum(axis=1)).ravel()) @ C
    return T.tocsr(), [0], [n // 2]


def _our_net_flux(T, sources, sinks):
    from enspara_tpu.tpt import net_fluxes
    return net_fluxes(T, sources, sinks).tocsr()


def stage_committors():
    from _reference_oracle import load_reference
    ref = load_reference()
    import enspara.tpt  # noqa: F401

    T, sources, sinks = _msm_10k()
    t0 = time.perf_counter()
    q = ref.tpt.committors(T, sources, sinks)
    dt = time.perf_counter() - t0
    assert q[sinks[0]] == 1.0 and q[sources[0]] == 0.0
    return {'ref_committors_s': round(dt, 2)}


def stage_netflux():
    """The reference's sparse net-flux path crashes under scipy>=1.8
    (``np.where(sparse < 0)``, reference tpt/tpt.py:124 — its own tests
    only cover dense input), so the measurable baseline is the dense
    path. Its internal eq-probs eigensolve would densify to a 10k
    dense eig, so populations are precomputed with the reference's own
    sparse eq_probs and timed separately."""
    from _reference_oracle import load_reference
    ref = load_reference()
    import enspara.tpt  # noqa: F401
    from enspara.msm.transition_matrices import eq_probs

    T, sources, sinks = _msm_10k()

    t0 = time.perf_counter()
    pops = eq_probs(T)
    dt_pops = time.perf_counter() - t0

    Td = T.toarray()
    t0 = time.perf_counter()
    nf = ref.tpt.net_fluxes(Td, sources, sinks, populations=pops)
    dt = time.perf_counter() - t0
    assert nf.shape == T.shape
    return {'ref_eq_probs_s': round(dt_pops, 2),
            'ref_net_fluxes_dense_given_pops_s': round(dt, 2),
            'ref_net_fluxes_sparse': 'crashes (tpt/tpt.py:124, '
                                     'np.where on sparse comparison)'}


def stage_top_path():
    from _reference_oracle import load_reference
    ref = load_reference()
    import enspara.tpt  # noqa: F401

    T, sources, sinks = _msm_10k()
    nf = _our_net_flux(T, sources, sinks).toarray()
    t0 = time.perf_counter()
    path, flux = ref.tpt.top_path(sources, sinks, nf)
    dt = time.perf_counter() - t0
    return {'ref_top_path_s': round(dt, 2),
            'ref_top_path_flux': float(flux),
            'ref_top_path_len': int(len(path))}


def stage_paths():
    from _reference_oracle import load_reference
    ref = load_reference()
    import enspara.tpt  # noqa: F401

    T, sources, sinks = _msm_10k()
    nf = _our_net_flux(T, sources, sinks).toarray()
    t0 = time.perf_counter()
    pth, fluxes = ref.tpt.paths(sources, sinks, nf,
                                remove_path='subtract', num_paths=10)
    dt = time.perf_counter() - t0
    return {'ref_top10_paths_s': round(dt, 2),
            'ref_n_paths': int(len(pth))}


STAGES = {'committors': stage_committors, 'netflux': stage_netflux,
          'top_path': stage_top_path, 'paths': stage_paths}


def main():
    stage = sys.argv[1]
    res = STAGES[stage]()
    try:
        with open(OUT) as f:
            merged = json.load(f)
    except (OSError, ValueError):
        merged = {}
    merged.update(res)
    with open(OUT, 'w') as f:
        json.dump(merged, f, indent=1)
    print(json.dumps(res), flush=True)


if __name__ == '__main__':
    main()
