#!/usr/bin/env python
"""Large-state MSM/TPT scale points (BASELINE config 5's regime).

Records the 100k-state (and optionally 1M-state) evidence for the
"MSMs at scale" claim: forward committors across a sparse metastable
transition matrix and the top-20 implied-timescale eigsolve with
per-mode residual certificates, each timed and checked against host
oracles where feasible.

Workload: ``synthetic_data.sparse_metastable_counts`` — block-
metastable sparse counts whose spectrum has the shape of real MSMs
(slow modes separated from a fast bulk). Reference analogs:
committors via scipy spsolve (enspara/tpt/core.py:96) and ARPACK
eigs (enspara/msm/transition_matrices.py:214-221).

Writes benchmarks/scale-points-result.json and prints it.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import scipy.sparse

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def one_point(n_states, n_blocks, with_device_eig=False):
    from enspara_tpu.msm import builders
    from enspara_tpu.msm.eigen_device import eigenspectrum_reversible
    from enspara_tpu.msm.synthetic_data import sparse_metastable_counts
    from enspara_tpu.tpt import committors, mfpts

    out = {'n_states': n_states, 'n_blocks': n_blocks}

    C = sparse_metastable_counts(n_states, n_blocks=n_blocks, seed=11)
    t0 = time.perf_counter()
    _, T, pi = builders.transpose(C)
    out['builder_s'] = round(time.perf_counter() - t0, 3)
    T = scipy.sparse.csr_matrix(T)
    pi = np.asarray(pi)
    n = T.shape[0]

    # --- committors: first well -> last well (10 source/sink states
    # each, the realistic folding-reaction query shape). pi known from
    # the builder -> pi-symmetrized CG path; a second call without pi
    # exercises (and times) the stationary-distribution estimate (the
    # O(nnz) detailed-balance tree walk for these reversible chains;
    # ARPACK only for non-reversible input).
    m = n // n_blocks
    sources = np.arange(10)
    sinks = np.arange(n - 10, n)
    t0 = time.perf_counter()
    q = committors(T, sources, sinks, pi=pi)
    out['committors_s'] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    q_nopi = committors(T, sources, sinks)
    out['committors_estimated_pi_s'] = round(
        time.perf_counter() - t0, 3)
    # both solutions carry their own exact-system residual
    # certificate (checked below for q); their mutual distance is
    # only bounded by cond(I-Q) * residual — with timescales ~1e8
    # that condition number is ~1e9, so record the gap rather
    # than asserting solver-precision agreement
    out['committor_pi_vs_estimated_max_diff'] = float(
        np.abs(q - q_nopi).max())
    assert out['committor_pi_vs_estimated_max_diff'] < 1e-4

    t0 = time.perf_counter()
    mf = mfpts(T, sinks=sinks, populations=pi)
    out['mfpts_s'] = round(time.perf_counter() - t0, 3)
    assert mf.shape == (n,) and np.all(mf >= 0) \
        and np.all(mf[sinks] == 0)
    assert q.shape == (n,)
    assert np.all((q >= -1e-9) & (q <= 1 + 1e-9))
    assert abs(q[sources].max()) < 1e-9 and abs(q[sinks].min() - 1) < 1e-9
    # committors must ramp monotonically well-to-well in a chain of
    # wells (physical sanity, not just solver convergence)
    well_means = np.array([q[b * m:(b + 1) * m].mean()
                           for b in range(n_blocks)])
    assert np.all(np.diff(well_means) > -1e-9)
    out['committor_residual'] = float(_committor_residual(
        T, q, np.concatenate([sources, sinks])))

    # --- top-20 implied-timescale eigsolve with residual certificates
    # (auto dispatch -> host ARPACK Lanczos at this scale; 'lobpcg'
    # records the device path when requested)
    k = 21
    t0 = time.perf_counter()
    vals, vecs, info = eigenspectrum_reversible(
        T, pi=pi, n_eigs=k, method='auto', return_info=True)
    cold_s = round(time.perf_counter() - t0, 3)
    # jit-compiled engines (the filtered device solver) pay a
    # once-per-process compile on the first call; record that cold
    # time separately and time the steady state the production loop
    # (implied_timescales over many lags) actually runs at
    if info['method'] in ('filtered',):
        out['eigsolve_top20_cold_s'] = cold_s
        t0 = time.perf_counter()
        vals, vecs, info = eigenspectrum_reversible(
            T, pi=pi, n_eigs=k, method='auto', return_info=True)
        out['eigsolve_top20_s'] = round(time.perf_counter() - t0, 3)
    else:
        out['eigsolve_top20_s'] = cold_s
    out['eigsolve_method'] = info['method']
    out['eigsolve_max_residual'] = float(np.max(info['residuals']))
    out['top5_timescales_lag1'] = [
        round(float(t), 2) for t in -1.0 / np.log(vals[1:6])]
    assert out['eigsolve_max_residual'] < 1e-9

    if with_device_eig:
        t0 = time.perf_counter()
        vals_d, _, info_d = eigenspectrum_reversible(
            T, pi=pi, n_eigs=k, method='lobpcg', return_info=True)
        out['eigsolve_device_lobpcg_s'] = round(
            time.perf_counter() - t0, 3)
        out['eigsolve_device_fallback'] = bool(info_d['fallback'])
        out['eigsolve_device_refine_sweeps'] = int(
            info_d['refine_sweeps'])
        out['eigsolve_device_max_residual'] = float(
            np.max(info_d['residuals']))
        out['eigsolve_device_vs_auto_max_abs_diff'] = float(
            np.max(np.abs(vals - vals_d)))
        assert out['eigsolve_device_vs_auto_max_abs_diff'] < 1e-9

    return out


def _committor_residual(T, q, absorbing):
    """max |(Tq - q)_i| over non-absorbing states: the defining
    harmonic property of committors, checked against the ORIGINAL
    matrix (not the solver's modified system)."""
    r = np.asarray(T @ q - q).ravel()
    mask = np.ones(T.shape[0], dtype=bool)
    mask[absorbing] = False
    return np.abs(r[mask]).max()


def main():
    from enspara_tpu.util.compile_cache import enable_compilation_cache
    enable_compilation_cache()

    ap = argparse.ArgumentParser()
    ap.add_argument('--million', action='store_true',
                    help='also record the 1M-state point (minutes)')
    ap.add_argument('--device-eig', action='store_true',
                    help='also record the device LOBPCG eigsolve '
                         '(minutes at 100k states)')
    args = ap.parse_args()

    import jax

    points = [one_point(100_000, 25, with_device_eig=args.device_eig)]
    if args.million:
        points.append(one_point(1_000_000, 50))

    # PER-BACKEND output files: a CPU re-run never overwrites a device
    # record. Within one backend, partial re-runs merge by n_states and
    # overwrite only re-recorded keys.
    backend = jax.default_backend()
    out_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        'scale-points-%s-result.json' % backend)
    merged = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            for p in json.load(f).get('points', []):
                merged[p['n_states']] = p
    for p in points:
        merged.setdefault(p['n_states'], {}).update(p)
    result = {
        'backend': backend,
        'device': str(jax.devices()[0]),
        'n_devices': len(jax.devices()),
        'jax_version': jax.__version__,
        'timestamp_source': 'end-of-run wall clock, written by '
                            'benchmarks/scale_points.py',
        'points': [merged[k] for k in sorted(merged)],
    }
    with open(out_path, 'w') as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == '__main__':
    main()
