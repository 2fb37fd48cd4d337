#!/usr/bin/env python
"""Time the north-star pipeline on one GPU.

BASELINE.md's north star: k-centers RMSD clustering of 1M frames x 64
atoms to 1000 states, then lag-10 transition counts, the transpose
builder and the top-20 implied timescales. Frames are synthesized on
the device (a drifting random structure with noise), so the timings
cover the clustering loop and the MSM tail, not the host ingest.

    python bench.py

Fails unless JAX's default backend is the GPU. Each section is timed
three times after a compiling warm-up; the minimum is reported beside
all three times. The last line of standard output is one JSON object
with the times, the device (platform, device_kind, count) and the
card's name and power limit from ``nvidia-smi``.
"""

import json
import shutil
import subprocess
import sys
import time

import numpy as np

LAG = 10
N_FRAMES = 1_000_000
N_ATOMS = 64
N_CLUSTERS = 1000
N_EIGS = 21
N_RUNS = 3


def _card():
    exe = shutil.which('nvidia-smi')
    if exe is None:
        return None
    return subprocess.run(
        [exe, '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()


def _times(fn):
    fn()                                   # compile + warm
    out = []
    for _ in range(N_RUNS):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def main():
    import jax
    import jax.numpy as jnp

    if jax.default_backend() != 'gpu':
        print('bench.py measures the GPU; the default backend is %r'
              % jax.default_backend(), file=sys.stderr)
        return 1

    from enspara_tpu.cluster.engine import (kcenters_device_fused,
                                            prepare_rmsd_frames)
    from enspara_tpu.msm.eigen_device import transpose_timescales_device
    from enspara_tpu.msm.transition_matrices import \
        assigns_to_counts_device
    from enspara_tpu.util.compile_cache import enable_compilation_cache

    enable_compilation_cache()

    @jax.jit
    def synth(key):
        kb, kd, kn = jax.random.split(key, 3)
        base = jax.random.normal(kb, (N_ATOMS, 3), jnp.float32)
        drift = jax.random.normal(kd, (N_FRAMES, 1, 1), jnp.float32)
        noise = jax.random.normal(kn, (N_FRAMES, N_ATOMS, 3),
                                  jnp.float32)
        return base[None] + 0.3 * drift * base[None] + 0.1 * noise

    prep = prepare_rmsd_frames(synth(jax.random.PRNGKey(42)))
    box = {}

    def cluster():
        box['res'] = kcenters_device_fused(prep, n_clusters=N_CLUSTERS)

    cluster_s = _times(cluster)
    res = box['res']
    assert res.n_found == N_CLUSTERS

    assigns = np.asarray(res.assignments).reshape(100, -1)
    mask = np.ones_like(assigns, dtype=bool)

    def counts():
        box['counts'] = assigns_to_counts_device(assigns, mask, LAG,
                                                 N_CLUSTERS)
        box['counts'].block_until_ready()

    counts_s = _times(counts)

    def eig():
        box['vals'] = transpose_timescales_device(
            box['counts'], n_eigs=N_EIGS, lag_time=LAG)[1]

    eig_s = _times(eig)
    assert box['vals'].shape == (N_EIGS,)

    d0 = jax.devices()[0]
    total = min(cluster_s) + min(counts_s) + min(eig_s)
    print(json.dumps({
        'kcenters_s': min(cluster_s),
        'kcenters_pairs_per_sec': N_FRAMES * N_CLUSTERS / min(cluster_s),
        'counts_s': min(counts_s),
        'eigsolve_top20_s': min(eig_s),
        'northstar_s': total,
        'runs_s': {'kcenters': cluster_s, 'counts': counts_s,
                   'eigsolve': eig_s},
        'shape': {'frames': N_FRAMES, 'atoms': N_ATOMS,
                  'centers': N_CLUSTERS, 'lag': LAG},
        'card': _card(),
        'device': {'platform': d0.platform, 'kind': d0.device_kind,
                   'count': len(jax.devices())},
    }))
    return 0


if __name__ == '__main__':
    sys.exit(main())
