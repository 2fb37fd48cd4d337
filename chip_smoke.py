"""Drive the cluster -> MSM main path once on one GPU and check it.

    python chip_smoke.py                 # one GPU, full width
    python chip_smoke.py --four-cards    # the sharded path on 4 GPUs
    JAX_PLATFORMS=cpu python chip_smoke.py --tiny   # CPU rehearsal

Phases (each prints its own lines; any failure exits non-zero):

1. device: JAX's devices and memory limit, the card's name and power
   limit from ``nvidia-smi`` (read by a child process that does not
   import JAX). Fails unless the default backend is the GPU.
2. compile at real widths (1,000,000 frames x 64 atoms x 1000 centers):
   the k-centers loop, the assignment step and the PAM sweep, with
   ``memory_analysis()`` and the compile time of each.
3. the k-centers iteration kernel against the plain ``jax.numpy``
   reference (``ops/qcp.py``) and the float64 Kabsch oracle, fp32 and
   bf16.
4. the library main path on host frames made from ``--seed``:
   ``cluster.kcenters`` -> ``assign_device`` -> lag-10 counts ->
   ``MSM(method=builders.transpose)`` -> top-20 implied timescales,
   each checked against a plain or host fp64 reference; and k-hybrid
   (k-centers + device PAM sweeps) on a slice of the frames.

The CLI apps are not driven here: they write their results as HDF5,
and the machine with the card has no ``h5py``. The CPU tests drive
them (tests/test_apps.py).

With ``--four-cards`` only phase 1 and the sharded path run: k-centers,
assignment and transition counts on a 4-device mesh against a 1-device
mesh on the first card; the centers must be identical.

The last line of standard output is a JSON object
``{"ok": true, "device": {...}}``; it is printed only when every phase
passed on a GPU. ``--tiny`` rehearses every phase at a small size on
any backend; phase 1 then reports the missing GPU and the script exits
non-zero after the other phases.
"""

import argparse
import json
import shutil
import subprocess
import sys
import time

import numpy as np

# Tolerances (Angstrom). Three of them were set after runs on the card
# had failed a tighter limit; each notes the reading it was set from
# (one H100 80GB HBM3, 1M x 64 frames from seed 0).
#
# fp32 against the plain reference: the two sum the inner products in
# another order, and the fp32 root of QCP's characteristic quartic
# amplifies that difference. The rtol was 1e-5 until a run read a
# largest difference of 6.48e-4 A (about 1.2e-4 relative, at ~5.5 A);
# at 2e-4 that reading is 0.54 of the tolerance. Each of the two stays
# within 3e-4 A of float64.
RTOL_FP32, ATOL_FP32 = 2e-4, 1e-4
# The float64 oracle: the fp32 QCP floor near zero distance.
ATOL_ORACLE = 5e-3
# The kernel is a little less accurate than the plain reference against
# float64 (readings: 2.70e-4 A against 1.73e-4 A and 2.18e-4 A), so it
# is held to a bound, not to parity: its error at most ORACLE_SLACK
# times the plain reference's plus ATOL_FP32. The readings sit at 0.75
# and 0.63 of that bound.
ORACLE_SLACK = 1.5
# bf16 frames: storage rounds each centered coordinate to 2^-8
# relative, so an RMSD moves by at most 2^-8 (sqrt(Ga / n) +
# sqrt(Gb / n)), the two structures' RMS extents. That is ~4e-3 of the
# distance between far structures but much more of a small one: an
# rtol of 1e-2 failed at 0.174 relative on near pairs, while the
# absolute bound reads 0.13-0.15 of itself.
BF16_UNIT = 2.0 ** -8
# Self distances are held to self_floor(), not to the oracle, and left
# out of the oracle samples. SELF_ULPS was raised to 64 after a run
# read a self distance of 0.0191 A, 1.2 times the floor then in force
# (0.0159 A at that center).
SELF_ULPS = 64
ATOL_EIG, RTOL_TIMESCALES = 1e-4, 1e-3
N_ORACLE_PAIRS = 4096
LAG = 10
N_TIMESCALES = 20

FULL = dict(n=1_000_000, atoms=64, k=1000, n_traj=100, n_basins=64,
            hybrid_frames=50_000, hybrid_k=100)
TINY = dict(n=6000, atoms=10, k=48, n_traj=6, n_basins=32,
            hybrid_frames=1000, hybrid_k=12)


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def say(*args):
    print(*args, flush=True)


def phase(name):
    say('\n== %s' % name)


# ---------------------------------------------------------------------
# data: frames of a sticky Markov chain over basins of chain molecules
# ---------------------------------------------------------------------

def make_frames(n, atoms, n_traj, n_basins, seed):
    """``(n, atoms, 3)`` float32 frames and their basin labels. Each
    basin is a random chain (3.8 A steps); frames are a basin template
    plus 0.5 A noise; each of ``n_traj`` equal trajectories hops to a
    random basin with probability 0.02 per frame."""
    rng = np.random.default_rng(seed)
    steps = rng.standard_normal((n_basins, atoms, 3))
    steps *= 3.8 / np.linalg.norm(steps, axis=-1, keepdims=True)
    templates = np.cumsum(steps, axis=1).astype(np.float32)
    jump = rng.random(n) < 0.02
    jump[::n // n_traj] = True                      # trajectory starts
    target = rng.integers(n_basins, size=n)
    last = np.maximum.accumulate(np.where(jump, np.arange(n), 0))
    basin = target[last]
    xyz = rng.standard_normal((n, atoms, 3), dtype=np.float32)
    xyz *= np.float32(0.5)
    xyz += templates[basin]
    return xyz, basin


def centered(x):
    return x - x.mean(axis=-2, keepdims=True)


def self_floor(g, n_atoms):
    """fp32 bound on a QCP self distance. A structure's distance to
    itself is 0 up to the cancellation in ga + gb - 2 lambda, whose
    size grows with the structure's extent. For identical structures
    the quartic's root is u = 1 (lambda = G); its fp32 coefficients are
    sums of a dozen O(1) products, so Newton settles within
    SELF_ULPS ulp of 1, and msd = 2 G (1 - u) / n_atoms."""
    return np.sqrt(2 * g * SELF_ULPS * np.finfo(np.float32).eps / n_atoms)


# ---------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------

def nvidia_smi():
    exe = shutil.which('nvidia-smi')
    if exe is None:
        return None
    out = subprocess.run(
        [exe, '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def phase_device(tiny):
    phase('phase 1: device')
    import jax

    devs = jax.devices()
    say('jax', jax.__version__, 'devices:', devs)
    d0 = devs[0]
    stats = d0.memory_stats() or {}
    say('device_kind:', d0.device_kind, ' count:', len(devs),
        ' bytes_limit:', stats.get('bytes_limit'))
    card = nvidia_smi()
    say('card (name, power.limit):', card)
    backend = jax.default_backend()
    if backend != 'gpu':
        msg = 'default backend is %r, not the GPU' % backend
        if not tiny:
            raise PhaseFailed(msg)
        say('FAIL (rehearsal continues):', msg)
        return card, False
    check(card, 'nvidia-smi found no card')
    return card, True


# ---------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------

def _compile(label, jitted, *args, **kwargs):
    t0 = time.perf_counter()
    compiled = jitted.lower(*args, **kwargs).compile()
    dt = time.perf_counter() - t0
    say('%s: compile %.3f s' % (label, dt))
    say('  memory_analysis:', compiled.memory_analysis())
    return compiled


def phase_compile(cfg, mesh):
    phase('phase 2: compile at %d frames x %d atoms x %d centers'
          % (cfg['n'], cfg['atoms'], cfg['k']))
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from enspara_tpu.cluster import engine, engine_kmedoids
    from enspara_tpu.ops.kcenters_triton import BLOCK
    from enspara_tpu.parallel.mesh import FRAME_AXIS, P

    n, A, k = cfg['n'], cfg['atoms'], cfg['k']
    n_pad = -(-n // BLOCK) * BLOCK
    row = NamedSharding(mesh, P(FRAME_AXIS))
    sds = jax.ShapeDtypeStruct
    frames = sds((3 * A, n_pad), jnp.float32,
                 sharding=NamedSharding(mesh, P(None, FRAME_AXIS)))
    f32_row = sds((n_pad,), jnp.float32, sharding=row)
    i32_row = sds((n_pad,), jnp.int32, sharding=row)
    i32 = np.int32(0)
    _compile('k-centers loop', engine._kcenters_loop_prepared,
             frames, f32_row, f32_row, i32_row, i32, np.int32(k),
             np.float32(0), k_max=k, n_atoms=A, mesh=mesh,
             iteration=engine._iteration_for(mesh))

    data = sds((n, A, 3), jnp.float32)
    block = engine._assign_block(n, k, mesh)
    say('assignment center block:', block)
    _compile('assignment', engine._assign_all, data,
             sds((k, A, 3), jnp.float32), 'rmsd', k_real=k, block=block)

    bucket = int(min(n, max(64, 8 * (-(-n // k)))))
    _compile('PAM sweep', engine_kmedoids._pam_sweeps, data,
             sds((n,), jnp.bool_), sds((n,), jnp.float32),
             sds((n,), jnp.int32), sds((k,), jnp.int32),
             jax.random.PRNGKey(0), metric='rmsd', n_sweeps=1,
             bucket=bucket, batch=64)


# ---------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------

def _iteration_vs_reference(prep, center, iteration):
    """One kernel iteration from a cold state, and the plain QCP vector
    reference on the kernel's own inputs (the prepared coordinates and
    G values); returns both distance vectors."""
    import jax.numpy as jnp

    from enspara_tpu.ops import qcp

    n, A = prep.n, prep.n_atoms
    n_pad = prep.frames.shape[1]
    dist = jnp.full((n_pad,), jnp.inf, jnp.float32).at[n:].set(-jnp.inf)
    assig = jnp.full((n_pad,), -1, jnp.int32)
    col = prep.frames[:, center].astype(jnp.float32)
    d, a, bmax, barg = iteration(prep.frames, prep.g, dist, assig, col,
                                 prep.g[center], np.int32(7), n_atoms=A)
    d = np.asarray(d)
    check(np.all(np.asarray(a)[:n] == 7), 'kernel left frames unclaimed')
    check(np.all(np.isinf(d[n:])), 'kernel touched padding frames')
    top = int(np.asarray(barg)[np.argmax(np.asarray(bmax))])
    check(top == int(np.argmax(d)),
          'block argmax %d != argmax %d' % (top, int(np.argmax(d))))
    x = prep.frames.astype(jnp.float32).reshape(3, A, n_pad).T[:n]
    ref = np.asarray(qcp.qcp_rmsd_vector(x, x[center], prep.g[:n],
                                         prep.g[center]))
    return d[:n], ref


def _oracle(xc_host, pairs, got):
    from enspara_tpu.ops.qcp import kabsch_rmsd_np

    want = np.array([kabsch_rmsd_np(xc_host[i], xc_host[j])
                     for i, j in pairs])
    err = np.abs(got - want)
    return float(err.max()), want


def phase_kernels(cfg, xyz, mesh, seed):
    phase('phase 3: kernel vs plain reference at %d x %d'
          % (cfg['n'], cfg['atoms']))
    from enspara_tpu.cluster import engine

    iteration = engine._iteration_for(mesh)
    say('iteration:', getattr(iteration, '__name__', iteration))
    n = len(xyz)
    rng = np.random.default_rng(seed + 1)
    centers = rng.choice(n, 4, replace=False)
    per = N_ORACLE_PAIRS // len(centers)
    xc = centered(xyz.astype(np.float64))
    g = np.sum(xc * xc, axis=(1, 2))
    prep32 = engine.prepare_rmsd_frames(xyz, mesh=mesh)
    prep16 = engine.prepare_rmsd_frames(xyz, mesh=mesh, precision='bf16')
    pairs, got, plain = [], [], []
    for c in centers:
        d32, ref = _iteration_vs_reference(prep32, int(c), iteration)
        # a structure's distance to itself sits at the fp32 floor
        others = np.arange(n) != c
        err = np.abs(d32 - ref)
        bound = ATOL_FP32 + RTOL_FP32 * np.abs(ref)
        ratio = np.where(others, err / bound, 0.0)
        if ratio.max() > 1:
            from enspara_tpu.ops.qcp import kabsch_rmsd_np
            for f in np.argsort(ratio)[::-1][:5]:
                say('  frame %d: kernel %.7f plain %.7f float64 %.7f'
                    % (f, d32[f], ref[f], kabsch_rmsd_np(xc[f], xc[c])))
        check(ratio.max() <= 1,
              'fp32 kernel vs plain: max |err| %.3g A (%.3f of the '
              'tolerance) at center %d' % (err[others].max(),
                                           ratio.max(), c))
        floor = self_floor(g[c], cfg['atoms'])
        check(d32[c] <= floor, 'self distance %.3g above the fp32 '
              'floor %.3g' % (d32[c], floor))
        d16, _ = _iteration_vs_reference(prep16, int(c), iteration)
        extent = np.sqrt(g / cfg['atoms'])
        bound16 = (BF16_UNIT * (extent + extent[c]) + ATOL_FP32
                   + RTOL_FP32 * d32)
        err16 = np.abs(d16 - d32)
        check(np.all(err16 <= bound16),
              'bf16 vs fp32: %.3g A (%.3f of the rounding bound)'
              % (err16.max(), (err16 / bound16).max()))
        check(d16[c] <= floor, 'bf16 self distance %.3g above the fp32 '
              'floor %.3g: G and the stored frames disagree'
              % (d16[c], floor))
        far = d32 > 5.0
        rel = (err16[far] / d32[far]).max() if far.any() else 0.0
        say('center %d: fp32 max|err| %.3g A (%.3f of tolerance), '
            'self %.3g A (floor %.3g A); bf16 max|err| %.3g A (%.3f of '
            'bound), %.3g relative beyond 5 A'
            % (c, err[others].max(), ratio.max(), d32[c], floor,
               err16.max(), (err16 / bound16).max(), rel))
        sample = rng.choice(np.flatnonzero(others), per, replace=False)
        pairs += [(int(i), int(c)) for i in sample]
        got.append(d32[sample])
        plain.append(ref[sample])
    err, want = _oracle(xc, pairs, np.concatenate(got))
    err_plain = float(np.abs(np.concatenate(plain) - want).max())
    bound = ORACLE_SLACK * err_plain + ATOL_FP32
    say('float64 Kabsch oracle on %d pairs: kernel max |err| %.3g A, '
        'plain reference %.3g A (kernel %.2fx the plain error, %.3f of '
        'the bound %g x plain + %g A)'
        % (len(pairs), err, err_plain, err / err_plain, err / bound,
           ORACLE_SLACK, ATOL_FP32))
    check(err <= ATOL_ORACLE, 'kernel vs float64 oracle %.3g' % err)
    check(err <= bound, 'kernel float64 error %.3g A beyond %g x the '
          'plain reference\'s %.3g A + %g A'
          % (err, ORACLE_SLACK, err_plain, ATOL_FP32))
    return xc.astype(np.float32)


# ---------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------

def _timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


def _plain_kcenters(prep, k, mesh):
    """The same loop with the plain jax.numpy iteration."""
    from enspara_tpu.cluster import engine
    from enspara_tpu.parallel.mesh import FRAME_AXIS, NamedSharding, P

    dist, assig = engine._init_state(prep.n, prep.frames.shape[1],
                                     None, None)
    import jax
    sh = NamedSharding(mesh, P(FRAME_AXIS))
    out = engine._kcenters_loop_prepared(
        prep.frames, prep.g, jax.device_put(dist, sh),
        jax.device_put(assig, sh), np.int32(0), np.int32(k),
        np.float32(0), k_max=k, n_atoms=prep.n_atoms, mesh=mesh,
        iteration=engine._iteration_xla)
    return engine._result(*out, prep.n, 0, None)


def _within(a, b):
    return abs(a - b) <= ATOL_FP32 + RTOL_FP32 * max(abs(a), abs(b))


def _check_centers(ctr_a, ctr_b, prep, mesh, label):
    """Equal center sequences, or a first divergence that is a near-tie
    of the two picks under the plain loop's state at that point."""
    ctr_a, ctr_b = np.asarray(ctr_a), np.asarray(ctr_b)
    check(len(ctr_a) == len(ctr_b), '%s: center counts differ' % label)
    diff = np.flatnonzero(ctr_a != ctr_b)
    if not len(diff):
        say('%s: all %d centers identical' % (label, len(ctr_a)))
        return True
    j = int(diff[0])
    state = _plain_kcenters(prep, j, mesh).distances
    da, db = state[ctr_a[j]], state[ctr_b[j]]
    say('%s: first divergence at center %d: frames %d vs %d, '
        'distances %.7f vs %.7f A' % (label, j, ctr_a[j], ctr_b[j],
                                      da, db))
    check(_within(da, db), '%s: divergence is not a near-tie' % label)
    return False


def _check_assignments(xc, a_got, d_got, a_ref, d_ref, ctr, label):
    """Equal assignments except near-ties; distances within the fp32
    tolerance (the self floor for the centers' own ~0 distances). A
    frame assigned differently must be a near-tie: in float64 its two
    candidate centers are within both implementations' fp32 error."""
    from enspara_tpu.ops.qcp import kabsch_rmsd_np

    bad = np.flatnonzero(a_got != a_ref)
    check(len(bad) <= len(a_got) // 100,
          '%s: %d assignments differ' % (label, len(bad)))
    worst = 0.0
    for f in bad:
        d2 = [kabsch_rmsd_np(xc[f], xc[ctr[c]])
              for c in (a_got[f], a_ref[f])]
        gap = abs(d2[0] - d2[1]) / (2 * (ATOL_FP32 + RTOL_FP32 * d2[0]))
        worst = max(worst, gap)
        check(gap <= 1, '%s: frame %d assigned %d vs %d at %.7f vs '
              '%.7f A (float64) — not a near-tie'
              % (label, f, a_got[f], a_ref[f], *d2))
    # two fp32 evaluations that center and sum G apart also differ in
    # msd by up to the self floor squared: |dd| <= min(f, f^2 / 2d)
    g = np.sum(xc.astype(np.float64) ** 2, axis=(1, 2))
    f = self_floor(g + g[ctr[a_ref]], 2 * xc.shape[1])
    d = np.abs(d_ref)
    err = np.abs(d_got - d_ref)
    bound = (ATOL_FP32 + RTOL_FP32 * d
             + np.minimum(f, f * f / (2 * np.maximum(d, 1e-30))))
    ok = (err <= bound) | (a_got != a_ref)
    check(np.all(ok), '%s: distances differ by %.3g A'
          % (label, err[~ok].max() if (~ok).any() else 0))
    same = a_got == a_ref
    say('%s: %d assignments differ, all near-ties (largest float64 gap '
        '%.3f of the fp32 tolerance); max distance diff %.3g A (%.3f of '
        'the bound)' % (label, len(bad), worst, float(err[same].max()),
                        float((err / bound)[same].max())))


def _peak(dev):
    return (dev.memory_stats() or {}).get('peak_bytes_in_use')


def phase_main_path(cfg, xyz, xc, mesh, card, seed):
    phase('phase 4: library main path')
    import jax

    from enspara_tpu import cluster, msm
    from enspara_tpu.cluster import engine
    from enspara_tpu.msm import builders
    from enspara_tpu.msm.eigen_device import eigenspectrum_reversible
    from enspara_tpu.msm.transition_matrices import (
        assigns_to_counts, assigns_to_counts_device)

    k = cfg['k']
    dev = jax.devices()[0]
    say('card:', card)
    res, t_cold = _timed(cluster.kcenters, xyz, 'rmsd', n_clusters=k)
    res, t_warm = _timed(cluster.kcenters, xyz, 'rmsd', n_clusters=k)
    ctr = np.asarray(res.center_indices)
    check(len(ctr) == k, 'kcenters found %d centers' % len(ctr))
    say('kcenters(k=%d): cold %.3f s, warm %.3f s, compile ~%.3f s, '
        'peak_bytes_in_use %s' % (k, t_cold, t_warm, t_cold - t_warm,
                                   _peak(dev)))

    # the same loop with the plain iteration, and the global-view loop
    prep = engine.prepare_rmsd_frames(xyz, mesh=mesh)
    jax.block_until_ready(prep.frames)
    loops = {'kernel loop': lambda: engine.kcenters_device_fused(
                 prep, n_clusters=k, mesh=mesh),
             'plain prepared loop': lambda: _plain_kcenters(prep, k, mesh),
             'plain global-view loop':
                 lambda: _global_view_kcenters(xyz, k, mesh)}
    out = {}
    for label, fn in loops.items():
        out[label], t_c = _timed(fn)
        say('%s: first call %.3f s (compile + run)' % (label, t_c))
    # warm, in turns, on prepared frames already on the card
    warm = {label: [] for label in loops}
    for label in ('kernel loop', 'plain prepared loop',
                  'plain prepared loop', 'kernel loop',
                  'plain global-view loop'):
        warm[label].append(_timed(loops[label])[1])
    for label, ts in warm.items():
        say('%s (k=%d): warm %s s (%s)'
            % (label, k, ' '.join('%.4f' % t for t in ts), card))
    ref = out['plain prepared loop']
    same = _check_centers(ctr, ref.center_indices, prep, mesh,
                          'kcenters vs plain loop')
    if same:
        _check_assignments(xc, np.asarray(res.assignments),
                           np.asarray(res.distances),
                           np.asarray(ref.assignments),
                           np.asarray(ref.distances), ctr,
                           'kcenters vs plain loop')

    (assigs, dists), t_a = _timed(engine.assign_device, xyz, xyz[ctr],
                                  'rmsd')
    (assigs, dists), t_a2 = _timed(engine.assign_device, xyz, xyz[ctr],
                                   'rmsd')
    say('assign_device(k=%d): cold %.3f s, warm %.3f s, peak %s'
        % (k, t_a, t_a2, _peak(dev)))
    _check_assignments(xc, assigs, dists, np.asarray(res.assignments),
                       np.asarray(res.distances), ctr,
                       'assign_device vs kcenters')
    rng = np.random.default_rng(seed + 2)
    not_ctr = np.ones(len(xyz), bool)
    not_ctr[ctr] = False
    sample = rng.choice(np.flatnonzero(not_ctr), N_ORACLE_PAIRS,
                        replace=False)
    err, _ = _oracle(xc, [(int(f), int(ctr[assigs[f]])) for f in sample],
                     dists[sample])
    say('centers\' self distances: max %.3g A (fp32 floor %.3g A)'
        % (dists[ctr].max(), self_floor(
            np.sum(xc[ctr] ** 2, axis=(1, 2)).max(), xc.shape[1])))
    say('assignment vs float64 oracle on %d pairs: max |err| %.3g A'
        % (N_ORACLE_PAIRS, err))
    check(err <= ATOL_ORACLE, 'assignment vs oracle %.3g' % err)

    n_traj = cfg['n_traj']
    traj = assigs.reshape(n_traj, -1)
    mask = np.ones(traj.shape, bool)
    counts_dev, t_c = _timed(
        lambda: np.asarray(assigns_to_counts_device(traj, mask, LAG, k)))
    counts_host = assigns_to_counts(traj, LAG, max_n_states=k).toarray()
    check(np.array_equal(counts_dev, counts_host),
          'device lag-%d counts differ from the host counts' % LAG)
    say('lag-%d counts: device == host, %d transitions, %.3f s'
        % (LAG, int(counts_dev.sum()), t_c))

    m, t_m = _timed(lambda: msm.MSM(lag_time=LAG,
                                    method=builders.transpose)
                    .fit_from_counts(counts_dev))
    n_eigs = N_TIMESCALES + 1
    (w, _), t_e = _timed(eigenspectrum_reversible, m.tprobs_,
                         m.eq_probs_, n_eigs=n_eigs)
    (w, _), t_e2 = _timed(eigenspectrum_reversible, m.tprobs_,
                          m.eq_probs_, n_eigs=n_eigs)
    w_ref = _host_eigs(counts_host, n_eigs)
    check(np.abs(w - w_ref).max() <= ATOL_EIG,
          'eigenvalues differ from host fp64 by %.3g'
          % np.abs(w - w_ref).max())
    # implied timescales exist for the positive eigenvalues
    pos = w_ref[1:] > 0
    check(np.all(w[1:][pos] > 0), 'eigenvalue signs differ from host')
    ts = -LAG / np.log(w[1:][pos])
    ts_ref = -LAG / np.log(w_ref[1:][pos])
    rel = np.abs(ts - ts_ref) / ts_ref
    check(rel.max() <= RTOL_TIMESCALES,
          'timescales differ from host fp64 by %.3g relative' % rel.max())
    say('MSM (transpose, %d states): %.3f s; top-%d eigensolve cold '
        '%.3f s, warm %.3f s; max |dw| %.3g; %d timescales, max rel '
        'err %.3g' % (m.n_states_, t_m, N_TIMESCALES, t_e, t_e2,
                      np.abs(w - w_ref).max(), len(ts), rel.max()))
    say('slowest timescales (frames):', np.round(ts[:5], 3))

    # k-hybrid: PAM sweeps only accept swaps that lower the cost
    sub = xyz[:cfg['hybrid_frames']]
    kc = cluster.kcenters(sub, 'rmsd', n_clusters=cfg['hybrid_k'])
    kh, t_h = _timed(lambda: cluster.KHybrid(
        metric='rmsd', n_clusters=cfg['hybrid_k'], kmedoids_updates=2,
        random_state=seed).fit(sub))
    cost = [float(np.mean(np.square(r.distances)))
            for r in (kc, kh.result_)]
    check(cost[1] <= cost[0] * (1 + 1e-6),
          'k-hybrid raised the cost %.6g -> %.6g' % tuple(cost))
    say('khybrid(%d frames, k=%d, 2 sweeps): %.3f s, mean squared '
        'distance %.6g -> %.6g' % (len(sub), cfg['hybrid_k'], t_h, *cost))
    say('main path peak_bytes_in_use %s (%s)' % (_peak(dev), card))


def _global_view_kcenters(xyz, k, mesh):
    """Today's plain global-view loop on (n, atoms, 3) frames."""
    from enspara_tpu.cluster import engine
    from enspara_tpu.parallel import mesh as pmesh

    data, _ = engine.prepare_sharded(xyz, 'rmsd', mesh)
    dist, assig = engine._init_state(len(xyz), data.shape[0], None, None)
    dist, _ = pmesh.shard_frames(dist, mesh)
    assig, _ = pmesh.shard_frames(assig, mesh)
    out = engine._kcenters_loop(data, dist, assig, np.int32(0),
                                np.int32(k), np.float32(0), k, 'rmsd')
    return engine._result(*out, len(xyz), 0, None)


def _host_eigs(counts, n_eigs):
    """Top eigenvalues of the transpose-builder MSM in host float64."""
    C = counts.astype(np.float64)
    sym = C + C.T
    mass = sym.sum(axis=1)
    # D^1/2 T D^-1/2 with T = sym / mass and pi proportional to mass
    S = sym / np.sqrt(np.outer(mass, mass))
    return np.linalg.eigvalsh((S + S.T) / 2)[::-1][:n_eigs]


# ---------------------------------------------------------------------
# phase 5 (--four-cards)
# ---------------------------------------------------------------------

def _collectives(compiled):
    txt = compiled.as_text()
    return {op: txt.count(op + '(') + txt.count(op + '-start(')
            for op in ('all-gather', 'all-reduce', 'reduce-scatter',
                       'collective-permute', 'all-to-all')}


def phase_four_cards(cfg, xyz, n_cards):
    phase('phase 5: sharded path on %d devices vs 1' % n_cards)
    import jax

    from enspara_tpu.cluster import engine
    from enspara_tpu.msm.transition_matrices import (
        assigns_to_counts, assigns_to_counts_sharded)
    from enspara_tpu.parallel.mesh import frame_mesh

    check(len(jax.devices()) >= n_cards,
          'need %d devices, found %d' % (n_cards, len(jax.devices())))
    k = cfg['k']
    mesh1, meshn = frame_mesh(1), frame_mesh(n_cards)
    xc = centered(xyz.astype(np.float64)).astype(np.float32)
    out = {}
    for mesh in (mesh1, meshn):
        r, t_c = _timed(engine.kcenters_device, xyz, 'rmsd',
                        n_clusters=k, mesh=mesh)
        r, t_w = _timed(engine.kcenters_device, xyz, 'rmsd',
                        n_clusters=k, mesh=mesh)
        ctr = np.asarray(r.center_indices)
        (a, d), t_a = _timed(engine.assign_device, xyz, xyz[ctr], 'rmsd',
                             mesh=mesh)
        traj = a.reshape(cfg['n_traj'], -1)
        counts = np.asarray(assigns_to_counts_sharded(
            traj, np.ones(traj.shape, bool), LAG, k, mesh=mesh))
        check(np.array_equal(counts, assigns_to_counts(
            traj, LAG, max_n_states=k).toarray()),
            'sharded counts on %d device(s) differ from the host counts'
            % mesh.size)
        out[mesh.size] = (r, a, d)
        say('%d device(s): kcenters cold %.3f s warm %.3f s, assign '
            '%.3f s' % (mesh.size, t_c, t_w, t_a))
    r1, a1, d1 = out[1]
    rn, an, dn = out[n_cards]
    say('transition counts equal the host counts on 1 and %d devices'
        % n_cards)
    # the sharded loop runs the same kernel on the same frames; only the
    # cross-card argmax differs, so the centers must be identical
    prep = engine.prepare_rmsd_frames(xyz, mesh=mesh1)
    check(_check_centers(rn.center_indices, r1.center_indices, prep,
                         mesh1, '%d vs 1 devices' % n_cards),
          '%d vs 1 devices: the centers diverge' % n_cards)
    ctr = np.asarray(r1.center_indices)
    _check_assignments(xc, np.asarray(rn.assignments),
                       np.asarray(rn.distances),
                       np.asarray(r1.assignments),
                       np.asarray(r1.distances), ctr,
                       'kcenters %d vs 1' % n_cards)
    _check_assignments(xc, an, dn, a1, d1, ctr,
                       'assign_device %d vs 1' % n_cards)

    # collectives of the sharded k-centers loop
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from enspara_tpu.parallel.mesh import FRAME_AXIS, P

    prepn = engine.prepare_rmsd_frames(xyz, mesh=meshn)
    row = NamedSharding(meshn, P(FRAME_AXIS))
    n_pad = prepn.frames.shape[1]
    compiled = engine._kcenters_loop_prepared.lower(
        prepn.frames, prepn.g,
        jax.ShapeDtypeStruct((n_pad,), jnp.float32, sharding=row),
        jax.ShapeDtypeStruct((n_pad,), jnp.int32, sharding=row),
        np.int32(0), np.int32(k), np.float32(0), k_max=k,
        n_atoms=prepn.n_atoms, mesh=meshn,
        iteration=engine._iteration_for(meshn)).compile()
    say('k-centers loop collectives (per iteration body):',
        _collectives(compiled))
    say('note: the mesh is one flat axis over the %d devices' % n_cards)


# ---------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tiny', action='store_true',
                    help='rehearse every phase at a small size')
    ap.add_argument('--four-cards', action='store_true',
                    help='run only the sharded path on 4 devices')
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)
    cfg = TINY if args.tiny else FULL

    import jax

    from enspara_tpu.parallel.mesh import frame_mesh
    from enspara_tpu.util.compile_cache import enable_compilation_cache

    t_start = time.perf_counter()
    card, on_gpu = phase_device(args.tiny)
    say('compile cache:', enable_compilation_cache())
    t0 = time.perf_counter()
    xyz, _ = make_frames(cfg['n'], cfg['atoms'], cfg['n_traj'],
                         cfg['n_basins'], args.seed)
    say('\nframes %s made on the host from seed %d in %.3f s'
        % (xyz.shape, args.seed, time.perf_counter() - t0))

    if args.four_cards:
        n_cards = 4
        phase_four_cards(cfg, xyz, n_cards)
    else:
        mesh = frame_mesh(1)
        phase_compile(cfg, mesh)
        xc = phase_kernels(cfg, xyz, mesh, args.seed)
        phase_main_path(cfg, xyz, xc, mesh, card, args.seed)
    say('\nall phases passed in %.1f s' % (time.perf_counter() - t_start))
    if not on_gpu:
        say('no GPU: rehearsal only, no result')
        return 1
    d0 = jax.devices()[0]
    print(json.dumps({'ok': True, 'device': {
        'platform': d0.platform, 'kind': d0.device_kind,
        'count': len(jax.devices())}}), flush=True)
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print('FAILED:', e, flush=True)
        sys.exit(1)
