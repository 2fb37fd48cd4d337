"""The RMSD k-centers engine on its prepared frame-minor layout: the GPU
iteration kernel in the Pallas interpreter against the plain QCP
reference, the loop against the global-view loop, warm starts, cutoffs,
prepared-frame reuse, bf16 frames, streamed ingest, sharded equal to
single-device, and the one backend query that picks the path."""

import functools

import numpy as np
import pytest
from numpy.testing import assert_allclose, assert_array_equal

import jax
import jax.numpy as jnp

from enspara_tpu.cluster import engine
from enspara_tpu.ops import qcp
from enspara_tpu.ops.kcenters_triton import BLOCK, kcenters_iteration_triton
from enspara_tpu.parallel.mesh import frame_mesh

_KERNEL = functools.partial(kcenters_iteration_triton, interpret=True)


def _blobs(n, atoms, n_blobs, seed, spread=5.0, noise=0.01):
    rng = np.random.default_rng(seed)
    templates = rng.normal(size=(n_blobs, atoms, 3)).astype(np.float32)
    return (templates[np.arange(n) % n_blobs] * spread
            + noise * rng.normal(size=(n, atoms, 3)).astype(np.float32))


def _run_iteration(prep, center, iteration=_KERNEL, dist=None):
    n, A = prep.n, prep.n_atoms
    n_pad = prep.frames.shape[1]
    if dist is None:
        dist = jnp.full((n_pad,), jnp.inf, jnp.float32).at[n:].set(
            -jnp.inf)
    assig = jnp.full((n_pad,), -1, jnp.int32)
    col = prep.frames[:, center].astype(jnp.float32)
    return iteration(prep.frames, prep.g, dist, assig, col,
                     prep.g[center], np.int32(3), n_atoms=A)


# ---------------------------------------------------------------------
# the iteration kernel (interpret mode) against the plain reference
# ---------------------------------------------------------------------

@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
@pytest.mark.parametrize('n', [700, 1500])
@pytest.mark.parametrize('atoms', [8, 37, 64, 300])
def test_iteration_kernel_matches_qcp_vector(atoms, n, precision):
    """One kernel iteration equals qcp_rmsd_vector on the kernel's own
    inputs; padding frames stay at -inf; every real frame is claimed;
    the per-block (max, argmax) names the global argmax."""
    rng = np.random.default_rng(atoms + n)
    X = rng.normal(size=(n, atoms, 3)).astype(np.float32) * 3.0
    prep = engine.prepare_rmsd_frames(X, mesh=frame_mesh(1),
                                      precision=precision)
    n_pad = prep.frames.shape[1]
    assert n_pad % BLOCK == 0 and n_pad >= n
    center = n // 3
    d, a, bmax, barg = _run_iteration(prep, center)
    d = np.asarray(d)

    x = prep.frames.astype(jnp.float32).reshape(3, atoms, n_pad).T[:n]
    want = np.asarray(qcp.qcp_rmsd_vector(x, x[center], prep.g[:n],
                                          prep.g[center]))
    others = np.arange(n) != center
    assert_allclose(d[:n][others], want[others], rtol=1e-5, atol=1e-4)
    assert d[center] < 5e-3                       # fp32 self floor
    assert np.all(np.isneginf(d[n:]))
    assert np.all(np.asarray(a)[:n] == 3)
    assert np.asarray(bmax).shape == (n_pad // BLOCK,)
    top = int(np.asarray(barg)[np.argmax(np.asarray(bmax))])
    assert top == int(np.argmax(d))


def test_iteration_kernel_min_update_keeps_nearer_frames():
    """Strict-< update: frames already nearer than the new center keep
    their distance and assignment."""
    X = _blobs(1100, 6, 4, seed=1)
    prep = engine.prepare_rmsd_frames(X, mesh=frame_mesh(1))
    n_pad = prep.frames.shape[1]
    old = np.full(n_pad, np.inf, np.float32)
    old[:1100:2] = 0.0                          # half already at 0
    old[1100:] = -np.inf
    d, a, _, _ = _run_iteration(prep, 5, dist=jnp.asarray(old))
    d, a = np.asarray(d), np.asarray(a)
    assert np.all(d[:1100:2] == 0.0) and np.all(a[:1100:2] == -1)
    assert np.all(a[1:1100:2] == 3)


def test_iteration_kernel_tie_breaks_to_first_index():
    """Equal maxima across blocks: the smallest global index wins, as
    with np.argmax."""
    X = np.zeros((3 * BLOCK, 4, 3), np.float32)
    X[:, 0, 0] = 1.0
    X[[10, BLOCK + 7, 2 * BLOCK + 1], 1, 1] = 2.0   # three equal far
    prep = engine.prepare_rmsd_frames(X, mesh=frame_mesh(1))
    d, _, bmax, barg = _run_iteration(prep, 0)
    bmax, barg = np.asarray(bmax), np.asarray(barg)
    best = bmax.max()
    assert int(np.min(barg[bmax == best])) == 10 == int(np.argmax(d))


@pytest.mark.chip
@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
def test_compiled_iteration_kernel_on_gpu(gpu, precision):
    """The kernel as Triton compiles it for the card agrees with the
    plain iteration on the same card."""
    from jax.sharding import Mesh
    from enspara_tpu.parallel.mesh import FRAME_AXIS

    mesh = Mesh(np.array([gpu]), (FRAME_AXIS,))
    X = _blobs(5000, 64, 12, seed=8, noise=0.5)
    prep = engine.prepare_rmsd_frames(X, mesh=mesh, precision=precision)
    center = 11
    got = [np.asarray(o) for o in _run_iteration(
        prep, center, kcenters_iteration_triton)]
    want = [np.asarray(o) for o in _run_iteration(
        prep, center, engine._iteration_xla)]
    # the center's distance to itself sits at the fp32 cancellation
    # floor in each, as in the interpreted test above
    others = np.arange(len(got[0])) != center
    assert_allclose(got[0][others], want[0][others], rtol=2e-4, atol=1e-4)
    assert got[0][center] < 5e-3 and want[0][center] < 5e-3
    assert_array_equal(got[1], want[1])


@pytest.mark.parametrize('dtype', [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize('atoms', [8, 64])
def test_iteration_kernel_lowers_for_cuda(atoms, dtype):
    """The Triton lowering accepts the kernel (power-of-two tensors,
    supported primitives) without a GPU: lowering for the 'cuda'
    platform emits the Triton custom call that XLA compiles there."""
    n = 2 * BLOCK
    args = (jnp.zeros((3 * atoms, n), dtype), jnp.zeros(n),
            jnp.zeros(n), jnp.zeros(n, jnp.int32), jnp.zeros(3 * atoms),
            jnp.float32(0), jnp.int32(0))
    lowered = jax.jit(functools.partial(
        kcenters_iteration_triton, n_atoms=atoms)).trace(*args).lower(
            lowering_platforms=('cuda',))
    assert '__gpu$xla.gpu.triton' in lowered.as_text()


def test_iteration_kernel_rejects_unpadded_frames():
    with pytest.raises(ValueError):
        kcenters_iteration_triton(
            jnp.zeros((12, 100)), jnp.zeros(100), jnp.zeros(100),
            jnp.zeros(100, jnp.int32), jnp.zeros(12), jnp.float32(0),
            jnp.int32(0), n_atoms=4, interpret=True)


def test_xla_iteration_matches_kernel():
    """The plain iteration (the CPU path) and the kernel agree on
    distances, assignments and the next center."""
    X = _blobs(1500, 9, 5, seed=2, noise=0.3)
    prep = engine.prepare_rmsd_frames(X, mesh=frame_mesh(1))
    dk, ak, bk, gk = _run_iteration(prep, 17)
    dx, ax, bx, gx = _run_iteration(prep, 17, engine._iteration_xla)
    assert_allclose(np.asarray(dk), np.asarray(dx), rtol=1e-5, atol=1e-4)
    assert_array_equal(np.asarray(ak), np.asarray(ax))
    assert int(np.asarray(gk)[np.argmax(np.asarray(bk))]) \
        == int(np.asarray(gx)[0])


# ---------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------

def _loop(prep, k, iteration, mesh, n_start=0, dist=None, assig=None,
          cutoff=0.0, k_max=None):
    from enspara_tpu.parallel.mesh import FRAME_AXIS, NamedSharding, P

    d0, a0 = engine._init_state(prep.n, prep.frames.shape[1], dist,
                                assig)
    sh = NamedSharding(mesh, P(FRAME_AXIS))
    out = engine._kcenters_loop_prepared(
        prep.frames, prep.g, jax.device_put(d0, sh),
        jax.device_put(a0, sh), np.int32(n_start), np.int32(k),
        np.float32(cutoff), k_max=k_max or k, n_atoms=prep.n_atoms,
        mesh=mesh, iteration=iteration)
    return engine._result(*out, prep.n, 0, None)


def test_kernel_loop_matches_global_view_loop():
    """The loop driving the kernel (interpret mode) finds the same
    centers and assignments as the global-view XLA loop."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(1200, 10, 3)).astype(np.float32)
    mesh = frame_mesh(1)
    prep = engine.prepare_rmsd_frames(X, mesh=mesh)
    got = _loop(prep, 8, _KERNEL, mesh)

    data, _ = engine.prepare_sharded(X, 'rmsd', mesh)
    d0, a0 = engine._init_state(1200, data.shape[0], None, None)
    ref = engine._result(*engine._kcenters_loop(
        data, jnp.asarray(d0), jnp.asarray(a0), np.int32(0), np.int32(8),
        np.float32(0), 8, 'rmsd'), 1200, 0, None)
    assert_array_equal(got.center_indices, ref.center_indices)
    assert_array_equal(got.assignments, ref.assignments)
    assert_allclose(got.distances, ref.distances, rtol=1e-4, atol=2e-3)


def test_kernel_loop_sharded_matches_single_device():
    """Per-shard kernel (interpret mode) with the all-gather argmax and
    psum center broadcast equals the 1-device loop."""
    X = _blobs(3000, 7, 9, seed=4, noise=0.4)
    mesh1, mesh8 = frame_mesh(1), frame_mesh(8)
    assert mesh8.size == 8
    r1 = _loop(engine.prepare_rmsd_frames(X, mesh=mesh1), 9, _KERNEL,
               mesh1)
    r8 = _loop(engine.prepare_rmsd_frames(X, mesh=mesh8), 9, _KERNEL,
               mesh8)
    assert_array_equal(r1.center_indices, r8.center_indices)
    assert_array_equal(r1.assignments, r8.assignments)
    assert_allclose(r8.distances, r1.distances, rtol=1e-5, atol=1e-4)


def test_fused_kcenters_sharded_matches_single_device():
    """kcenters_device_fused on an 8-device mesh equals one device."""
    rng = np.random.default_rng(9)
    X = rng.normal(size=(600, 10, 3)).astype(np.float32)
    r1 = engine.kcenters_device_fused(X, n_clusters=9, mesh=frame_mesh(1))
    r8 = engine.kcenters_device_fused(X, n_clusters=9, mesh=frame_mesh())
    assert_array_equal(r1.center_indices, r8.center_indices)
    assert_array_equal(r1.assignments, r8.assignments)
    assert_allclose(r8.distances, r1.distances, rtol=1e-4, atol=2e-3)


def test_fused_kcenters_cutoff_stop():
    """A distance cutoff stops the loop at the same center count as the
    global-view loop."""
    rng = np.random.default_rng(17)
    X = rng.normal(size=(640, 6, 3)).astype(np.float32)
    full = engine.kcenters_device_fused(X, n_clusters=70)
    cut = float(np.percentile(full.distances, 90))
    fused = engine.kcenters_device_fused(X, dist_cutoff=cut, k_max=128)
    assert fused.distances.max() <= cut
    data, _ = engine.prepare_sharded(X, 'rmsd', frame_mesh())
    d0, a0 = engine._init_state(640, data.shape[0], None, None)
    ref = engine._result(*engine._kcenters_loop(
        data, jnp.asarray(d0), jnp.asarray(a0), np.int32(0),
        np.int32(128), np.float32(cut), 128, 'rmsd'), 640, 0, None)
    assert_array_equal(ref.center_indices, fused.center_indices)
    assert_array_equal(ref.assignments, fused.assignments)


def test_fused_kcenters_warm_start():
    """Warm starts continue the center numbering from n_init_centers."""
    rng = np.random.default_rng(23)
    X = rng.normal(size=(512, 6, 3)).astype(np.float32)
    seed = engine.kcenters_device_fused(X, n_clusters=3)
    cold = engine.kcenters_device_fused(X, n_clusters=9)
    warm = engine.kcenters_device_fused(
        X, n_clusters=9, init_distances=seed.distances,
        init_assignments=seed.assignments, n_init_centers=3,
        init_center_indices=seed.center_indices)
    assert_array_equal(cold.center_indices, warm.center_indices)
    assert_array_equal(cold.assignments, warm.assignments)
    assert warm.assignments.max() == 8


def test_kcenters_bf16_frames():
    """precision='bf16' recovers the fp32 partition of well-separated
    blobs with distances inside the rounding budget; other metrics
    refuse it."""
    X = _blobs(512, 10, 8, seed=31)
    r32 = engine.kcenters_device(X, 'rmsd', n_clusters=8)
    r16 = engine.kcenters_device(X, 'rmsd', n_clusters=8,
                                 precision='bf16')
    assert r16.n_found == r32.n_found == 8
    assert_array_equal(r16.assignments, r32.assignments)
    assert_allclose(r16.distances, r32.distances, atol=0.15)
    with pytest.raises(ValueError):
        engine.kcenters_device(X.reshape(512, -1), 'euclidean',
                               n_clusters=4, precision='bf16')


def test_prepared_frames_reuse():
    """One prepared layout serves several clusterings; mismatched
    layouts and precisions are refused."""
    rng = np.random.default_rng(41)
    X = rng.normal(size=(384, 10, 3)).astype(np.float32)
    raw = engine.kcenters_device_fused(X, n_clusters=6)
    prep = engine.prepare_rmsd_frames(X)
    pre = engine.kcenters_device_fused(prep, n_clusters=6)
    assert_array_equal(raw.center_indices, pre.center_indices)
    assert_array_equal(raw.assignments, pre.assignments)
    warm = engine.kcenters_device_fused(
        prep, n_clusters=9, init_distances=pre.distances,
        init_assignments=pre.assignments, n_init_centers=6,
        init_center_indices=pre.center_indices)
    assert warm.n_found == 9
    with pytest.raises(ValueError):
        engine.kcenters_device_fused(prep, n_clusters=4,
                                     mesh=frame_mesh(1))
    with pytest.raises(ValueError):
        engine.kcenters_device_fused(prep, n_clusters=4,
                                     precision='bf16')


def test_prepared_bf16_frames_inherit_precision():
    """precision=None inherits the prep's precision; only an explicit
    mismatching request raises."""
    X = _blobs(256, 8, 4, seed=51)
    prep16 = engine.prepare_rmsd_frames(X, precision='bf16')
    assert prep16.frames.dtype == jnp.bfloat16
    res = engine.kcenters_device_fused(prep16, n_clusters=4)
    res2 = engine.kcenters_device_fused(prep16, n_clusters=4,
                                        precision='bf16')
    assert res.n_found == 4
    assert_array_equal(res.assignments, res2.assignments)
    with pytest.raises(ValueError):
        engine.kcenters_device_fused(prep16, n_clusters=4,
                                     precision='fp32')


def test_prepared_layout():
    """Rows i*A + a hold coordinate i of atom a of the centered frames;
    padding frames are zero with G = 0."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(50, 4, 3)).astype(np.float32) + 7.0
    prep = engine.prepare_rmsd_frames(X, mesh=frame_mesh(8))
    f = np.asarray(prep.frames)
    assert f.shape == (12, 8 * BLOCK) and prep.n_shards == 8
    xc = X - X.mean(axis=1, keepdims=True)
    assert_allclose(f[:, :50], xc.transpose(2, 1, 0).reshape(12, 50),
                    atol=1e-5)
    assert np.all(f[:, 50:] == 0)
    g = np.asarray(prep.g)
    assert_allclose(g[:50], (xc * xc).sum((1, 2)), rtol=1e-5)
    assert np.all(g[50:] == 0)


@pytest.mark.parametrize('precision', ['fp32', 'bf16'])
def test_streamed_ingest_equals_monolithic(precision, monkeypatch):
    """The chunked ingest gives the monolithic layout, ragged final
    chunk and bf16 rounding included."""
    A, n = 10, 700
    X = _blobs(n, A, 5, seed=77)
    monkeypatch.setattr(engine, '_STREAM_CHUNK_BYTES', 256 * A * 3 * 4)
    mono = engine.prepare_rmsd_frames(X, precision=precision,
                                      mesh=frame_mesh(1), stream=False)
    strm = engine.prepare_rmsd_frames(X, precision=precision,
                                      mesh=frame_mesh(1))
    fm = np.asarray(mono.frames.astype(jnp.float32))
    fs = np.asarray(strm.frames.astype(jnp.float32))
    assert_allclose(fm, fs, rtol=2e-4, atol=2e-6)
    assert_array_equal(fm == 0.0, fs == 0.0)
    assert_allclose(np.asarray(mono.g), np.asarray(strm.g), rtol=2e-5)
    res_raw = engine.kcenters_device_fused(X, n_clusters=5,
                                           precision=precision,
                                           mesh=frame_mesh(1))
    res_strm = engine.kcenters_device_fused(strm, n_clusters=5,
                                            mesh=frame_mesh(1))
    assert_array_equal(res_raw.assignments, res_strm.assignments)


def test_streamed_ingest_unaligned_chunk(monkeypatch):
    """A chunk size that does not divide the padded length must not
    shift the tail chunk back over real frames."""
    A, n = 10, 700
    X = np.random.default_rng(99).normal(size=(n, A, 3)).astype(
        np.float32) * 3.0
    monkeypatch.setattr(engine, '_STREAM_CHUNK_BYTES', 300 * A * 3 * 4)
    mono = engine.prepare_rmsd_frames(X, mesh=frame_mesh(1),
                                      stream=False)
    strm = engine.prepare_rmsd_frames(X, mesh=frame_mesh(1))
    assert_allclose(np.asarray(mono.frames), np.asarray(strm.frames),
                    rtol=2e-4, atol=2e-6)
    assert_allclose(np.asarray(mono.g), np.asarray(strm.g), rtol=2e-5)


# ---------------------------------------------------------------------
# assignment
# ---------------------------------------------------------------------

def test_assign_device_sharded_matches_single_device():
    X = _blobs(400, 12, 4, seed=2, noise=0.5)
    centers = X[[0, 101, 202, 303]]
    a1, d1 = engine.assign_device(X, centers, 'rmsd', mesh=frame_mesh(1))
    a8, d8 = engine.assign_device(X, centers, 'rmsd', mesh=frame_mesh())
    assert_array_equal(a1, a8)
    assert_allclose(d1, d8, rtol=1e-5, atol=2e-3)
    assert_array_equal(a1, np.arange(400) % 4)


@pytest.mark.parametrize('limit,n,k,want', [
    (None, 1000, 300, 300),            # no memory report: 2 GiB budget
    (80 << 30, 1_000_000, 1000, 256),  # 20 GiB budget at 64 B / pair
    (16 << 30, 1_000_000, 1000, 64),
    (1 << 20, 1_000_000, 1000, 1),
])
def test_assign_block_fits_device_memory(limit, n, k, want, monkeypatch):
    monkeypatch.setattr(engine, 'device_memory_bytes', lambda d: limit)
    assert engine._assign_block(n, k, frame_mesh(1)) == want


# ---------------------------------------------------------------------
# the backend query
# ---------------------------------------------------------------------

class _FakeMesh:
    def __init__(self, platform):
        dev = type('Dev', (), {'platform': platform})()
        self.devices = np.array([dev])


def test_on_accelerator():
    from enspara_tpu.util.backend import on_accelerator
    assert not on_accelerator()
    assert not on_accelerator(frame_mesh())
    assert on_accelerator(_FakeMesh('gpu'))


def test_iteration_choice_follows_the_mesh():
    assert engine._iteration_for(_FakeMesh('gpu')) \
        is kcenters_iteration_triton
    assert engine._iteration_for(frame_mesh()) is engine._iteration_xla


def test_device_memory_bytes_on_cpu():
    from enspara_tpu.util.backend import device_memory_bytes
    got = device_memory_bytes(jax.devices()[0])
    assert got is None or got > 0
