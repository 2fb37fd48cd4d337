"""Device clustering engine.

The reference's k-centers outer loop is a stateful Python loop with MPI
collectives per iteration (enspara/cluster/kcenters.py:217-231, :314-378).
Here the whole loop is ONE jitted ``lax.while_loop`` over frame-sharded
arrays.

* ``metric='rmsd'`` (the main path) runs on frames ingested once into a
  frame-minor layout (:func:`prepare_rmsd_frames`). Each shard runs one
  fused iteration per center over its local frames; the global argmax
  and the broadcast of the new center are explicit mesh collectives
  under ``shard_map`` — the reference's MPI allgather + Bcast
  choreography. On a GPU the iteration is the Triton kernel
  (:mod:`enspara_tpu.ops.kcenters_triton`); on the CPU it is the same
  arithmetic in plain ``jax.numpy``.
* The vector metrics run a global-view loop over
  ``NamedSharding(mesh, P('frames'))`` arrays, and XLA's SPMD
  partitioner inserts the collectives.

A 1-device mesh degrades to a plain single-device loop with no
communication.

Padding frames carry ``distance = -inf`` so they are never selected as
a center, never count toward the stopping criterion, and keep
assignment -1.
"""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..parallel import mesh as pmesh
from ..parallel.mesh import FRAME_AXIS, P, NamedSharding
from ..ops import qcp
from ..ops.kcenters_triton import BLOCK, kcenters_iteration_triton
from ..util.backend import device_memory_bytes, on_accelerator

NEG_INF = -jnp.inf

_IMAX = jnp.iinfo(jnp.int32).max

__all__ = ['kcenters_device', 'kcenters_device_fused', 'assign_device',
           'KCentersDeviceResult', 'PreparedRMSDFrames',
           'prepare_rmsd_frames']


# ---------------------------------------------------------------------
# metric kernels: distance of every frame to one frame
# ---------------------------------------------------------------------

def _euclidean_to(X, frame):
    d = X - frame[None]
    return jnp.sqrt(jnp.sum(d * d, axis=-1))


def _manhattan_to(X, frame):
    return jnp.sum(jnp.abs(X - frame[None]), axis=-1)


def _hamming_to(X, frame):
    return jnp.mean((X != frame[None]).astype(jnp.float32), axis=-1)


def _rmsd_to(X, frame):
    """X: (n, N, 3) centered; frame: (N, 3) centered."""
    g = jnp.sum(X * X, axis=(-2, -1))
    return qcp.qcp_rmsd_vector(X, frame, g, jnp.sum(frame * frame))


_METRIC_TO_FRAME = {
    'euclidean': _euclidean_to,
    'manhattan': _manhattan_to,
    'cityblock': _manhattan_to,
    'hamming': _hamming_to,
    'rmsd': _rmsd_to,
}


class KCentersDeviceResult(NamedTuple):
    distances: np.ndarray       # (n,) float64
    assignments: np.ndarray     # (n,) int64
    center_indices: np.ndarray  # (n_found,) int64 global frame indices
    n_found: int


@functools.partial(jax.jit, static_argnames=('k_max', 'metric'))
def _kcenters_loop(data, distances, assignments, n_start, n_clusters,
                   dist_cutoff, k_max, metric):
    """Global-view k-centers while_loop. All arrays may be sharded on
    their frame axis; XLA partitions the body automatically."""
    to_frame = _METRIC_TO_FRAME[metric]
    ctr_inds = jnp.full((k_max,), -1, jnp.int32)

    def cond(state):
        i, dists, _, _ = state
        return (i < n_clusters) & (jnp.max(dists) > dist_cutoff)

    def step(state):
        i, dists, assigs, ctrs = state
        gidx = jnp.argmax(dists)      # first-max tie break, global
        ctrs = ctrs.at[i].set(gidx.astype(jnp.int32))
        d_new = to_frame(data, data[gidx])  # cross-shard center fetch
        upd = d_new < dists
        dists = jnp.where(upd, d_new, dists)
        assigs = jnp.where(upd, i, assigs)
        return (i + 1, dists, assigs, ctrs)

    init = (jnp.asarray(n_start, jnp.int32), distances, assignments,
            ctr_inds)
    i, dists, assigs, ctrs = jax.lax.while_loop(cond, step, init)
    return dists, assigs, ctrs, i


@jax.jit
def _center_structures(X):
    return X - jnp.mean(X, axis=1, keepdims=True)


def _prepare_data(X, metric):
    """Host-side dtype prep only — no device roundtrips. Device arrays
    pass through untouched (assumed already prepared)."""
    if isinstance(X, jax.Array):
        return X
    X = np.asarray(X)
    if metric == 'rmsd':
        if X.ndim != 3 or X.shape[-1] != 3:
            raise ValueError("metric='rmsd' requires (n, n_atoms, 3) "
                             "coordinates, got %s" % (X.shape,))
        X = X.astype(np.float32)
    elif metric == 'hamming':
        X = X.astype(np.int32)
    else:
        X = X.astype(np.float32)
    return X


def prepare_sharded(X, metric, mesh=None):
    """One host->device push + on-device centering (for 'rmsd'),
    sharded over the frame mesh. Returns ``(data_sharded, n_valid)``.
    Accepts host arrays or already-on-device arrays (no host trip).

    The centering happens AFTER placement so big coordinate sets never
    bounce back through the host (reference precenters on host,
    cluster/util.py:625).
    """
    if mesh is None:
        mesh = pmesh.frame_mesh()
    data = _prepare_data(X, metric)
    data_sh, n = pmesh.shard_frames(data, mesh)
    if metric == 'rmsd':
        # centering is idempotent, so always apply it on device; this
        # removes any dependence on whether the caller pre-centered
        data_sh = _center_structures(data_sh)
    return data_sh, n


def _init_state(n, n_pad, init_distances, init_assignments):
    """Host (distances, assignments) of length ``n_pad``: +inf / -1 on
    real frames (or the warm start), -inf on padding."""
    distances = np.full(n_pad, np.inf, np.float32)
    assignments = np.full(n_pad, -1, np.int32)
    if init_distances is not None:
        distances[:n] = init_distances
        assignments[:n] = init_assignments
    distances[n:] = NEG_INF
    return distances, assignments


def _loop_limits(n, n_clusters, dist_cutoff, k_max):
    if k_max is None:
        k_max = int(n_clusters) if n_clusters is not None else n
    k_max = int(min(k_max, n))
    n_clusters_eff = np.int32(min(n_clusters or n, k_max))
    cutoff_eff = np.float32(dist_cutoff if dist_cutoff is not None
                            else 0.0)
    return k_max, n_clusters_eff, cutoff_eff


def kcenters_device(X, metric='euclidean', n_clusters=None,
                    dist_cutoff=None, k_max=None,
                    init_distances=None, init_assignments=None,
                    n_init_centers=0, init_center_indices=None,
                    mesh=None, precision=None):
    """Run the sharded device k-centers loop.

    Parameters mirror the reference's ``kcenters()``
    (enspara/cluster/kcenters.py:108); ``X`` is an ndarray of features
    (n, d) or coordinates (n, n_atoms, 3) for ``metric='rmsd'``.
    ``metric='rmsd'`` runs :func:`kcenters_device_fused`, whose
    ``precision='bf16'`` stores frames as bfloat16 (see there for the
    rounding bound). ``None`` (the default) means fp32 for raw inputs
    and inherit-from-prep for :class:`PreparedRMSDFrames`.
    """
    if metric not in _METRIC_TO_FRAME:
        raise ValueError('device engine supports metrics %s, got %r'
                         % (sorted(_METRIC_TO_FRAME), metric))
    if n_clusters is None and dist_cutoff is None:
        raise ValueError('Either n_clusters or dist_cutoff is required')
    if mesh is None:
        mesh = pmesh.frame_mesh()
    if metric == 'rmsd':
        return kcenters_device_fused(
            X, n_clusters=n_clusters, dist_cutoff=dist_cutoff,
            k_max=k_max, init_distances=init_distances,
            init_assignments=init_assignments,
            n_init_centers=n_init_centers,
            init_center_indices=init_center_indices,
            mesh=mesh, precision=precision)
    if precision not in (None, 'fp32'):
        raise ValueError("precision='bf16' applies to metric='rmsd' "
                         'only, got metric=%r' % (metric,))

    n = len(X)
    k_max, n_clusters_eff, cutoff_eff = _loop_limits(
        n, n_clusters, dist_cutoff, k_max)

    data_sh, _ = prepare_sharded(X, metric, mesh)
    distances, assignments = _init_state(
        n, data_sh.shape[0], init_distances, init_assignments)
    dist_sh, _ = pmesh.shard_frames(distances, mesh)
    assig_sh, _ = pmesh.shard_frames(assignments, mesh)

    dists, assigs, ctrs, n_found = _kcenters_loop(
        data_sh, dist_sh, assig_sh,
        np.int32(n_init_centers), n_clusters_eff, cutoff_eff,
        k_max, metric)
    return _result(dists, assigs, ctrs, n_found, n, n_init_centers,
                   init_center_indices)


def _result(dists, assigs, ctrs, n_found, n, n_init_centers,
            init_center_indices):
    dists = pmesh.host_fetch(dists)[:n].astype(np.float64)
    assigs = pmesh.host_fetch(assigs)[:n].astype(np.int64)
    n_found = int(pmesh.host_fetch(n_found))
    ctr_inds = pmesh.host_fetch(ctrs)[:n_found].astype(np.int64)
    if init_center_indices is not None:
        ctr_inds[:n_init_centers] = init_center_indices
    return KCentersDeviceResult(dists, assigs, ctr_inds, n_found)


# ---------------------------------------------------------------------
# batched assignment: every frame to its nearest center
# ---------------------------------------------------------------------

def _pairwise_block(data, cblock, metric):
    """(n, B) distances from all frames to one block of centers."""
    if metric == 'rmsd':
        g_data = jnp.sum(data * data, axis=(-2, -1))
        g_c = jnp.sum(cblock * cblock, axis=(-2, -1))
        return qcp.qcp_rmsd_matrix(data, cblock, g_data, g_c)
    if metric in ('euclidean',):
        from ..ops.distances import pairwise_euclidean
        return pairwise_euclidean(data, cblock)
    if metric in ('manhattan', 'cityblock'):
        return jnp.sum(jnp.abs(data[:, None, :] - cblock[None, :, :]),
                       axis=-1)
    if metric == 'hamming':
        return jnp.mean((data[:, None, :] != cblock[None, :, :])
                        .astype(jnp.float32), axis=-1)
    raise ValueError(metric)


# bytes one (frame, center) pair holds at once in a pairwise block: the
# (3, 3) fp32 inner products of the rmsd metric, the distance and a
# margin for the fused epilogue's temporaries
_PAIR_BYTES = 64
_MAX_ASSIGN_BLOCK = 512


def _assign_block(n_local, k, mesh):
    """Centers per pairwise block: the largest power of two up to 512
    whose ``(n_local, block)`` working set fits a quarter of one
    device's memory (2 GiB where the device reports none)."""
    budget = (device_memory_bytes(mesh.devices.flat[0])
              or 8 << 30) // 4
    block = _MAX_ASSIGN_BLOCK
    while block > 1 and n_local * block * _PAIR_BYTES > budget:
        block //= 2
    return int(min(block, k))


@functools.partial(jax.jit, static_argnames=('metric', 'k_real', 'block'))
def _assign_all(data, centers, metric, k_real=None, block=512):
    """Assign every frame to its nearest center: a scan over center
    blocks carrying the running (min distance, argmin) — peak memory is
    (n, block) regardless of k, and each block is one batched
    computation. First-min tie break matches the reference's strict-<
    update loop."""
    n = data.shape[0]
    k = centers.shape[0]
    if k_real is None:
        k_real = k
    block = min(block, k)
    n_blocks = (k + block - 1) // block
    k_pad = n_blocks * block
    if k_pad != k:
        pad = [(0, k_pad - k)] + [(0, 0)] * (centers.ndim - 1)
        centers = jnp.pad(centers, pad)
    cblocks = centers.reshape((n_blocks, block) + centers.shape[1:])

    def step(carry, inp):
        best_d, best_i = carry
        b_idx, cblock = inp
        d = _pairwise_block(data, cblock, metric)  # (n, block)
        # mask padded centers (indices >= k_real)
        cid = b_idx * block + jnp.arange(block)
        d = jnp.where(cid[None, :] < k_real, d, jnp.inf)
        local_arg = jnp.argmin(d, axis=1)
        local_min = jnp.take_along_axis(
            d, local_arg[:, None], axis=1)[:, 0]
        upd = local_min < best_d
        best_d = jnp.where(upd, local_min, best_d)
        best_i = jnp.where(upd,
                           (b_idx * block + local_arg).astype(jnp.int32),
                           best_i)
        return (best_d, best_i), None

    init = (jnp.full((n,), jnp.inf, jnp.float32),
            jnp.zeros((n,), jnp.int32))
    (dists, assigs), _ = jax.lax.scan(
        step, init, (jnp.arange(n_blocks), cblocks))
    return assigs, dists


def assign_device(X, centers, metric='euclidean', mesh=None):
    """Assign every frame to its nearest center on the mesh — the
    batched device form of the reference's ``assign_to_nearest_center``
    (enspara/cluster/util.py:159).

    Returns ``(assignments (n,), distances (n,))`` as numpy arrays.
    """
    n = len(X)
    if mesh is None:
        mesh = pmesh.frame_mesh()
    data_sh, _ = prepare_sharded(X, metric, mesh)
    centers_host = _prepare_data(centers, metric)
    centers_r = pmesh.replicated(centers_host, mesh) \
        if not isinstance(centers_host, jax.Array) else centers_host
    if metric == 'rmsd':
        centers_r = _center_structures(centers_r)
    k = int(centers_r.shape[0])
    block = _assign_block(data_sh.shape[0] // mesh.size, k, mesh)
    assigs, dists = _assign_all(data_sh, centers_r, metric, k_real=k,
                                block=block)
    return (np.asarray(assigs)[:n].astype(np.int64),
            np.asarray(dists)[:n].astype(np.float64))


# ---------------------------------------------------------------------
# RMSD k-centers on the prepared frame-minor layout
# ---------------------------------------------------------------------

class PreparedRMSDFrames(NamedTuple):
    """Frames ingested once into the RMSD k-centers layout.

    Build with :func:`prepare_rmsd_frames`; pass to
    :func:`kcenters_device_fused` in place of raw coordinates to
    amortize the ingest (centering, transpose, padding and the optional
    bf16 cast) across clusterings of the same dataset (warm starts,
    cutoff scans, khybrid rounds).
    """
    frames: jax.Array          # (3*n_atoms, n_pad) fp32 or bf16
    g: jax.Array               # (n_pad,) fp32
    n: int                     # real frame count
    n_atoms: int
    n_shards: int
    precision: str


_STREAM_CHUNK_BYTES = 64 * (1 << 20)


def _layout(ch, precision):
    """Centered ``(m, A, 3)`` coordinates -> the ``(3*A, m)`` frame-minor
    rows ``i*A + a`` and the per-frame G. For bf16 the coordinates are
    rounded ONCE and G is derived from the rounded values, so G and the
    inner products agree and self-distances stay ~0. The rounding is an
    explicit ``reduce_precision``: a bare bf16 round trip may be kept
    in fp32 inside a GPU fusion, which would give G from the unrounded
    values."""
    if precision == 'bf16':
        ch = jax.lax.reduce_precision(ch, exponent_bits=8,
                                      mantissa_bits=7)
    g = jnp.sum(ch * ch, axis=(1, 2))
    if precision == 'bf16':
        ch = ch.astype(jnp.bfloat16)         # exact after the rounding
    m, A = ch.shape[0], ch.shape[1]
    return jnp.transpose(ch, (2, 1, 0)).reshape(3 * A, m), g


@functools.partial(jax.jit, donate_argnums=(0, 1),
                   static_argnames=('precision',))
def _ingest_chunk(frames_buf, g_buf, chunk, off, precision):
    """Center one coordinate chunk, lay it out, and write it and its G
    into the prepared buffers at column ``off`` (traced, so every chunk
    reuses one compiled program; donation keeps the big buffer in
    place). Runs while the NEXT chunk's ``device_put`` is in flight."""
    ch = chunk - jnp.mean(chunk, axis=1, keepdims=True)
    ch_r, g_ch = _layout(ch, precision)
    frames_buf = jax.lax.dynamic_update_slice(frames_buf, ch_r, (0, off))
    g_buf = jax.lax.dynamic_update_slice(g_buf, g_ch, (off,))
    return frames_buf, g_buf


def _prepare_rmsd_frames_streamed(X, n, A, n_pad, precision):
    """Chunked host->device ingest: the host copy of chunk i+1 and its
    H2D transfer overlap chunk i's on-device centering and layout
    transform (async dispatch pipelines them — no explicit threads).
    Numerically identical to the monolithic path.

    The final chunk is truncated to the remaining PADDED length, never
    zero-padded past it: ``dynamic_update_slice`` CLAMPS out-of-bounds
    start indices, so a chunk reaching beyond ``n_pad`` would silently
    shift backwards and overwrite earlier frames."""
    dtype = jnp.bfloat16 if precision == 'bf16' else jnp.float32
    cf = max(1, int(_STREAM_CHUNK_BYTES // (A * 3 * 4)))
    frames_buf = jnp.zeros((3 * A, n_pad), dtype)
    g_buf = jnp.zeros((n_pad,), jnp.float32)
    for off in range(0, n, cf):
        cf_eff = min(cf, n_pad - off)
        hi = min(off + cf_eff, n)
        chunk = np.asarray(X[off:hi], dtype=np.float32)
        if hi - off < cf_eff:
            chunk = np.concatenate(
                [chunk,
                 np.zeros((cf_eff - (hi - off), A, 3), np.float32)])
        dev = jax.device_put(chunk)          # async H2D
        frames_buf, g_buf = _ingest_chunk(
            frames_buf, g_buf, dev, jnp.int32(off), precision)
    return frames_buf, g_buf


@functools.partial(jax.jit, static_argnames=('n_pad', 'precision'))
def _prepare_monolithic(data, n_pad, precision):
    data = _center_structures(data.astype(jnp.float32))
    data = jnp.pad(data, ((0, n_pad - data.shape[0]), (0, 0), (0, 0)))
    return _layout(data, precision)


def prepare_rmsd_frames(X, mesh=None, precision='fp32', stream='auto'):
    """One-time ingest of ``(n, n_atoms, 3)`` coordinates (host or
    device) into the RMSD k-centers layout. See
    :class:`PreparedRMSDFrames`.

    Frames are padded to a multiple of the kernel block times the mesh
    size. ``stream='auto'`` (default) pipelines host inputs through
    chunked ``device_put`` + on-device transform whenever the input is
    a host array on a 1-device mesh and spans several chunks;
    ``stream=False`` forces the monolithic path."""
    if precision not in ('fp32', 'bf16'):
        raise ValueError("precision must be 'fp32' or 'bf16', got %r"
                         % (precision,))
    if mesh is None:
        mesh = pmesh.frame_mesh()
    n_shards = mesh.size
    if not isinstance(X, (np.ndarray, jax.Array)):
        X = np.asarray(X)
    if X.ndim != 3 or X.shape[-1] != 3:
        raise ValueError('prepare_rmsd_frames requires (n, n_atoms, 3)'
                         ' coordinates, got %s' % (X.shape,))
    n, A = len(X), int(X.shape[1])
    n_pad = pmesh.pad_to_multiple(max(n, 1), BLOCK * n_shards)

    stream_cf = _STREAM_CHUNK_BYTES // (A * 3 * 4)
    with jax.default_device(mesh.devices.flat[0]):
        if (stream in ('auto', True) and n_shards == 1
                and not isinstance(X, jax.Array) and n > stream_cf):
            frames, g = _prepare_rmsd_frames_streamed(
                X, n, A, n_pad, precision)
        else:
            frames, g = _prepare_monolithic(
                jnp.asarray(X), n_pad, precision)
    frames = jax.device_put(frames, NamedSharding(mesh, P(None,
                                                          FRAME_AXIS)))
    g = jax.device_put(g, NamedSharding(mesh, P(FRAME_AXIS)))
    return PreparedRMSDFrames(frames, g, n, A, n_shards, precision)


def _iteration_xla(frames, g, dist, assig, center, g_center, center_id,
                   n_atoms):
    """The plain form of :func:`kcenters_iteration_triton` (same
    arguments and results, one block): a frame-minor multiply-reduce
    that XLA fuses, the same Newton epilogue, the min update and the
    (max, argmax) of the updated distances."""
    f = frames.reshape(3, n_atoms, -1).astype(jnp.float32)
    c = center.reshape(3, n_atoms)
    S = jnp.sum(f[:, None] * c[None, :, :, None], axis=2)   # (3, 3, n)
    Sc = tuple(S[i, j] for i in range(3) for j in range(3))
    d_new = qcp.rmsd_from_S_components_unrolled(Sc, g + g_center,
                                                float(n_atoms))
    upd = d_new < dist
    nd = jnp.where(upd, d_new, dist)
    na = jnp.where(upd, center_id, assig)
    return (nd, na, jnp.max(nd)[None],
            jnp.argmax(nd)[None].astype(jnp.int32))


def _iteration_for(mesh):
    """The fused iteration for the mesh's platform: the Triton kernel on
    a GPU, its plain ``jax.numpy`` form on the CPU."""
    return kcenters_iteration_triton if on_accelerator(mesh) \
        else _iteration_xla


@functools.partial(jax.jit,
                   static_argnames=('k_max', 'n_atoms', 'mesh',
                                    'iteration'))
def _kcenters_loop_prepared(frames, g, dist, assig, n_start, n_clusters,
                            dist_cutoff, k_max, n_atoms, mesh,
                            iteration):
    """k-centers while_loop over the prepared layout. Each shard runs
    ``iteration`` on its local frames; the per-center argmax and the
    center broadcast are explicit collectives — the reference's MPI
    choreography (enspara/cluster/kcenters.py:314-378: allgather of the
    local max/argmax + Bcast of the winning frame).

    Ties break toward the smallest global index, matching the serial
    ``np.argmax``.
    """
    def body(f_l, g_l, d_l, a_l, n_start, n_clusters, dist_cutoff):
        rows, n_local = f_l.shape
        start = (jax.lax.axis_index(FRAME_AXIS) * n_local) \
            .astype(jnp.int32)

        def global_best(vals, args):
            # (max, first argmax) over every shard's candidates — the
            # same tie-break contract as parallel.ops.global_argmax
            vals = jax.lax.all_gather(vals, FRAME_AXIS).reshape(-1)
            args = jax.lax.all_gather(start + args,
                                      FRAME_AXIS).reshape(-1)
            best = jnp.max(vals)
            return best, jnp.min(jnp.where(vals == best, args, _IMAX))

        def cond(state):
            i, md = state[0], state[5]
            return (i < n_clusters) & (md > dist_cutoff)

        def step(state):
            i, d, a, ctrs, gidx, _ = state
            ctrs = ctrs.at[i].set(gidx)
            # owner-masked slice + psum = Bcast of the center column
            owned = (gidx >= start) & (gidx < start + n_local)
            lidx = jnp.clip(gidx - start, 0, n_local - 1)
            col = jax.lax.dynamic_slice(f_l, (0, lidx), (rows, 1))[:, 0]
            col = jax.lax.psum(
                jnp.where(owned, col.astype(jnp.float32), 0.0),
                FRAME_AXIS)
            gc = jax.lax.psum(jnp.where(owned, g_l[lidx], 0.0),
                              FRAME_AXIS)
            d, a, bmax, barg = iteration(f_l, g_l, d, a, col, gc, i,
                                         n_atoms=n_atoms)
            md, gidx = global_best(bmax, barg)
            return (i + 1, d, a, ctrs, gidx, md)

        md0, gidx0 = global_best(
            jnp.max(d_l)[None], jnp.argmax(d_l)[None].astype(jnp.int32))
        init = (n_start, d_l, a_l, jnp.full((k_max,), -1, jnp.int32),
                gidx0, md0)
        i, d, a, ctrs = jax.lax.while_loop(cond, step, init)[:4]
        return d, a, ctrs, i

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(None, FRAME_AXIS), P(FRAME_AXIS), P(FRAME_AXIS),
                  P(FRAME_AXIS), P(), P(), P()),
        out_specs=(P(FRAME_AXIS), P(FRAME_AXIS), P(), P()),
        check_vma=False)(frames, g, dist, assig, n_start, n_clusters,
                         dist_cutoff)


def kcenters_device_fused(X, n_clusters=None, dist_cutoff=None,
                          k_max=None, init_distances=None,
                          init_assignments=None, n_init_centers=0,
                          init_center_indices=None, mesh=None,
                          precision=None):
    """RMSD k-centers on the prepared layout (the path behind
    :func:`kcenters_device` for ``metric='rmsd'``). Same result
    contract. ``X`` is raw ``(n, n_atoms, 3)`` coordinates or a
    :class:`PreparedRMSDFrames` laid out for ``mesh``.

    ``precision='bf16'`` stores the frames in bfloat16 (upcast on load;
    all arithmetic fp32). The loop reads every frame once per center,
    so this halves the bytes it moves and the frames' footprint. Each
    centered coordinate is rounded to 2^-8 relative, which moves an
    RMSD by at most 2^-8 times the sum of the two structures' RMS
    extents (``sqrt(G / n_atoms)``): ~0.4% of the distance between far
    structures, more of a small one, and assignments are no longer
    bit-identical to the fp32 path. G values and the inner products
    come from the SAME rounded coordinates, so self-distances stay ~0.
    """
    if mesh is None:
        mesh = pmesh.frame_mesh()
    if isinstance(X, PreparedRMSDFrames):
        prep = X
        if prep.n_shards != mesh.size:
            raise ValueError('prepared frames were laid out for %d '
                             'shard(s), mesh has %d'
                             % (prep.n_shards, mesh.size))
        if precision is not None and precision != prep.precision:
            # an EXPLICIT mismatching request must not silently run at
            # the prep's precision; the None default inherits it
            raise ValueError('prepared frames are %s, got precision=%s'
                             % (prep.precision, precision))
    else:
        prep = prepare_rmsd_frames(X, mesh=mesh,
                                   precision=precision or 'fp32')
    n = prep.n
    k_max, n_clusters_eff, cutoff_eff = _loop_limits(
        n, n_clusters, dist_cutoff, k_max)
    dist, assig = _init_state(n, prep.frames.shape[1], init_distances,
                              init_assignments)
    sh = NamedSharding(mesh, P(FRAME_AXIS))
    d, a, c, n_found = _kcenters_loop_prepared(
        prep.frames, prep.g, jax.device_put(dist, sh),
        jax.device_put(assig, sh), np.int32(n_init_centers),
        n_clusters_eff, cutoff_eff, k_max=k_max, n_atoms=prep.n_atoms,
        mesh=mesh, iteration=_iteration_for(mesh))
    return _result(d, a, c, n_found, n, n_init_centers,
                   init_center_indices)
