"""In-jit collective vocabulary — the device-mesh replacement for the
reference's MPI op set (enspara/mpi/ops.py; SURVEY.md §2.4).

Mapping from the reference's collectives to mesh collectives:

================================  =====================================
reference (mpi4py)                here (inside shard_map over 'frames')
================================  =====================================
allreduce(MAX) striped max        ``striped_max`` (lax.pmax)
allreduce(SUM) striped mean       ``striped_mean`` (lax.psum of sums)
allgather of local argmax/max     ``global_argmax`` (all_gather + tie
                                  break to the smallest global index,
                                  matching np.argmax first-max)
Bcast frame from owner rank       ``distribute_frame`` (one-hot psum)
assemble_striped_array            plain ``jax.device_get`` — arrays are
                                  globally addressable under jax
================================  =====================================

These helpers are called *inside* ``shard_map`` bodies; each operates on
the local shard and returns replicated results.

A second, host-level vocabulary mirrors the reference's mpi.ops API by
name for users porting scripts (``striped_array_max``,
``striped_array_mean``, ``assemble_striped_array``,
``assemble_striped_ragged_array``, ``convert_local_indices``,
``randind``): these operate on each *process's* stripe (item i lives on
process i % n_processes, the same convention as
:mod:`enspara_tpu.parallel.io`) and degrade to exact single-process
semantics when there is one process — the analogue of the reference's
DummyComm fallback (enspara/mpi/util.py:6).
"""

import numpy as np

import jax
import jax.numpy as jnp

from .mesh import FRAME_AXIS

__all__ = ['striped_max', 'striped_mean', 'global_argmax',
           'distribute_frame', 'local_shard_bounds',
           'striped_array_max', 'striped_array_mean',
           'assemble_striped_array', 'assemble_striped_ragged_array',
           'convert_local_indices', 'randind']


def local_shard_bounds(n_local, axis=FRAME_AXIS):
    """(start, stop) global indices of this shard's rows, assuming
    contiguous block striping (jax's default for a sharded leading
    axis)."""
    idx = jax.lax.axis_index(axis)
    start = idx * n_local
    return start, start + n_local


def striped_max(x_local, axis=FRAME_AXIS):
    """Global max of a frame-sharded vector (reference:
    mpi/ops.py:128 striped_array_max)."""
    return jax.lax.pmax(jnp.max(x_local), axis)


def striped_mean(x_local, weight_local=None, axis=FRAME_AXIS):
    """Global mean of a frame-sharded vector, optionally masked
    (reference: mpi/ops.py:143 striped_array_mean)."""
    if weight_local is None:
        s = jax.lax.psum(jnp.sum(x_local), axis)
        n = jax.lax.psum(jnp.asarray(x_local.size, jnp.float32), axis)
    else:
        s = jax.lax.psum(jnp.sum(x_local * weight_local), axis)
        n = jax.lax.psum(jnp.sum(weight_local), axis)
    return s / n


def global_argmax(x_local, axis=FRAME_AXIS):
    """(value, global_index) of the global maximum of a frame-sharded
    vector, breaking ties toward the smallest global index so results
    bit-match the serial ``np.argmax`` (SURVEY.md 'hard parts').

    Assumes contiguous block striping of the global array.
    """
    n_local = x_local.shape[0]
    local_arg = jnp.argmax(x_local)
    local_max = x_local[local_arg]
    start, _ = local_shard_bounds(n_local, axis)
    global_arg = start + local_arg

    vals = jax.lax.all_gather(local_max, axis)    # (n_shards,)
    args = jax.lax.all_gather(global_arg, axis)   # (n_shards,)
    best = jnp.max(vals)
    # ties -> smallest global index
    winner_idx = jnp.min(jnp.where(vals == best, args,
                                   jnp.iinfo(jnp.int32).max))
    return best, winner_idx


def distribute_frame(data_local, global_index, axis=FRAME_AXIS):
    """Fetch row ``global_index`` of a frame-sharded array onto every
    shard (reference: mpi/ops.py:169 distribute_frame, a Bcast from the
    owner rank). Implemented as owner-masked dynamic-slice + psum."""
    n_local = data_local.shape[0]
    start, stop = local_shard_bounds(n_local, axis)
    owned = (global_index >= start) & (global_index < stop)
    local_idx = jnp.clip(global_index - start, 0, n_local - 1)
    row = jax.lax.dynamic_index_in_dim(data_local, local_idx, axis=0,
                                       keepdims=False)
    # preserve the caller's dtype (the reference's Bcast is
    # dtype-preserving; an earlier float32 cast silently corrupted
    # integer rows and rounded fp64 coordinates)
    contrib = jnp.where(owned, row, jnp.zeros_like(row))
    return jax.lax.psum(contrib, axis)


# ---------------------------------------------------------------------
# host-level striped compat (reference mpi/ops.py API, process-striped)
# ---------------------------------------------------------------------

from .io import _process_info as _proc_info  # shared rank/size helper


def _allgather_obj(obj):
    """Gather a numpy array (possibly different length per process)
    from every process. Each stripe's FULL metadata (shape + dtype) is
    agreed first, then each process's stripe is broadcast in turn —
    the analogue of the reference's round-robin bcast loop
    (mpi/ops.py:74-75).

    Metadata must come from the OWNER, not from the local stripe: a
    process whose stripe is empty (e.g. fewer files than processes)
    holds a 1-D float64 ``np.array([])`` whose shape/dtype disagree
    with the owners' (k, d) float32 data, and mismatched avals across
    processes crash or deadlock the collective."""
    rank, size = _proc_info()
    obj = np.asarray(obj)
    # the metadata vector below has exactly 4 shape slots, so higher
    # ranks must fail loudly (on every process count, so the limit is
    # caught in single-process tests too) instead of silently
    # overwriting the dtype slot (ADVICE r4)
    if obj.ndim > 4:
        raise ValueError(
            '_allgather_obj supports arrays of ndim <= 4, got ndim=%d'
            % obj.ndim)
    if size == 1:
        return [obj]
    from jax.experimental import multihost_utils

    # per-process metadata vector: [ndim, dim0..dim3, kind, itemsize]
    # (dtype travels as (kind char, itemsize) — numpy 2 has no public
    # num->dtype constructor)
    meta = np.zeros(7, dtype=np.int64)
    meta[0] = obj.ndim
    meta[1:1 + obj.ndim] = obj.shape
    meta[5] = ord(obj.dtype.kind)
    meta[6] = obj.dtype.itemsize
    metas = multihost_utils.process_allgather(meta)

    out = []
    for r in range(size):
        ndim = int(metas[r][0])
        shape = tuple(int(d) for d in metas[r][1:1 + ndim])
        kind = chr(int(metas[r][5]))
        # sizeless kinds: np.dtype('?1') is invalid — bool rebuilds
        # from the bare kind char (ADVICE r4)
        dtype = (np.dtype(kind) if kind == '?' else
                 np.dtype('%s%d' % (kind, int(metas[r][6]))))
        send = obj if r == rank else np.zeros(shape, dtype)
        out.append(multihost_utils.broadcast_one_to_all(
            send, is_source=(r == rank)))
    return out


def striped_array_max(local_array):
    """Global max of a process-striped array (reference:
    mpi/ops.py:128)."""
    _, size = _proc_info()
    local_max = np.max(local_array)
    if size == 1:
        return local_max
    from jax.experimental import multihost_utils
    return float(multihost_utils.process_allgather(
        np.asarray(local_max)).max())


def striped_array_mean(local_array):
    """Global mean of a process-striped array: sums and counts are
    reduced separately, then divided (reference: mpi/ops.py:143)."""
    _, size = _proc_info()
    local_sum = np.sum(local_array)
    local_len = len(local_array)
    if size == 1:
        return local_sum / local_len
    from jax.experimental import multihost_utils
    sums = multihost_utils.process_allgather(np.asarray(local_sum))
    lens = multihost_utils.process_allgather(np.asarray(local_len))
    return float(sums.sum() / lens.sum())


def assemble_striped_array(local_arr):
    """Assemble a striped array (element i lives on process i % size;
    reference: mpi/ops.py:42). Single-process: the identity."""
    rank, size = _proc_info()
    if size == 1:
        return local_arr
    stripes = _allgather_obj(local_arr)
    total = sum(len(s) for s in stripes)
    # output shape/dtype from an OWNER stripe, not the local one: a
    # process whose stripe is empty holds a 1-D float64 np.array([])
    # whose trailing dims/dtype disagree with the owners' data, which
    # would crash (or dtype-diverge) that process alone (r5 review)
    proto = next((np.asarray(s) for s in stripes if len(s)),
                 np.asarray(local_arr))
    out = np.zeros((total,) + proto.shape[1:], dtype=proto.dtype)
    for r, stripe in enumerate(stripes):
        if len(stripe):
            out[r::size] = stripe
    return out


def assemble_striped_ragged_array(local_array, global_lengths):
    """Assemble a ragged array whose ROWS are striped across processes
    (row i on process i % size), given every row's global length
    (reference: mpi/ops.py:82). Returns the flat concatenated data."""
    from .. import ra as ra_mod

    rank, size = _proc_info()
    global_lengths = np.asarray(global_lengths)
    if size == 1:
        return np.asarray(local_array)

    out = ra_mod.RaggedArray(
        np.zeros(int(global_lengths.sum())) - 1, lengths=global_lengths)
    stripes = _allgather_obj(local_array)
    for r, stripe in enumerate(stripes):
        rows = ra_mod.RaggedArray(stripe,
                                  lengths=global_lengths[r::size])
        out[r::size] = rows
    # result dtype from an OWNER stripe so empty-stripe processes
    # return the same dtype as everyone else (r5 review)
    proto = next((np.asarray(s) for s in stripes if len(s)),
                 np.asarray(local_array))
    return out._data.astype(proto.dtype)


def convert_local_indices(local_ctr_inds, global_lengths):
    """Convert (owner_rank, local_frame) pairs to global frame indices
    given the global per-trajectory lengths (reference:
    mpi/ops.py:14). Pure index math, no communication."""
    from .. import ra as ra_mod

    _, size = _proc_info()
    global_lengths = np.asarray(global_lengths)
    origin = ra_mod.RaggedArray(
        np.arange(int(global_lengths.sum())), lengths=global_lengths)

    out = []
    for rank, local_fid in local_ctr_inds:
        out.append(origin[int(rank)::size].flatten()[int(local_fid)])
    return out


def randind(local_array, random_state=None):
    """Uniform random element of a process-striped array, returned as
    ``(owner_rank, local_index)`` (reference: mpi/ops.py:215). The
    index is drawn on process 0 and broadcast, so all processes agree.
    """
    from ..util.rng import check_random_state

    from .. import ra as ra_mod
    from ..exception import DataInvalid

    rank, size = _proc_info()
    random_state = check_random_state(random_state)

    if size == 1:
        n = len(local_array)
        if n < 1:
            raise DataInvalid('Random choice requires a non-empty '
                              'array.')
        return (0, random_state.randint(n))

    from jax.experimental import multihost_utils
    n_states = multihost_utils.process_allgather(
        np.asarray(len(local_array)))
    if n_states.sum() < 1:
        raise DataInvalid('Random choice requires a non-empty array. '
                          'Got shapes: %s' % n_states)
    global_index = multihost_utils.broadcast_one_to_all(
        np.asarray(random_state.randint(int(n_states.sum()))))

    concat = np.concatenate(
        [np.arange(int(n_states.sum()))[r::size] for r in range(size)])
    owners = ra_mod.RaggedArray(concat, lengths=list(n_states))
    owner_rank, local_index = ra_mod.where(owners == int(global_index))
    return (int(owner_rank[0]), int(local_index[0]))
