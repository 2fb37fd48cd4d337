"""Device mesh management — the replacement for the reference's MPI
world (enspara/mpi/__init__.py:6-40).

The reference stripes frames/files over MPI ranks; here the frame axis of
every device array shards over a 1-D ``jax.sharding.Mesh`` named
``'frames'``. A 1-device mesh behaves exactly like the reference's
DummyComm single-rank fallback: all library code is written against the
mesh and degrades to serial with zero code change.

Multi-host jobs: call :func:`initialize_distributed` first (wraps
``jax.distributed.initialize``), then the mesh spans all hosts' devices
and XLA emits the collectives over the interconnect. The mesh is a flat
1-D axis; nothing assumes a particular topology.
"""

import functools
import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

FRAME_AXIS = 'frames'

__all__ = ['FRAME_AXIS', 'frame_mesh', 'n_devices', 'pad_to_multiple',
           'shard_frames', 'replicated', 'initialize_distributed',
           'install_abort_excepthook', 'P', 'Mesh', 'NamedSharding']


def initialize_distributed(**kwargs):
    """Multi-host bootstrap (jax.distributed.initialize). No-op if
    already initialized. Also installs the abort excepthook so a
    crash on one host kills the whole job (see
    :func:`install_abort_excepthook`).

    A *failed* bootstrap (unreachable coordinator, inconsistent
    process_id/num_processes) raises: swallowing it would leave every
    process believing it is rank 0 of a single-host world, and N
    processes would then race to write the same output files."""
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        # benign double-init only; anything else is a real failure
        if 'already' not in str(e) and 'once' not in str(e):
            raise
    install_abort_excepthook()


def install_abort_excepthook():
    """Make an uncaught exception on one process terminate the whole
    multi-host job instead of deadlocking the others inside a
    collective.

    The reference installs ``mpiabort_excepthook`` (enspara/mpi/
    util.py:35, calling ``comm.Abort()``) for exactly this failure
    mode. With jax.distributed the equivalent is to shut down the
    distributed client (unblocking the coordinator's barrier logic)
    and hard-exit; surviving hosts then fail their next collective
    promptly rather than hanging. No-op on single-process runs.
    """
    import sys

    if jax.process_count() <= 1:
        return

    original = sys.excepthook

    def _abort_hook(exc_type, value, tb):
        original(exc_type, value, tb)
        try:
            jax.distributed.shutdown()
        except Exception:
            pass
        os._exit(1)

    sys.excepthook = _abort_hook


def n_devices():
    return len(jax.devices())


@functools.lru_cache(maxsize=None)
def _cached_mesh(n):
    devs = np.array(jax.devices()[:n])
    return Mesh(devs, (FRAME_AXIS,))


def frame_mesh(n=None):
    """A 1-D mesh over ``n`` devices (default: all) with axis 'frames'."""
    return _cached_mesh(n or n_devices())


def pad_to_multiple(n, m):
    """Smallest multiple of ``m`` that is >= ``n``."""
    return ((n + m - 1) // m) * m


def host_fetch(x):
    """Materialize a (possibly multi-process global) jax array on the
    host of EVERY process.

    Single-process (or fully addressable) arrays fetch directly. In a
    ``jax.distributed`` job, arrays sharded over a global mesh have
    non-addressable shards, so the fetch is a ``process_allgather``
    across hosts — the analog of the reference's
    ``assemble_striped_array`` round-robin bcast (mpi/ops.py:42).
    Fully-replicated global arrays read their local shard, no
    communication.
    """
    if not isinstance(x, jax.Array) or x.is_fully_addressable:
        return np.asarray(x)
    if x.sharding.is_fully_replicated:
        return np.asarray(x.addressable_data(0))
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def shard_frames(arr, mesh=None, pad_value=0):
    """Pad the leading axis to a multiple of the mesh size and place the
    array sharded over the 'frames' axis.

    Returns ``(sharded_array, n_valid)``.
    """
    import jax.numpy as jnp

    if mesh is None:
        mesh = frame_mesh()
    d = mesh.shape[FRAME_AXIS]
    sharding = NamedSharding(mesh, P(FRAME_AXIS))

    n = arr.shape[0]
    n_pad = pad_to_multiple(max(n, d), d)

    if isinstance(arr, jax.Array):
        # already on device: pad/reshard with device ops, never via host
        if n_pad != n:
            pad_width = [(0, n_pad - n)] + [(0, 0)] * (arr.ndim - 1)
            arr = jnp.pad(arr, pad_width, constant_values=pad_value)
        return jax.device_put(arr, sharding), n

    arr = np.asarray(arr)
    if n_pad != n:
        pad = np.full((n_pad - n,) + arr.shape[1:], pad_value,
                      dtype=arr.dtype)
        arr = np.concatenate([arr, pad])
    return jax.device_put(arr, sharding), n


def replicated(arr, mesh=None):
    if mesh is None:
        mesh = frame_mesh()
    if not isinstance(arr, jax.Array):
        arr = np.asarray(arr)
    return jax.device_put(arr, NamedSharding(mesh, P()))
