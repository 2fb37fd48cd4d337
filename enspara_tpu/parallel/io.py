"""Striped data loading across hosts.
(reference: enspara/mpi/io.py — rank i loads file/table i % size)

Under JAX's single-controller model one process drives all local
devices, so "striping" applies at the multi-host level: process i loads
files i % n_processes (process-level data parallelism), and device-level
sharding happens when arrays are placed with
:func:`enspara_tpu.parallel.mesh.shard_frames`. On a single host these
functions load everything, matching the reference's 1-rank behavior.
"""

import numpy as np

from .. import ra as ra_mod
from ..exception import DataInvalid

__all__ = ['load_h5_as_striped', 'load_npy_as_striped',
           'load_trajectory_as_striped', 'striped_range']


def _process_info():
    import jax
    try:
        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


def striped_range(n_items):
    """Indices of items owned by this process (i % n_processes
    striping, matching mpi/io.py:16)."""
    rank, size = _process_info()
    return list(range(rank, n_items, size))


def load_h5_as_striped(filename, stride=1):
    """Load this process's stripe of rows from a RaggedArray h5 file.
    (reference: mpi/io.py:16)

    Returns (global_lengths, local_data_concatenated).
    """
    import h5py

    with h5py.File(filename, 'r') as f:
        keys = sorted(k for k in f.keys() if k not in ('array',
                                                       'lengths'))
        if not keys:
            raise DataInvalid('No ragged-array keys in %s' % filename)
        shapes = [f[k].shape for k in keys]
        global_lengths = [(s[0] + stride - 1) // stride for s in shapes]
        own = striped_range(len(keys))
        rows = [f[keys[i]][::stride] for i in own]

    local = np.concatenate(rows) if rows else np.array([])
    return global_lengths, local


def load_npy_as_striped(filenames, stride=1):
    """Stripe .npy feature files across processes.
    (reference: mpi/io.py:74)"""
    filenames = list(filenames)
    shapes = []
    for fn in filenames:
        arr = np.load(fn, mmap_mode='r')
        shapes.append(arr.shape)
    inner = set(s[1:] for s in shapes)
    if len(inner) > 1:
        raise DataInvalid('Feature files disagree on inner shape: %s'
                          % inner)
    global_lengths = [(s[0] + stride - 1) // stride for s in shapes]
    own = striped_range(len(filenames))
    # strided reads go through the mmap so only the kept rows are
    # materialized (a full np.load of a 20 GB file to keep 1/stride
    # of it would page the whole file through RAM)
    rows = [np.asarray(np.load(filenames[i], mmap_mode='r')[::stride])
            for i in own]
    local = np.concatenate(rows) if rows else np.array([])
    return global_lengths, local


def load_trajectory_as_striped(filenames, args=None, processes=None):
    """Stripe trajectory files across processes; per-file load kwargs
    supported like the reference (mpi/io.py:142)."""
    from ..util.load import load_as_concatenated, sound_trajectory

    filenames = list(filenames)
    if args is None:
        args = [{}] * len(filenames)

    # global lengths must be known everywhere
    global_lengths = [
        sound_trajectory(fn, stride=a.get('stride', 1) or 1)
        for fn, a in zip(filenames, args)]

    own = striped_range(len(filenames))
    local_files = [filenames[i] for i in own]
    local_args = [args[i] for i in own]
    if not local_files:
        return global_lengths, np.array([])
    _, xyz = load_as_concatenated(local_files, args=local_args,
                                  processes=processes)
    return global_lengths, xyz
