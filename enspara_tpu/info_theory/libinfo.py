"""Joint-count histogram kernels — the CARDS hot loop.

Device replacement of the reference's Cython+OpenMP histograms
(enspara/info_theory/libinfo.pyx:30,50): the 4-D joint-count tensor
``jc[f1, f2, s1, s2]`` is computed as ONE one-hot matmul per time chunk,

    jc = (onehot(a) over (T, Fa*n_a)).T @ (onehot(b) over (T, Fb*n_b))

so the O(Fa*Fb*T) accumulation is a matrix product instead of an OpenMP loop.
(The formulation is the one the reference itself uses for weighted MI,
mutual_info.py:149-153.) Counts are accumulated chunk-wise in fp32
(exact below 2^24 per chunk) and summed into int64 on the host, lifting
the reference's 2^32-timepoint cap (libinfo.pyx:56).
"""

import numpy as np

__all__ = ['bincount2d', 'matrix_bincount2d', 'matrix_bincount2d_np']

_CHUNK_T = 1 << 22  # 4M timepoints per device chunk (fp32-exact counts)
_MAX_DEVICE_T = 1 << 31  # the device accumulator is int32


def bincount2d(a, b, n_a, n_b):
    """2-D histogram of paired integer sequences.
    (reference: libinfo.pyx:30)"""
    a = np.asarray(a).reshape(-1)
    b = np.asarray(b).reshape(-1)
    assert a.shape[0] == b.shape[0]
    H = np.bincount(a.astype(np.int64) * n_b + b.astype(np.int64),
                    minlength=n_a * n_b)
    return H.reshape(n_a, n_b).astype(np.uint32)


def matrix_bincount2d(a, b, n_a, n_b, mesh=None):
    """All-feature-pairs joint counts:
    ``jc[fa, fb, i, j] = #{t : a[t, fa] == i and b[t, fb] == j}``.
    (reference: libinfo.pyx:50)

    With ``mesh`` (a 1-D ``jax.sharding.Mesh``), each chunk's time axis
    is sharded across the mesh: the one-hot matmul contracts over the
    sharded axis, so GSPMD lowers it to per-chip partial products plus
    one psum across devices — the multi-device form of the reference's
    MPI-pooled feature loops (info_theory/mutual_info.py pools).

    Returns an (Fa, Fb, n_a, n_b) uint32 (int64 if counts overflow).
    """
    try:
        import jax
        is_dev = isinstance(a, jax.Array) or isinstance(b, jax.Array)
    except ImportError:
        is_dev = False
    if not is_dev:
        # host arrays stay host arrays; device arrays are NOT pulled
        # back (the one-hot matmul consumes them in place)
        a = np.asarray(a)
        b = np.asarray(b)
    assert a.shape[0] == b.shape[0], \
        'Feature arrays a and b must match in length'
    assert a.max() < n_a, 'States indices must be contiguous.'
    assert b.max() < n_b, 'States indices must be contiguous.'
    # negative labels (e.g. -1 unassigned sentinels) would be DROPPED
    # silently by the one-hot path (undercounted joint counts) while
    # the host loop crashes — fail loudly on both instead
    assert a.min() >= 0 and b.min() >= 0, \
        'State indices must be non-negative (mask or trim unassigned '\
        'frames before joint counting).'

    # a device failure propagates; only a time axis too long for the
    # device's int32 accumulator takes the host bincount loop
    if a.shape[0] >= _MAX_DEVICE_T:
        jc = matrix_bincount2d_np(np.asarray(a), np.asarray(b),
                                  int(n_a), int(n_b))
    else:
        jc = _matrix_bincount2d_device(a, b, int(n_a), int(n_b),
                                       mesh=mesh)

    if jc.max() < 2 ** 32:
        return jc.astype(np.uint32)
    return jc


def _chunk_counts_impl(ac, bc, n_a, n_b):
    # one-hot values are exactly 0.0/1.0 in bf16 and the product
    # accumulates in fp32 (exact for chunk counts < 2^24), so bf16
    # inputs give exact integer counts in one pass at half the memory
    # traffic of fp32 operands. No precision argument is needed: 0/1
    # operands are exact in every matmul mode, TF32 included. Out-of-range states
    # (the mesh path's padding) one-hot to all-zero rows and
    # contribute nothing.
    import jax
    import jax.numpy as jnp

    Fa, Fb = ac.shape[1], bc.shape[1]
    A = jax.nn.one_hot(ac, n_a, dtype=jnp.bfloat16)  # (t, Fa, n_a)
    B = jax.nn.one_hot(bc, n_b, dtype=jnp.bfloat16)  # (t, Fb, n_b)
    A2 = A.reshape(ac.shape[0], Fa * n_a)
    B2 = B.reshape(bc.shape[0], Fb * n_b)
    M = jnp.dot(A2.T, B2, preferred_element_type=jnp.float32)
    return M.reshape(Fa, n_a, Fb, n_b).transpose(0, 2, 1, 3) \
        .astype(jnp.int32)


_CHUNK_COUNTS_JIT = None


def _chunk_counts_jit():
    """Module-cached jit (static state counts): repeated calls — the
    four CARDS matrices, per-trajectory chunks — reuse one traced
    executable per shape instead of re-tracing a fresh closure."""
    global _CHUNK_COUNTS_JIT
    if _CHUNK_COUNTS_JIT is None:
        import jax
        _CHUNK_COUNTS_JIT = jax.jit(_chunk_counts_impl,
                                    static_argnames=('n_a', 'n_b'))
    return _CHUNK_COUNTS_JIT


def _matrix_bincount2d_device(a, b, n_a, n_b, mesh=None):
    import jax

    T, Fa = a.shape
    Fb = b.shape[1]
    if T >= _MAX_DEVICE_T:
        raise OverflowError('int32 device accumulator would overflow')

    chunk_counts = _chunk_counts_jit()

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        axis = mesh.axis_names[0]
        n_dev = int(np.prod(mesh.devices.shape))
        sharded = NamedSharding(mesh, PartitionSpec(axis))

    # accumulate on device (one host pull at the end, not per chunk)
    total = None
    for start in range(0, T, _CHUNK_T):
        ac = a[start:start + _CHUNK_T]
        bc = b[start:start + _CHUNK_T]
        if mesh is not None:
            ac, bc = np.asarray(ac), np.asarray(bc)
            pad = (-ac.shape[0]) % n_dev
            if pad:
                # out-of-range pad states one-hot to zero rows; upcast
                # first so the sentinel can't wrap in a saturated label
                # dtype (e.g. uint8 with n_a=256 would alias state 0)
                def _fits(dt, n):
                    return (np.issubdtype(dt, np.integer)
                            and np.iinfo(dt).max >= n)
                if not _fits(ac.dtype, n_a):
                    ac = ac.astype(np.int32)   # incl. bool labels
                if not _fits(bc.dtype, n_b):
                    bc = bc.astype(np.int32)
                ac = np.concatenate(
                    [ac, np.full((pad, Fa), n_a, dtype=ac.dtype)])
                bc = np.concatenate(
                    [bc, np.full((pad, Fb), n_b, dtype=bc.dtype)])
            ac = jax.device_put(ac, sharded)
            bc = jax.device_put(bc, sharded)
        c = chunk_counts(ac, bc, n_a=n_a, n_b=n_b)
        total = c if total is None else total + c
    return np.asarray(total).astype(np.int64)


def matrix_bincount2d_np(a, b, n_a, n_b):
    """Host path: per-feature-pair flat bincount (the test oracle, and
    time axes too long for the device accumulator)."""
    T, Fa = a.shape
    Fb = b.shape[1]
    jc = np.zeros((Fa, Fb, n_a, n_b), dtype=np.int64)
    a64 = a.astype(np.int64)
    b64 = b.astype(np.int64)
    for fa in range(Fa):
        base = a64[:, fa] * n_b
        for fb in range(Fb):
            h = np.bincount(base + b64[:, fb], minlength=n_a * n_b)
            jc[fa, fb] = h.reshape(n_a, n_b)
    return jc
