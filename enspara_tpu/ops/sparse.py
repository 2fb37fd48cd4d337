"""Sparse device operands: dense materialization and ELL SpMM.

Device linear algebra (LU, eigh) wants dense operands in device
memory, but shipping a host-densified matrix through PCIe moves n^2
mostly-zero bytes. Scattering the COO triplets on
device moves O(nnz) instead — a 10k-state MSM uploads <1 MB rather
than 400 MB.

For ITERATED sparse products past the densification cap (LOBPCG,
power/filter iterations), generic COO/BCOO matmul lowers to
scatter-adds — the slowest memory op on the device. ELL format turns the
same product into ``w`` fixed-width row GATHERS of the dense operand
(``Y = sum_j vals[:, j, None] * X[cols[:, j]]``), each a
streaming ``(n, k)`` read with no data-dependent writes; padding
rows to the max width costs only zero-multiplies. MSM graphs are
near-regular (metastable states couple to O(1) neighbors), so the
pad waste is small; callers should fall back to BCOO when
``w_max >> mean nnz/row`` (hub-dominated graphs).
"""

import functools

import numpy as np

__all__ = ['dense_on_device', 'ell_from_sparse', 'ell_spmm']


@functools.lru_cache(maxsize=32)
def _scatter_fn(n, m):
    """Shape-keyed cached jitted scatter: a fresh ``@jax.jit`` closure
    per call would re-trace (and round-trip the compile cache) on
    EVERY materialization — repeated solves over the same MSM (the
    committors → mfpts → fluxes pattern) must reuse one executable.
    Bounded at 32 shapes so a long-lived process materializing many
    differently-sized matrices can't pin XLA executables without
    limit."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def scatter(rows, cols, v):
        return jnp.zeros((n, m), jnp.float32).at[rows, cols].set(v)

    return scatter


def dense_on_device(sp, scale_rows=None, scale_cols=None):
    """Materialize ``sp`` (scipy sparse) dense fp32 in device memory from its
    COO triplets. Optional per-row / per-column scaling vectors are
    applied to the values on host (O(nnz)) before the scatter — this
    computes D_r @ sp @ D_c without ever forming a dense host array.
    """
    import jax.numpy as jnp

    coo = sp.tocoo()
    coo.sum_duplicates()                # .set() needs unique indices
    n, m = coo.shape

    vals = coo.data.astype(np.float64)
    if scale_rows is not None:
        vals = vals * np.asarray(scale_rows, np.float64)[coo.row]
    if scale_cols is not None:
        vals = vals * np.asarray(scale_cols, np.float64)[coo.col]

    scatter = _scatter_fn(n, m)
    return scatter(jnp.asarray(coo.row), jnp.asarray(coo.col),
                   jnp.asarray(vals.astype(np.float32)))


def round_up(x, q):
    """Smallest multiple of ``q`` >= ``x`` (shared shape/bucket
    helper for the ELL kernels and the filtered eigensolver)."""
    return int(-(-x // q) * q)


def ell_from_sparse(sp, dtype=np.float32):
    """Convert scipy sparse ``sp`` to padded ELL arrays
    ``(cols (n, w) int32, vals (n, w) dtype)`` with ``w`` the max
    row occupancy. Pad slots carry the row's own index with value 0,
    so gathers stay in-bounds and contribute nothing.
    """
    csr = sp.tocsr()
    csr.sum_duplicates()
    n = csr.shape[0]
    nnz_row = np.diff(csr.indptr)
    w = int(nnz_row.max()) if n else 0

    cols = np.repeat(np.arange(n, dtype=np.int32)[:, None], w, axis=1)
    vals = np.zeros((n, w), dtype=dtype)
    rows = np.repeat(np.arange(n), nnz_row)
    pos = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], nnz_row)
    cols[rows, pos] = csr.indices
    vals[rows, pos] = csr.data
    return cols, vals


@functools.lru_cache(maxsize=16)
def _ell_spmm_fn(n, w, k, shift):
    """Cached jitted ELL SpMM ``Y = A @ X (+ shift * X)``: ``w``
    (n, k) row-gathers with fused multiply-accumulate — no scatters,
    memory traffic ~ w*n*k reads, and never an (n, w, k) intermediate.
    Unrolled below 32 columns (lets XLA pipeline the gathers); a
    ``fori_loop`` above that bounds program size for wide rows. Same
    executable-reuse rationale as :func:`_scatter_fn`."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    @jax.jit
    def spmm(cols, vals, X):
        Y0 = shift * X if shift else jnp.zeros_like(X)
        if w <= 32:
            Y = Y0
            for j in range(w):
                Y = Y + vals[:, j, None] * jnp.take(X, cols[:, j],
                                                    axis=0)
            return Y

        def body(j, Y):
            c = lax.dynamic_index_in_dim(cols, j, 1, keepdims=False)
            v = lax.dynamic_index_in_dim(vals, j, 1, keepdims=False)
            return Y + v[:, None] * jnp.take(X, c, axis=0)

        return lax.fori_loop(0, w, body, Y0)

    return spmm


def ell_spmm(cols, vals, X, shift=0.0):
    """``A @ X + shift * X`` with A in ELL form (see
    :func:`ell_from_sparse`); X is (n, k) on device."""
    n, w = cols.shape
    return _ell_spmm_fn(n, w, int(X.shape[1]), float(shift))(
        cols, vals, X)
