"""On-device eigensolves for reversible transition matrices.

A reversible T (detailed balance against pi, as produced by the
``transpose`` and ``mle`` builders) is similar to the symmetric matrix
``S = D^{1/2} T D^{-1/2}`` with ``D = diag(pi)``, so its spectrum is
real and computable with the device's symmetric eigensolver
(``jnp.linalg.eigh``); for large sparse problems LOBPCG iterates only
matvecs. Left eigenvectors of T recover as ``phi_i = D^{1/2} u_i``.

This replaces the scipy dense/ARPACK path
(enspara/msm/transition_matrices.py:173) on the device for the top-k
implied-timescales workload (BASELINE.md: 'eigsolve seconds for top-20
timescales').
"""

import functools
import os

import numpy as np
import scipy.sparse
import scipy.sparse.linalg  # bind the submodule explicitly (eigsh below)

from ..util.backend import on_accelerator
from .transition_matrices import eigenspectrum as _eigenspectrum_host

__all__ = ['eigenspectrum_reversible', 'implied_timescales_device',
           'implied_timescales_batched', 'bucketed_ell_shape']


from ..ops.sparse import round_up as _bucket  # noqa: E402


def bucketed_ell_shape(n, w):
    """The padded (n_pad, w_pad) ELL shape the filtered solver
    compiles for an n-state matrix of max row occupancy ``w``.

    Matching shapes are NECESSARY for two datasets to share a
    compiled program (and persistent-cache entry); sharing also
    requires the same requested mode count (k_block), the same
    ELL-vs-BCOO form, and the same ``ENSPARA_TPU_EIG_ORTH`` setting —
    all equal in the common case of repeated same-k production
    solves, which is what this identity is used to check."""
    quantum = max(256, 1 << max(max(n - 1, 1).bit_length() - 4, 0))
    return _bucket(max(n, 1), quantum), _bucket(max(w, 1), 8)


def eigenspectrum_reversible(T, pi=None, n_eigs=None, method='auto',
                             tol=1e-9, max_refine=30,
                             return_info=False):
    """Top eigenvalues/left-eigenvectors of a reversible T.

    Parameters
    ----------
    T : (n, n) row-stochastic reversible matrix (dense or scipy sparse).
    pi : (n,) stationary distribution. If None, computed from the
        symmetrization identity pi_i T_ij = pi_j T_ji via row sums of
        the counts-like matrix (falls back to host eigs).
    n_eigs : number of leading eigenpairs (default: all).
    method : 'auto' | 'eigh' | 'arpack' | 'filtered' ('lobpcg' is a
        back-compat alias for 'filtered'). 'auto' picks the dense
        device eigh while n^2 fits device memory; past that, sparse k << n
        spectra go to the device Chebyshev-filtered subspace solver
        when an accelerator backend is present, and to host ARPACK
        Lanczos on CPU-only hosts (where scipy's fp64 SpMV beats an
        fp32 emulated-device filter).
    tol : residual bound ``||S u - w u||_2`` per requested mode for the
        filtered path (S has unit spectral radius, so this is already
        relative). Modes that do not reach ``tol`` after ``max_refine``
        host refinement sweeps trigger an automatic fallback to the
        host ARPACK solve (the reference's engine,
        enspara/msm/transition_matrices.py:214-221).
    max_refine : refinement-sweep budget before the fallback fires.
    return_info : also return a dict with ``method``, ``residuals``
        (per returned mode), ``refine_sweeps`` and ``fallback``.

    Returns ``(vals, vecs)`` with vals sorted descending and
    ``vecs[:, 0]`` normalized to sum 1 (the equilibrium populations) —
    the same contract as ``eigenspectrum(..., left=True)``.
    """
    import jax.numpy as jnp

    sparse_in = scipy.sparse.issparse(T)
    n = T.shape[0]
    if n_eigs is None:
        n_eigs = n

    if pi is None:
        # without pi we cannot symmetrize; defer to the host solver
        out = _eigenspectrum_host(T, n_eigs=n_eigs, left=True)
        return out + ({'method': 'host', 'residuals': None,
                       'refine_sweeps': 0, 'fallback': False},) \
            if return_info else out

    pi = np.asarray(pi, dtype=np.float64).reshape(-1)
    if np.any(pi <= 0):
        # zero-population states break the similarity transform
        out = _eigenspectrum_host(T, n_eigs=n_eigs, left=True)
        return out + ({'method': 'host', 'residuals': None,
                       'refine_sweeps': 0, 'fallback': False},) \
            if return_info else out

    if method == 'lobpcg':
        method = 'filtered'             # back-compat alias

    if method == 'filtered':
        # the filter block must leave unwanted spectrum to damp; at
        # small n the dense device eigh is the better engine anyway
        k_guard = int(min(n - 1, n_eigs + max(8, n_eigs // 2)))
        if 5 * k_guard >= n:
            method = 'eigh'

    if method == 'auto':
        # Dense device eigh while n^2 fits device memory comfortably.
        # Past that, sparse k << n spectra go to the device
        # Chebyshev-filtered subspace solver (in-jit ELL SpMM sweeps +
        # host fp64 polish) on an accelerator, up to 131072 states,
        # the bound carried over from the first measurements and not
        # yet re-measured on a GPU. On CPU-only hosts the fp32
        # 'device' filter buys nothing over scipy's fp64 SpMV, so
        # ARPACK Lanczos (the reference's engine) keeps that regime.
        if sparse_in and 4096 < n <= 131_072 and n_eigs < n // 8 \
                and on_accelerator():
            method = 'filtered'
        elif sparse_in and n > 4096 and n_eigs < n // 8:
            method = 'arpack'
        else:
            method = 'eigh'

    sqrt_pi = np.sqrt(pi)
    info = {'method': method, 'residuals': None, 'refine_sweeps': 0,
            'fallback': False}

    if method == 'arpack':
        T_csr = T.tocsr() if sparse_in else scipy.sparse.csr_matrix(T)
        S = scipy.sparse.diags(sqrt_pi) @ T_csr @ \
            scipy.sparse.diags(1.0 / sqrt_pi)
        S = ((S + S.T) * 0.5).tocsr().astype(np.float64)
        if n_eigs >= n - 1:
            raise ValueError("method='arpack' needs n_eigs < n-1; "
                             "use method='eigh' for full spectra")
        w, u = scipy.sparse.linalg.eigsh(S, k=n_eigs, which='LA')
        order = np.argsort(-w)
        w, u = w[order], u[:, order]
        info['residuals'] = np.linalg.norm(S @ u - u * w[None, :],
                                           axis=0)
    elif method == 'eigh':
        if sparse_in:
            # the similarity transform D T D^-1 is value-local: scale
            # the COO triplets on host (O(nnz)) and scatter dense in
            # device memory — no host n^2 passes, no dense upload
            from ..ops.sparse import dense_on_device
            Sd = dense_on_device(T, scale_rows=sqrt_pi,
                                 scale_cols=1.0 / sqrt_pi)
            Sj = (Sd + Sd.T) * 0.5      # symmetrize on device
        else:
            S = (sqrt_pi[:, None] * np.asarray(T)) / sqrt_pi[None, :]
            # S should be symmetric for reversible T; enforce
            Sj = jnp.asarray((S + S.T) * 0.5, jnp.float32)
        w, u = jnp.linalg.eigh(Sj)
        # slice the wanted modes ON DEVICE before fetching: pulling the
        # full (n, n) eigenvector matrix over a slow host link costs
        # ~n/k more transfer than the k requested columns (at n=1000,
        # k=21 that was most of the measured eigsolve wall time)
        u = np.asarray(u[:, ::-1][:, :n_eigs], dtype=np.float64)
        w = np.asarray(w[::-1][:n_eigs], dtype=np.float64)
    else:
        T_csr = T.tocsr() if sparse_in else scipy.sparse.csr_matrix(T)
        S = scipy.sparse.diags(sqrt_pi) @ T_csr @ \
            scipy.sparse.diags(1.0 / sqrt_pi)
        S = ((S + S.T) * 0.5).tocsr()
        w, u, info = _lobpcg_refined(S, n_eigs, tol=tol,
                                     max_refine=max_refine)

    # left eigenvectors of T: phi_i = sqrt(pi) * u_i
    vecs = sqrt_pi[:, None] * u
    vecs[:, 0] /= vecs[:, 0].sum()
    if return_info:
        return w, vecs, info
    return w, vecs


@functools.lru_cache(maxsize=8)
def _transpose_tail_fn(n, k):
    """One jitted program for the dense transpose-builder MSM tail:
    counts -> C+C^T -> row-stochastic T -> pi -> pi-symmetrized eigh ->
    top-k eigenpairs, sliced ON DEVICE so only the k modes are ever
    fetched. fp32 throughout (the same engine precision as
    ``eigenspectrum_reversible(method='eigh')``)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def tail(counts):
        C = counts.astype(jnp.float32)
        sym = C + C.T
        row_mass = sym.sum(axis=1)
        pi = row_mass / row_mass.sum()
        # similarity transform of T = sym/row_mass under D = diag(sqrt
        # pi): S_ij = sqrt(pi_i) T_ij / sqrt(pi_j); symmetric for the
        # transpose builder by construction, re-symmetrized for fp.
        # Zero-count states (max_n_states padding) must divide safely:
        # their S row/col stays zero instead of NaN-poisoning eigh
        # (the same guard _batched_lags_impl carries)
        sq = jnp.sqrt(pi)
        inv_mass = jnp.where(row_mass > 0,
                             1.0 / jnp.where(row_mass > 0, row_mass,
                                             1.0), 0.0)
        inv_sq = jnp.where(sq > 0,
                           1.0 / jnp.where(sq > 0, sq, 1.0), 0.0)
        S = (sq[:, None] * (sym * inv_mass[:, None])) * inv_sq[None, :]
        w, u = jnp.linalg.eigh((S + S.T) * 0.5)
        w = w[::-1][:k]
        phi = sq[:, None] * u[:, ::-1][:, :k]
        # only the leading mode is rescaled (to unit mass = equilibrium
        # populations); the rest keep eigh's unit norm
        lead = phi[:, :1] / phi[:, :1].sum()
        return w, jnp.concatenate([lead, phi[:, 1:]], axis=1)

    return tail


def transpose_timescales_device(counts, n_eigs, lag_time=1):
    """Device-resident implied-timescales tail for the transpose
    builder: ``counts`` (host or device-resident, dense (n, n)) ->
    symmetrized row-stochastic T -> equilibrium pi -> top ``n_eigs``
    left eigenpairs -> implied timescales, computed as ONE jitted
    device program. Only the k modes come back to the host, instead
    of an 8 MB counts fetch, a host builder, a 4 MB upload of the
    symmetrized matrix and a 4 MB eigenvector fetch at n=1000.

    Returns ``(timescales, vals, left_vecs)`` with vals descending and
    ``left_vecs[:, 0]`` the equilibrium populations.
    (reference pipeline: enspara/msm/timescales.py:12 with
    builders.transpose + transition_matrices.py:173.)
    """
    import jax.numpy as jnp

    counts = jnp.asarray(counts)
    n = counts.shape[0]
    w, phi = _transpose_tail_fn(n, int(n_eigs))(counts)
    w = np.asarray(w, dtype=np.float64)
    phi = np.asarray(phi, dtype=np.float64)
    with np.errstate(divide='ignore', invalid='ignore'):
        timescales = -float(lag_time) / np.log(w[1:])
    return timescales, w, phi


@functools.lru_cache(maxsize=16)
def _filter_sweep_fn(n, w_ell, k, use_ell, use_qr=False):
    """One jitted filtered-subspace sweep, cached per shape: Chebyshev
    filter of traced degree on the unwanted interval ``[-1, b]``,
    shifted-CholeskyQR3 re-orthonormalization, and an on-device
    Rayleigh-Ritz with per-mode residual norms. Everything stays in
    fp32 device memory; only the (k,) Ritz values and residuals cross back to
    the host per sweep.

    CholeskyQR instead of Householder QR on BOTH axes of cost: at
    runtime it is GEMM-only (2 (n,k) gemms + one k x k Cholesky + a
    triangular solve per pass), and at compile time it lowers to a
    handful of ops where blocked Householder QR lowers to a large
    loopy program that dominated the cold compile. Three passes (first one
    shifted, Fukaya et al.-style) keep orthonormality at the fp32
    floor for block condition numbers up to ~1e6 — and the driver
    bounds the per-sweep filter amplification to about that. Set
    ``ENSPARA_TPU_EIG_ORTH=qr`` to get the old Householder program
    back for A/B (the flag is read by the driver and is part of this
    cache's key, so flipping it mid-process compiles the other
    variant instead of silently reusing this one)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from ..ops.sparse import ell_spmm

    # full fp32 products: a GPU would otherwise take TF32 (~3 digits),
    # above the filter's 5e-6 residual target
    mm = functools.partial(jnp.matmul, precision=lax.Precision.HIGHEST)

    def _orth(V):
        if use_qr:
            return jnp.linalg.qr(V)[0]
        eye = jnp.eye(V.shape[1], dtype=V.dtype)

        def chol_pass(V, shift):
            G = mm(V.T, V)
            if shift:
                G = G + (shift * jnp.trace(G) / V.shape[1]) * eye
            L = jnp.linalg.cholesky(G)
            return jax.scipy.linalg.solve_triangular(
                L, V.T, lower=True).T

        V = chol_pass(V, 1e-5)
        V = chol_pass(V, 0.0)
        return chol_pass(V, 0.0)

    @jax.jit
    def sweep(cols, vals, V, b, degree):
        if use_ell:
            def spmm(X):
                return ell_spmm(cols, vals, X)
        else:
            # BCOO operand rides `cols`. Like ell_spmm, a sparse product
            # is a gather and an fp32 multiply-add, with no TF32 to opt
            # out of (jnp.matmul does not take a BCOO operand)
            def spmm(X):
                return cols @ X
        e = (b + 1.0) * 0.5           # filter half-width
        c = (b - 1.0) * 0.5           # filter center
        Vp = V
        Vc = (spmm(V) - c * V) / e

        def body(_, carry):
            Vp, Vc = carry
            Vn = (2.0 / e) * (spmm(Vc) - c * Vc) - Vp
            return (Vc, Vn)

        _, Vc = lax.fori_loop(0, degree - 1, body, (Vp, Vc))
        Q = _orth(Vc)
        SQ = spmm(Q)
        H = mm(Q.T, SQ)
        w_r, Z = jnp.linalg.eigh((H + H.T) * 0.5)   # ascending
        w_r, Z = w_r[::-1], Z[:, ::-1]
        Vr = mm(Q, Z)
        res = jnp.linalg.norm(mm(SQ, Z) - Vr * w_r[None, :], axis=0)
        return Vr, w_r, res

    return sweep


def _filtered_subspace_device(S, n_eigs, tol=5e-6, max_sweeps=24):
    """Stage 1 of the sparse eigensolve: fp32 Chebyshev-filtered
    subspace iteration ON DEVICE (Zhou & Saad-style) down to the fp32
    residual floor. Returns the (n, k_block) fp64 host basis for the
    fp64 refinement stage, plus a telemetry dict.

    Device-first design: the O(sweeps * degree * nnz * k) filter work —
    99% of the flops — runs as ELL-form SpMMs (w row gathers, no
    scatters) chained inside ONE jitted sweep; QR and Rayleigh-Ritz
    also stay on device, so per sweep only 2k floats return to host.
    Near-degenerate clusters wider than the block (common for
    metastable MSMs: n_blocks eigenvalues within 1e-8 of 1) stall the
    filter by construction — the driver detects the stall and GROWS
    the block past the cluster instead of burning the sweep budget.
    """
    import jax.numpy as jnp

    from ..ops.sparse import ell_from_sparse

    n = S.shape[0]
    nnz_row = np.diff(S.indptr)
    w_max = int(nnz_row.max()) if n else 0
    use_ell = bool(w_max and
                   w_max <= max(32.0, 8.0 * float(nnz_row.mean())))

    if use_ell:
        cols_h, vals_h = ell_from_sparse(S, dtype=np.float32)
        # SHAPE BUCKETING: round (n, w) up so different datasets land
        # on the same compiled program (and the same persistent-cache
        # key). Padded rows self-index with zero values (the ELL pad
        # convention), and the random block is zeroed on padded rows,
        # so the padding is exactly invisible to the iteration: zero
        # rows of V stay zero through the filter, contribute nothing
        # to Gram/Ritz, and are sliced off before stage 2. The bucket
        # quantum scales with n (~n/16, power of two, >= 256) so
        # waste stays under ~6% while same-decade datasets collide.
        n_pad, w_pad = bucketed_ell_shape(
            n, int(cols_h.shape[1]))
        if (n_pad, w_pad) != cols_h.shape:
            cols_b = np.repeat(
                np.arange(n_pad, dtype=np.int32)[:, None], w_pad, 1)
            vals_b = np.zeros((n_pad, w_pad), dtype=np.float32)
            cols_b[:n, :cols_h.shape[1]] = cols_h
            vals_b[:n, :vals_h.shape[1]] = vals_h
            cols_h, vals_h = cols_b, vals_b
        cols_d, vals_d = jnp.asarray(cols_h), jnp.asarray(vals_h)
        w_ell = int(cols_d.shape[1])
    else:
        # hub-dominated graph: ELL padding would blow device memory; use BCOO
        from jax.experimental import sparse as jsparse
        cols_d = jsparse.BCOO.from_scipy_sparse(S.astype(np.float32))
        vals_d, w_ell = None, 0
        n_pad = n

    rng = np.random.default_rng(0)
    k_block = int(min(max(n // 6, 1), max(64, 2 * n_eigs + 16)))
    k_block = max(k_block, min(n_eigs + 4, n - 2))
    if n > 256:
        k_block = min(_bucket(k_block, 64), n - 2)   # bucket the block
    grow_left = 2

    def fresh(V_keep=None):
        # host-side GEMM-only orthonormalization (CholeskyQR2 in
        # fp64): called once per (re)start, and keeping it off-device
        # avoids compiling a QR program just for initialization
        extra = k_block - (0 if V_keep is None else V_keep.shape[1])
        Vr = rng.normal(size=(n_pad, extra))
        Vr[n:] = 0.0
        V = Vr if V_keep is None else np.concatenate(
            [np.asarray(V_keep, np.float64), Vr], axis=1)
        import scipy.linalg as _sla
        for _ in range(2):
            G = V.T @ V
            L = np.linalg.cholesky(
                G + (1e-12 * np.trace(G) / G.shape[0])
                * np.eye(G.shape[0]))
            V = _sla.solve_triangular(L, V.T, lower=True).T
        return jnp.asarray(V, jnp.float32)

    use_qr = os.environ.get('ENSPARA_TPU_EIG_ORTH') == 'qr'
    V = fresh()
    sweep = _filter_sweep_fn(n_pad, w_ell, k_block, use_ell, use_qr)
    # plain power step (degree 1, b=0) seeds the Ritz estimates
    V, w_r, res = sweep(cols_d, vals_d, V, jnp.float32(0.0),
                        jnp.int32(1))
    best, stall, sweeps, grew = np.inf, 0, 0, 0
    for _ in range(max_sweeps):
        w_h = np.asarray(w_r, np.float64)
        res_h = np.asarray(res, np.float64)
        if not (np.all(np.isfinite(w_h))
                and np.all(np.isfinite(res_h))):
            # a collapsed/overflowed fp32 block poisons everything
            # downstream (including the degree computation below);
            # hand what we have to stage 2 / the ARPACK fallback
            break
        cur = float(res_h[:n_eigs].max())
        if cur < tol:
            break
        stall = stall + 1 if cur > 0.7 * best else 0
        best = min(best, cur)
        if stall >= 2:
            if cur < 1e-3:
                # sitting on the fp32 rounding floor (residuals of
                # O(eps_f32 * sqrt(n)) are expected at 10^5 states):
                # the SUBSPACE is converged even though the fp32
                # certificate can't show it — growing the block here
                # only multiplies stage-2 cost. Hand off to fp64.
                break
            grown_k = int(min(2 * k_block, 512, n - 2))
            if grow_left and grown_k > k_block \
                    and 2 * k_block < max(n // 3, k_block + 1):
                # cluster wider than the block: double past it (the
                # grown_k > k_block guard matters for large n_eigs,
                # where the initial block already exceeds the 512 cap
                # and "growing" would otherwise SHRINK it, making
                # fresh()'s extra-column count negative)
                k_block = grown_k
                V = fresh(V)
                sweep = _filter_sweep_fn(n_pad, w_ell, k_block,
                                         use_ell, use_qr)
                grow_left -= 1
                grew += 1
                best, stall = np.inf, 0
                V, w_r, res = sweep(cols_d, vals_d, V,
                                    jnp.float32(0.0), jnp.int32(1))
                sweeps += 1
                continue
            break                       # gapless: stage 2 / ARPACK
        # filter cutoff: the smallest Ritz value in the block,
        # kept strictly below the wanted modes and above -1
        b = min(float(w_h[k_block - 1]),
                float(w_h[n_eigs - 1]) - 1e-7)
        b = float(np.clip(b, -1.0 + 1e-6, 1.0 - 1e-9))
        # degree bound keeps the fp32 filter from overflowing:
        # amplification at the top of the spectrum is
        # cosh(d * acosh(t(1))) with t(1) = (3 - b) / (1 + b).
        # CholeskyQR squares column norms in the Gram matrix, so its
        # per-sweep amplification budget is ~e^14 (~1e6, inside
        # CholQR3's fp32 conditioning range); Householder QR
        # tolerates the old e^70 target
        target = 70.0 if use_qr else 14.0
        t1 = (3.0 - b) / (1.0 + b)
        d = int(np.clip(target / max(np.arccosh(max(t1, 1.0)), 1e-3),
                        3, 16))
        V, w_r, res = sweep(cols_d, vals_d, V, jnp.float32(b),
                            jnp.int32(d))
        sweeps += 1

    # slice the padded rows off before the fp64 host stage
    return (np.asarray(V, dtype=np.float64)[:n],
            {'stage1_sweeps': sweeps, 'stage1_res':
             float(np.asarray(res)[:n_eigs].max()),
             'stage1_block': k_block, 'stage1_grown': grew,
             'stage1_n_padded': n_pad})


def _lobpcg_refined(S, n_eigs, tol=1e-9, max_refine=30):
    """Top-``n_eigs`` eigenpairs of a sparse symmetric S with spectrum
    in [-1, 1]: device fp32 Chebyshev-filtered subspace iteration for
    the bulk of the convergence (:func:`_filtered_subspace_device`),
    then Chebyshev-filtered fp64 subspace refinement on the host until
    every requested mode's residual ``||S u - w u||`` is below ``tol``
    — with an automatic host-ARPACK fallback if the budget runs out.

    Why this shape: fp32 stalls near residuals ~5e-6 (its rounding
    floor), and plain subspace iteration inherits eigenvalue
    clustering as a convergence ratio near 1. A degree-``d`` Chebyshev
    filter on the unwanted interval ``[-1, b]`` damps the unwanted
    spectrum by ~cosh(d*acosh(t(w_wanted))) per sweep — orders of
    magnitude even for tightly clustered spectra. The device does all
    the O(d * nnz * k) filtering and O(n * k^2) orthogonalization in
    fp32; the host buys the last 4-5 digits with a few fp64 sweeps of
    the same filter (fp64 is the slow path on the device, so the
    precision tail is the one part that belongs on the host).

    Returns ``(w, u, info)`` with w descending, u column-orthonormal.
    """
    import time as _time

    n = S.shape[0]

    # --- stage 1: device fp32 filtered subspace iteration. A device or
    # compile error propagates. A block that the fp32 filter drove to
    # non-finite values is a numerical breakdown, not a device fault:
    # it hands the problem to the reference's ARPACK engine and says so
    # in the returned info (fallback=True).
    t0 = _time.perf_counter()
    V, s1 = _filtered_subspace_device(S, n_eigs)
    if not np.all(np.isfinite(V)):
        # the function-level `import scipy.linalg` below makes `scipy`
        # a local, so bind the solver explicitly here
        import scipy.sparse.linalg as _ssl
        S64 = S.astype(np.float64)
        w, u = _ssl.eigsh(S64, k=n_eigs, which='LA')
        order = np.argsort(-w)
        w, u = w[order], u[:, order]
        res = np.linalg.norm(S64 @ u - u * w[None, :], axis=0)
        return w, u, {'method': 'filtered', 'residuals': res,
                      'refine_sweeps': 0, 'fallback': True, **s1}
    s1['stage1_s'] = round(_time.perf_counter() - t0, 3)
    k_guard = V.shape[1]

    # --- stage 2: host fp64 Chebyshev-filtered refinement.
    # GEMM-ONLY by design: on a 1-core host LAPACK's tall-skinny QR
    # runs ~200x below dgemm peak (measured 11.5 s for (1e5, 64)
    # dgeqrf vs 50 ms for the same-size V^T V), so orthonormalization
    # comes from the GENERALIZED Rayleigh-Ritz instead — eigh(H, G)
    # returns a G-orthonormal rotation Z, making V @ Z orthonormal
    # with nothing but matmuls.
    t0 = _time.perf_counter()
    import scipy.linalg

    S64 = S.astype(np.float64)
    V = np.asarray(V, dtype=np.float64)
    V /= np.linalg.norm(V, axis=0)

    def rayleigh_ritz(V, SV):
        G = V.T @ V
        H = V.T @ SV
        try:
            w_all, Z = scipy.linalg.eigh((H + H.T) * 0.5,
                                         (G + G.T) * 0.5)
        except (np.linalg.LinAlgError, scipy.linalg.LinAlgError):
            # numerically singular Gram matrix: a hard filter
            # (degree ~24 at low b amplifies ~1e16) can collapse the
            # unit-normalized block onto a few eigendirections; let
            # the ARPACK fallback below take over instead of crashing
            return None
        order = np.argsort(-w_all)
        w_all, Z = w_all[order], Z[:, order]
        Vr = V @ Z                     # orthonormal: Z^T G Z = I
        R = SV @ Z - Vr * w_all[None, :]
        return w_all, Vr, np.linalg.norm(R, axis=0)

    rr = rayleigh_ritz(V, S64 @ V)
    if rr is None:
        w_all, res = None, np.full(max(n_eigs, 1), np.inf)
        max_refine = 0                 # straight to the fallback
    else:
        w_all, V, res = rr
    sweeps = 0
    stalled = 0
    degree = 8
    for sweeps in range(1, max_refine + 1):
        if np.all(res[:n_eigs] < tol):
            break
        prev = float(res[:n_eigs].max())
        # filter interval [-1, b]: everything below the guard block's
        # smallest Ritz value is unwanted. Keep b strictly below the
        # wanted modes and strictly above -1.
        b = float(w_all[k_guard - 1])
        b = min(b, float(w_all[n_eigs - 1]) - 1e-12)
        b = max(b, -1.0 + 1e-12)
        e = (b - (-1.0)) / 2.0          # half-width
        c = (b + (-1.0)) / 2.0          # center
        # Chebyshev filter V_j+1 = 2/e (S - c) V_j - V_j-1, degree
        # chosen to finish in THIS sweep when the measured per-matvec
        # contraction says the target is within reach (each sweep also
        # pays ~4 (n, k) gemms — overshooting the degree slightly is
        # cheaper than an extra sweep)
        Vp = V
        Vc = (S64 @ V - c * V) / e
        for _ in range(degree - 1):
            Vn = (2.0 / e) * (S64 @ Vc - c * Vc) - Vp
            Vp, Vc = Vc, Vn
        # unit columns keep the generalized RR well conditioned (the
        # filter amplifies columns by wildly different factors)
        Vc /= np.linalg.norm(Vc, axis=0)
        rr = rayleigh_ritz(Vc, S64 @ Vc)
        if rr is None:
            break                      # keep last good V; fallback fires
        w_all, V, res = rr
        cur = float(res[:n_eigs].max())
        if tol < cur < prev:
            # per-matvec contraction this sweep -> degree that lands
            # the NEXT sweep at ~tol/3
            f = (cur / prev) ** (1.0 / (degree + 1))
            if f < 0.95:
                need = np.log(cur / (tol / 10.0)) / -np.log(f)
                degree = int(np.clip(np.ceil(need), 4, 24))
        # gapless (bulk) spectra stall: wanted and guard modes are
        # separated by O(1/n), so the filter can't amplify one over
        # the other — detect the stall and bail to ARPACK early
        # instead of burning the whole budget
        if float(res[:n_eigs].max()) > 0.5 * prev:
            stalled += 1
            if stalled >= 3:
                break
        else:
            stalled = 0
    else:
        sweeps = max_refine

    s1['stage2_s'] = round(_time.perf_counter() - t0, 3)

    if not np.all(res[:n_eigs] < tol):
        # pathological clustering: hand the problem to host ARPACK
        # (symmetric Lanczos), the reference's engine
        import logging
        logging.getLogger(__name__).warning(
            'device filtered subspace iteration + %d fp64 '
            'Chebyshev refinement sweeps left '
            'max residual %.2e > tol %.2e at n=%d; falling back to '
            'host ARPACK', sweeps, float(res[:n_eigs].max()), tol, n)
        w, u = scipy.sparse.linalg.eigsh(S64, k=n_eigs, which='LA',
                                         v0=V[:, 0].copy())
        order = np.argsort(-w)
        w, u = w[order], u[:, order]
        res = np.linalg.norm(S64 @ u - u * w[None, :], axis=0)
        return w, u, {'method': 'filtered', 'residuals': res,
                      'refine_sweeps': sweeps, 'fallback': True, **s1}

    return (w_all[:n_eigs], V[:, :n_eigs],
            {'method': 'filtered', 'residuals': res[:n_eigs],
             'refine_sweeps': sweeps, 'fallback': False, **s1})


def _counts_at_traced_lag(a, m, lag, n_states, sliding_window):
    """Masked lag-pair counts with the lag as a TRACED scalar: the end
    frame is produced by a roll instead of a static slice, so one
    compiled program serves every lag and the whole lag scan vmaps.
    Semantics match :func:`assigns_to_counts_device` on padded rows
    (pairs never cross rows or padding; -1 frames contribute nothing).
    """
    import jax.numpy as jnp

    L = a.shape[1]
    t = jnp.arange(L)
    end = jnp.roll(a, -lag, axis=1)
    m_end = jnp.roll(m, -lag, axis=1)
    valid = (m & m_end & (t[None, :] + lag < L)
             & (a >= 0) & (end >= 0))
    if not sliding_window:
        valid = valid & (t[None, :] % lag == 0)
    flat_idx = jnp.where(valid, a * n_states + end, n_states ** 2)
    counts = jnp.bincount(flat_idx.reshape(-1),
                          length=n_states ** 2 + 1)[:-1]
    return counts.reshape(n_states, n_states).astype(jnp.float32)


def implied_timescales_batched(assigns, lag_times, n_times=None,
                               sliding_window=True, prior_counts=None,
                               n_states=None, mesh=None):
    """Implied timescales for EVERY lag in one compiled device launch.

    The batched formulation of the reference's serial per-lag loop
    (enspara/msm/timescales.py:88-92): lag-pair counting vmaps over
    lags (the lag is traced, see :func:`_counts_at_traced_lag`), the
    transpose-builder algebra (``T = rownorm(C + C^T)``, eq from row
    sums — builders.py:83 semantics incl. the zero-row guard) is pure
    batched array math, and the reversible eigensolve runs as ONE
    batched symmetrized ``eigh`` over the (n_lags, n, n) stack. One
    dispatch replaces n_lags dependent chains of host round trips.

    Restrictions vs :func:`implied_timescales_device`: transpose
    builder only (MLE's Gauss-Seidel is host-sequential) and no
    ergodic trimming (SCC is a host graph algorithm whose output shape
    is lag-dependent). Gapped (-1) data follows the padded-counting
    semantics, not the reference's gap compaction.

    With ``mesh`` (a 1-D ``jax.sharding.Mesh``), the lag axis is
    sharded across the mesh and the assignments are replicated — each
    device runs its lag subset of the SAME batched program (GSPMD
    propagates the input sharding through the vmap), the multi-chip
    form of the reference's "embarrassingly parallel over lags" note
    (timescales.py:12-16).

    Returns (n_lags, n_times) float64, like ``implied_timescales``.
    """
    import jax
    import jax.numpy as jnp

    from ..ra import to_padded

    padded = to_padded(assigns)
    a = np.asarray(padded.data, dtype=np.int32)
    m = np.asarray(padded.mask, dtype=bool)

    if n_states is None:
        n_states = int(a[m].max()) + 1
    if n_times is None:
        n_times = int(np.floor(n_states / 10.0)) + 1
    if n_times > n_states - 1:
        n_times = n_states - 1
    lags = np.asarray(lag_times, dtype=np.int32)
    if (lags < 1).any():
        raise ValueError('lag times must be >= 1, got %s' % (lags,))
    prior = np.float32(0.0 if prior_counts is None else prior_counts)

    if mesh is None:
        out = _batched_lags_jit(
            jnp.asarray(a), jnp.asarray(m), jnp.asarray(lags),
            jnp.float32(prior), n_states, n_times,
            bool(sliding_window))
        return np.asarray(out, dtype=np.float64)

    from jax.sharding import NamedSharding, PartitionSpec

    axis = mesh.axis_names[0]
    n_dev = int(np.prod(mesh.devices.shape))
    n_lags = len(lags)
    pad = (-n_lags) % n_dev
    if pad:                     # pad with lag=1 so every shard is full
        lags = np.concatenate([lags, np.ones(pad, np.int32)])

    aj = jax.device_put(jnp.asarray(a), NamedSharding(
        mesh, PartitionSpec()))                       # replicated
    mj = jax.device_put(jnp.asarray(m), NamedSharding(
        mesh, PartitionSpec()))
    lj = jax.device_put(jnp.asarray(lags), NamedSharding(
        mesh, PartitionSpec(axis)))                   # lag-sharded
    out = _batched_lags_jit(aj, mj, lj, jnp.float32(prior), n_states,
                            n_times, bool(sliding_window))
    return np.asarray(out, dtype=np.float64)[:n_lags]


def _batched_lags_impl(aj, mj, lagsj, prior, n_states, n_times,
                       sliding_window):
    """Jitted once per (shapes, n_states, n_times, window) — defined at
    module level so repeated calls hit the jit cache instead of
    re-tracing a fresh closure each time."""
    import jax
    import jax.numpy as jnp

    def one(lag):
        C = _counts_at_traced_lag(aj, mj, lag, n_states,
                                  sliding_window) + prior
        C_sym = C + C.T
        row = C_sym.sum(axis=1)
        T = C_sym * jnp.where(row > 0, 1.0 / jnp.where(row > 0, row, 1.0),
                              0.0)[:, None]
        pi = row / row.sum()
        sqrt_pi = jnp.sqrt(pi)
        inv_sqrt = jnp.where(sqrt_pi > 0, 1.0 / jnp.where(
            sqrt_pi > 0, sqrt_pi, 1.0), 0.0)
        S = sqrt_pi[:, None] * T * inv_sqrt[None, :]
        S = (S + S.T) * 0.5
        w = jnp.linalg.eigvalsh(S)          # ascending
        # top (n_times + 1): last entries; drop the stationary
        # eigenvalue 1, keep the next n_times
        top = w[::-1][1:n_times + 1]
        # raw reference formula (timescales.py:38): negative
        # eigenvalues yield NaN, unit eigenvalues +/-inf — exactly
        # as the host path does
        return -lag.astype(jnp.float32) / jnp.log(top)
    return jax.vmap(one)(lagsj)


def _make_batched_lags_jit():
    import functools
    import jax
    return jax.jit(_batched_lags_impl,
                   static_argnames=('n_states', 'n_times',
                                    'sliding_window'))


class _LazyJit:
    """Defer jax import until first call, then cache the jitted fn."""

    def __init__(self, maker):
        self._maker = maker
        self._fn = None

    def __call__(self, *args, **kwargs):
        if self._fn is None:
            self._fn = self._maker()
        return self._fn(*args, **kwargs)


_batched_lags_jit = _LazyJit(_make_batched_lags_jit)


def implied_timescales_device(assigns, lag_times, method, n_times=None,
                              sliding_window=True, trim=False):
    """Implied timescales using the device eigensolver for each lag.

    ``method`` must produce reversible T with eq probs (builders.mle or
    builders.transpose). Falls back to the host path per-lag when
    reversibility can't be established.
    """
    from ..tpt.core import _is_reversible
    from .transition_matrices import assigns_to_counts, trim_disconnected

    if hasattr(assigns, '_data'):
        n_states = int(assigns._data.max()) + 1
    else:
        n_states = int(np.max(np.asarray(assigns))) + 1
    if n_times is None:
        n_times = int(np.floor(n_states / 10.0)) + 1
    if n_times > n_states - 1:
        n_times = n_states - 1

    out = []
    for lag in lag_times:
        C = assigns_to_counts(assigns, max_n_states=n_states,
                              lag_time=lag,
                              sliding_window=sliding_window)
        if trim:
            _, C = trim_disconnected(C)
        _, T, pi = method(C)
        # the symmetrized device solver silently CHANGES the spectrum
        # of a non-reversible T (r5 review): honor the documented
        # fallback by checking detailed balance before using it
        T_csr = (T if scipy.sparse.issparse(T)
                 else scipy.sparse.csr_matrix(np.asarray(T)))
        if pi is None or np.any(np.asarray(pi) <= 0) \
                or not _is_reversible(T_csr, np.asarray(pi)):
            from .transition_matrices import eigenspectrum
            vals = eigenspectrum(T, n_eigs=n_times + 1)[0]
        else:
            vals, _ = eigenspectrum_reversible(T, pi=pi,
                                               n_eigs=n_times + 1)
        vals = np.asarray(vals[1:n_times + 1], dtype=np.float64)
        # negative eigenvalues mean the timescale is undefined: NaN,
        # exactly as the host path reports (a clipped tiny-positive
        # value would masquerade as a real fast timescale — r5 review)
        with np.errstate(divide='ignore', invalid='ignore'):
            ts = -lag / np.log(vals)
        ts[~(vals > 0)] = np.nan
        out.append(ts)
    return np.array(out)
