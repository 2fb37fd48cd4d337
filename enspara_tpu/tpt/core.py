"""Committor probabilities and mean first passage times.
(reference: enspara/tpt/core.py)

Linear solves run as dense fp32 LU on device (one factorization)
refined to fp64 accuracy with cheap sparse host residuals — direct
SuperLU factorization of MSM graphs suffers catastrophic fill-in
(ring + shortcut topologies take minutes at 10k states where the device LU
takes well under a second).

Systems too big to densify (> ~16k states) use the reversibility of
the chain: with pi_i T_ij = pi_j T_ji, the absorbing system (I - Q)
is pi-symmetrizable to a sparse SPD M-matrix, and Jacobi-
preconditioned fp64 CG solves it in seconds where direct
factorization is fill-in-bound (measured at 100k states / 1.5M nnz:
CG 6.2 s at 1.6e-14 residual vs 193 s SuperLU MMD, vs 76+ s for
ILU-preconditioned BiCGSTAB — incomplete factorizations inherit the
same fill problem). Non-reversible or CG-stalling systems fall back
to the direct host path.
"""

import logging
import warnings

import numpy as np
import scipy.sparse
import scipy.sparse.linalg

from ..citation import cite
from ..util.backend import on_accelerator
from ..msm.transition_matrices import (_eq_probs_detailed_balance,
                                       eq_probs)

logger = logging.getLogger(__name__)

__all__ = ['committors', 'mfpts']

# densify absorbing-state solves on the device up to this many states.
# The dense fp32 system and its LU factors take about 3 * n^2 * 4 bytes,
# 1.3 GB at the cap: a small share of one device's memory. Where the
# dense device LU stops beating the host sparse LU on a GPU is not
# measured; past the cap the host sparse engines take over.
_DENSE_SOLVE_MAX_STATES = 10240


def _dense_on_device(sp):
    """Materialize a sparse matrix DENSE IN device memory by scattering its COO
    triplets on device — the host never builds (or ships) the n^2
    array, so a 10k-state system uploads ~nnz values (<1 MB) instead
    of 400 MB of mostly zeros."""
    from ..ops.sparse import dense_on_device
    return dense_on_device(sp)


def _lu_jitted():
    """Module-cached jitted LU factor/solve — committors/mfpts call
    these per query, and a fresh ``jax.jit`` wrapper per call would
    re-trace (and round-trip the remote compile cache) every time."""
    global _LU_FNS
    if _LU_FNS is None:
        import jax
        import jax.scipy.linalg as jsl
        _LU_FNS = (jax.jit(jsl.lu_factor), jax.jit(jsl.lu_solve))
    return _LU_FNS


_LU_FNS = None


def _absorbing_csr_system(tprob, sinks, sources, all_absorbing):
    """Build (I - Q) with absorbing rows/cols zeroed and unit diagonal,
    plus the SUMMED right-hand-side vector ``b`` (committors are
    linear in the sink columns, so one solve of the summed RHS
    replaces a solve per sink), entirely in CSR arithmetic — O(nnz)
    with C-speed kernels. The previous LIL formulation (mirroring the
    reference, tpt/core.py:60-67) spent seconds per 10k-state query on
    python-loop row surgery; an intermediate version materialized the
    (n, n_sinks) dense RHS, which at 10^6 states x 10^4-state sink
    sets is an 80 GB allocation.

    Duplicated entries in ``sinks``/``sources`` are deduplicated: the
    committor to a sink SET cannot depend on how often a member is
    listed."""
    n = tprob.shape[0]
    Tc = tprob.tocsr()
    sinks_u = np.unique(sinks)
    b = np.asarray(Tc[:, sinks_u].sum(axis=1),
                   dtype=np.float64).ravel()
    b[sinks_u] = 1.0
    b[np.unique(sources)] = 0.0

    # unique: a state listed in both sources and sinks (or duplicated
    # within either) must still get diagonal exactly 1.0, matching the
    # reference's LIL assignment semantics (tpt/core.py:60-67) rather
    # than accumulating one per occurrence
    absorbing_unique = np.unique(all_absorbing)
    keep = np.ones(n)
    keep[absorbing_unique] = 0.0
    D = scipy.sparse.diags(keep)
    A = scipy.sparse.eye(n, format='csr') - Tc
    A = (D @ A @ D).tocsr()
    A = A + scipy.sparse.coo_matrix(
        (np.ones(absorbing_unique.shape[0]),
         (absorbing_unique, absorbing_unique)), shape=(n, n))
    A = A.tocsr()
    A.eliminate_zeros()
    return A, b


def _refined_solve(A_dense32, B, A_exact=None, max_refine=10,
                   rtol=1e-10):
    """Solve A x = B via one device fp32 LU factorization plus fp64
    iterative refinement: r = B - A x is computed in fp64 against
    ``A_exact`` (sparse or dense), and the correction reuses the LU.
    Returns fp64 x with ~fp64 accuracy for the well-conditioned
    M-matrix systems TPT produces, or None if refinement stalls
    (caller falls back to a host sparse solve)."""
    import jax

    if A_exact is None:
        A_exact = A_dense32
    B = np.asarray(B, dtype=np.float64)
    b1d = B.ndim == 1
    Bm = B[:, None] if b1d else B

    if isinstance(A_dense32, jax.Array):
        A32 = A_dense32                 # already fp32 on the device
    else:
        A32 = A_dense32.astype(np.float32)
    factor, solve = _lu_jitted()
    lu, piv = factor(A32)

    x = np.asarray(solve((lu, piv),
                         Bm.astype(np.float32))).astype(np.float64)
    bnorm = max(np.abs(Bm).max(), 1e-300)
    prev = np.inf
    for _ in range(max_refine):
        r = Bm - A_exact @ x
        rnorm = np.abs(r).max()
        if rnorm <= rtol * bnorm:
            return x[:, 0] if b1d else x
        if rnorm >= prev * 0.5:     # stalled: fp32 LU too inaccurate
            return None
        prev = rnorm
        dx = np.asarray(solve((lu, piv), r.astype(np.float32)))
        x = x + dx
    return None


def _I_m_Q(tprob, absorbing_states, n_states=None):
    """(I - Q) with absorbing rows/cols zeroed and unit diagonal.
    (reference: tpt/core.py:25)"""
    T = np.asarray(tprob, dtype=float)
    n = T.shape[0] if n_states is None else n_states
    transient = np.ones(n, dtype=bool)
    transient[absorbing_states] = False
    # off-diagonal blocks: -T restricted to transient x transient
    A = np.where(transient[:, None] & transient[None, :], -T, 0.0)
    # diagonal: 1 - T_ii on transient states, exactly 1 on absorbing
    np.fill_diagonal(A, np.where(transient, 1.0 - T.diagonal(), 1.0))
    return A


def _stationary_estimate(T_csr):
    """Stationary distribution of a sparse row-stochastic T via ARPACK
    (k=1 Arnoldi on T^T). Returns None when it fails or the leading
    eigenvector is not sign-consistent.

    The restart budget is BOUNDED (scipy's default is 10*n implicit
    restarts — effectively unbounded at 10^6 states, and metastable
    chains have eigengaps ~1/timescale where Arnoldi can grind
    forever): a generous Krylov width plus a few hundred restarts
    either converges in seconds-to-minutes or we fall back. Callers
    who HAVE pi (any builder output) should pass it and skip this."""
    # reversible chains never need Arnoldi: detailed balance fixes pi
    # along a spanning tree in O(nnz), certified on every entry
    pi = _eq_probs_detailed_balance(T_csr)
    if pi is not None:
        return pi
    n = T_csr.shape[0]
    try:
        w, v = scipy.sparse.linalg.eigs(
            T_csr.T.astype(np.float64), k=1, which='LM',
            v0=np.full(n, 1.0), ncv=min(n - 1, 40), maxiter=300,
            tol=1e-10)
    except Exception:
        return None
    if abs(w[0] - 1.0) > 1e-6:
        return None
    pi = np.real(v[:, 0])
    if pi.sum() < 0:
        pi = -pi
    if np.any(pi <= 0):
        return None
    return pi / pi.sum()


def _is_reversible(T_csr, pi, rtol=1e-8):
    """max |pi_i T_ij - pi_j T_ji| <= rtol * max flux, in O(nnz)."""
    F = scipy.sparse.diags(pi) @ T_csr
    D = (F - F.T).tocoo()
    if D.nnz == 0:
        return True
    return np.abs(D.data).max() <= rtol * np.abs(F.data).max()


def _cg_absorbing_solve(A, b, pi, rtol=1e-9):
    """Solve the absorbing-state system ``A x = b`` (A from
    :func:`_absorbing_csr_system`) by pi-symmetrized Jacobi-CG.

    For a reversible chain, D A D^{-1} with D = diag(sqrt(pi)) is a
    sparse SPD M-matrix (keep-block pi-flux symmetry; unit absorbing
    diagonal), so fp64 CG converges superlinearly — the committor
    spectrum has one tiny eigenvalue per metastable well and an O(1)
    bulk, exactly the clustered shape CG resolves fast. Returns fp64
    x with the residual verified against the EXACT unsymmetrized
    system, or None if CG fails to reach ``rtol``.
    """
    pi = np.asarray(pi, dtype=np.float64)
    # trimmed MSMs commonly carry zero-population states; d=0 would
    # poison the symmetrized operator with inf/nan
    if pi.shape[0] != A.shape[0] or not np.all(pi > 0):
        return None
    d = np.sqrt(pi)
    As = scipy.sparse.diags(d) @ A.astype(np.float64) @ \
        scipy.sparse.diags(1.0 / d)
    As = ((As + As.T) * 0.5).tocsr()
    diag = As.diagonal()
    if np.any(diag <= 0):
        return None
    Mj = scipy.sparse.linalg.LinearOperator(As.shape,
                                            lambda v: v / diag)
    b = np.asarray(b, dtype=np.float64)

    # scipy's CG stops on its RECURRENCE residual (2-norm, b-relative),
    # which keeps contracting to this target even when the TRUE
    # residual has floored at ~eps * |A| * |x| — so the strict stop is
    # fine for any solution magnitude; what must scale with |x| is the
    # ACCEPTANCE check below (a b-relative acceptance rejected
    # perfectly-converged mean-first-passage solves, whose |x| ~ 1/gap
    # >> |b|, and sent them to a 30x-slower direct factorization).
    y, code = scipy.sparse.linalg.cg(As, d * b, M=Mj, rtol=1e-13,
                                     atol=0.0, maxiter=50_000)
    if code != 0:
        return None
    x = y / d

    # accept on the normwise backward error of the EXACT unsymmetrized
    # system: |Ax - b| <= rtol * (|b| + |A|*|x|) — the standard
    # criterion that degrades gracefully to the fp64 floor for
    # large-magnitude solutions while staying as strict as the old
    # b-relative bound when |x| ~ |b| (committors)
    anorm = float(np.abs(A).sum(axis=1).max())
    scale = float(np.abs(b).max()) + anorm * float(np.abs(x).max())
    resid = float(np.abs(A @ x - b).max())
    # NaN-safe: 'resid <= bound' is False for NaN, so a poisoned
    # solve is rejected rather than silently accepted
    if not (resid <= rtol * max(scale, 1e-300)):
        return None
    return x


def _gmres_absorbing_solve(A, b, rtol=1e-9):
    """Jacobi-preconditioned GMRES on the raw (unsymmetrized)
    absorbing system: no pi needed, memory-light (restart 50), slower
    than the CG path (~60x measured at 100k states) but immune to the
    fill-in explosion that makes direct factorization intractable at
    ~10^6 states. Residual-verified; None on failure. (BiCGSTAB
    measured: breaks down on these systems, scipy code -10.)"""
    A64 = A.tocsr().astype(np.float64)
    b = np.asarray(b, dtype=np.float64)
    diag = A64.diagonal()
    if np.any(diag == 0):
        return None
    Mj = scipy.sparse.linalg.LinearOperator(A64.shape,
                                            lambda v: v / diag)

    # Accept on the normwise backward error of the original system,
    # |Ax-b| <= rtol*(|b| + |A||x|) — same criterion as the CG path.
    # A b-relative inner stop can be unreachable for MFPT-type RHS
    # where |x| ~ 1/gap >> |b| (the true residual floors at
    # eps*|A||x|), so check the achievable bound at every restart and
    # bail out of gmres as soon as it holds.
    anorm = float(np.abs(A64).sum(axis=1).max())
    bmax = float(np.abs(b).max())

    def _backward_error_ok(x):
        resid = float(np.abs(A64 @ x - b).max())
        bound = rtol * max(bmax + anorm * float(np.abs(x).max()),
                           1e-300)
        return resid <= bound  # NaN-safe: False for NaN resid

    class _Converged(Exception):
        def __init__(self, x):
            self.x = x

    def _check_restart(xk):
        if _backward_error_ok(xk):
            raise _Converged(np.array(xk, dtype=np.float64))

    try:
        x, _code = scipy.sparse.linalg.gmres(
            A64, b, M=Mj, rtol=1e-13, atol=0.0, restart=50,
            maxiter=4000, callback=_check_restart, callback_type='x')
    except _Converged as conv:
        return conv.x
    # maxiter exhausted or scipy's own stop fired between callbacks:
    # judge the final iterate on the same backward-error bound rather
    # than on scipy's b-relative return code
    if _backward_error_ok(x):
        return x
    return None


# above this, direct sparse LU fill-in is assumed intractable and the
# non-reversible fallback goes to GMRES before SuperLU
_DIRECT_SOLVE_MAX_STATES = 262144


def _large_sparse_absorbing_solve(tprob_csr, A, b, pi):
    """Best-engine dispatch for absorbing solves too large to densify:
    pi-symmetrized CG when the chain is reversible (estimating pi via
    ARPACK when not given); otherwise SuperLU (A+A^T minimum-degree
    ordering) up to ~262k states, Jacobi-GMRES past that (direct
    factorization fill-in is intractable there), each falling back to
    the other, then spsolve as the last resort."""
    if pi is None:
        pi = _stationary_estimate(tprob_csr)
    if pi is not None and len(pi) == tprob_csr.shape[0] \
            and _is_reversible(tprob_csr, np.asarray(pi, np.float64)):
        x = _cg_absorbing_solve(A, b, pi)
        if x is not None:
            return x
        logger.info('pi-symmetrized CG stalled; falling back to '
                    'the direct host path')

    engines = ['splu', 'gmres']
    if A.shape[0] > _DIRECT_SOLVE_MAX_STATES:
        engines.reverse()
    for engine in engines:
        if engine == 'gmres':
            x = _gmres_absorbing_solve(A, b)
            if x is not None:
                return x
            logger.info('Jacobi-GMRES stalled on the absorbing '
                        'system; trying the next engine')
        else:
            with warnings.catch_warnings():
                warnings.simplefilter('ignore')
                try:
                    # MSM graphs have (near-)symmetric patterns: the
                    # A+A^T minimum-degree ordering cuts SuperLU
                    # fill-in ~3x vs the default COLAMD
                    lu = scipy.sparse.linalg.splu(
                        A.tocsc(), permc_spec='MMD_AT_PLUS_A')
                    return lu.solve(np.asarray(b, dtype=np.float64))
                except Exception:
                    logger.info('SuperLU failed on the absorbing '
                                'system; trying the next engine')
    x = scipy.sparse.linalg.spsolve(A, np.asarray(b, dtype=np.float64))
    return np.asarray(x)


@cite('tpt')
def committors(tprob, sources, sinks, pi=None):
    """Forward committors q+ of the reaction sources -> sinks: the
    probability each state reaches a sink before a source, from the
    absorbing-state linear solve (I-Q) x = R.
    (reference: tpt/core.py:40; ``pi`` is an extension — passing the
    stationary distribution of a reversible ``tprob`` lets large
    sparse systems take the pi-symmetrized CG path without the ARPACK
    stationary-vector estimate.)"""
    sources = np.array(sources, dtype=int).reshape(-1)
    sinks = np.array(sinks, dtype=int).reshape(-1)
    all_absorbing = np.append(sources, sinks)

    is_sparse = scipy.sparse.issparse(tprob)
    n_states = tprob.shape[0]

    if is_sparse:
        I_m_Q, b = _absorbing_csr_system(tprob, sinks, sources,
                                         all_absorbing)

        q = None
        if (n_states <= _DENSE_SOLVE_MAX_STATES
                and on_accelerator()):
            # committors are linear in the sink columns, so ONE solve
            # of the summed RHS vector replaces a solve per sink. On
            # the CPU backend XLA's dense LU loses to SuperLU, so the
            # host sparse engines keep that case.
            q = _refined_solve(_dense_on_device(I_m_Q), b,
                               A_exact=I_m_Q)
            if q is None:
                logger.info('fp32 refinement unavailable; using the '
                            'host sparse path')
        if q is None:
            q = _large_sparse_absorbing_solve(
                tprob.tocsr(), I_m_Q, b, pi)
    else:
        dense = np.asarray(tprob, dtype=float)
        sinks_u = np.unique(sinks)
        b = dense[:, sinks_u].sum(axis=1)
        b[sinks_u] = 1.0
        b[np.unique(sources)] = 0.0
        I_m_Q = _I_m_Q(dense, all_absorbing, n_states=n_states)
        q = None
        if n_states >= 64 and on_accelerator():
            q = _refined_solve(I_m_Q, b)
        if q is None:
            q = np.linalg.solve(I_m_Q, b)

    q = np.asarray(q)
    q[sinks] = 1.0
    return q


def mfpts(tprob, sinks=None, populations=None, lagtime=1.):
    """Mean first passage times, all-to-all (fundamental matrix) or to a
    sink set (absorbing solve). (reference: tpt/core.py:105)

    Sparse inputs with a sink set stay sparse past the densification
    cap: the absorbing solve (I-Q) x = 1 runs through the same
    pi-symmetrized-CG / SuperLU dispatch as :func:`committors`, so
    10^5-10^6-state MFPTs never build an n^2 array."""
    # sparse + sinks stays on the sparse host dispatch not only past
    # the densification cap but also whenever the device LU path is
    # unprofitable (CPU-only hosts): toarray() + dense solve on a 16k
    # sparse system costs GBs and minutes where the CSR engines take
    # seconds
    if scipy.sparse.issparse(tprob) and sinks is not None \
            and (tprob.shape[0] > _DENSE_SOLVE_MAX_STATES
                 or not on_accelerator()):
        sinks = np.array(sinks, dtype=int).reshape(-1)
        n_states = tprob.shape[0]
        A, _ = _absorbing_csr_system(tprob, sinks,
                                     np.empty(0, dtype=int), sinks)
        c = np.ones(n_states)
        c[sinks] = 0.0
        pi = np.asarray(populations, dtype=np.float64).reshape(-1) \
            if populations is not None else None
        x = _large_sparse_absorbing_solve(tprob.tocsr(), A, c, pi)
        x[sinks] = 0.0
        return lagtime * x

    tprob = tprob.toarray() if scipy.sparse.issparse(tprob) \
        else np.asarray(tprob, dtype=float)
    n_states = len(tprob)
    if populations is None and sinks is None:
        populations = eq_probs(tprob)

    if sinks is None:
        W = np.array([populations] * n_states)
        Z = np.linalg.inv(np.eye(n_states) - tprob + W)
        return lagtime * (np.diag(Z) - Z) / W

    sinks = np.array(sinks, dtype=int).reshape(-1)
    I_m_Q = _I_m_Q(tprob, sinks, n_states=n_states)
    c = np.ones(n_states)
    c[sinks] = 0
    if n_states >= 64 and on_accelerator():
        x = _refined_solve(I_m_Q, c)
        if x is not None:
            return lagtime * x
    return lagtime * np.linalg.solve(I_m_Q, c)
