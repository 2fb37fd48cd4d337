"""Counts -> transition-probability builders, uniform signature
``(C, prior_counts, calculate_eq_probs) -> (C, T, eq_probs)``.

Capability parity with enspara/msm/builders.py (estimators: ``mle``,
``transpose``, ``normalize``), designed around two small container
helpers so every estimator is polymorphic over scipy sparse types and
ndarrays: whatever container goes in comes back out.

``mle_device`` is the device-side Jacobi reformulation of the Prinz MLE:
every (i, j) pair updates from the current row sums simultaneously
(vectorized over the whole matrix), converging to the same
detailed-balance fixed point as the sequential Gauss-Seidel kernel.
"""

import logging
import warnings

import numpy as np
import scipy.sparse

from ..citation import cite
from ..exception import ConvergenceWarning
from .transition_matrices import eq_probs
from .libmsm import _mle_prinz_dense

logger = logging.getLogger(__name__)

__all__ = ['mle', 'transpose', 'normalize', 'mle_device']


def _with_pseudocounts(counts, pseudo):
    """Add a scalar or matrix of pseudocounts, densifying only when
    scipy can't represent the result (sparse + nonzero scalar touches
    every cell, which scipy refuses to do implicitly)."""
    if pseudo is None:
        return counts
    must_densify = (scipy.sparse.issparse(counts)
                    and np.ndim(pseudo) == 0 and pseudo != 0)
    if must_densify:
        counts = np.array(counts.todense())
    return counts + pseudo


def _stochasticize(counts):
    """Row-normalize a counts container into transition probabilities.

    Zero rows stay zero (their reciprocal weight is defined as 0), and
    the container type is preserved: sparse in -> same sparse type out,
    array-like in -> ndarray out.
    """
    row_mass = np.ravel(np.asarray(counts.sum(axis=1), dtype=np.float64))
    recip = np.where(row_mass > 0, 1.0, 0.0)
    recip /= np.where(row_mass > 0, row_mass, 1.0)

    if scipy.sparse.issparse(counts):
        scaled = scipy.sparse.diags(recip) @ \
            scipy.sparse.csr_matrix(counts).asfptype()
        return type(counts)(scaled)
    return np.asarray(counts) * recip[:, None]


@cite('prinz-mle')
def mle(C, prior_counts=None, calculate_eq_probs=True):
    """Detailed-balance maximum-likelihood estimator (Prinz et al.,
    J. Chem. Phys. 134, 174105, 2011). Capability match for the
    reference's ``builders.mle``; the Gauss-Seidel inner loop runs in
    the native kernel (see native/prinz.cpp).

    The stationary distribution falls out of the solve itself, so
    ``calculate_eq_probs=False`` can only drop it (with a warning),
    never skip the work.
    """
    C = _with_pseudocounts(C, prior_counts)

    repack = np.array
    if scipy.sparse.issparse(C):
        repack = type(C)
        C = np.asarray(C.todense())

    T, stationary = _mle_prinz_dense(C)
    if not calculate_eq_probs:
        warnings.warn('MLE method cannot suppress calculation of '
                      'equilibrium probabilities, since they are '
                      'calculated together.', category=RuntimeWarning)
        stationary = None

    return repack(C), repack(T), stationary


def _estimate(C, pseudo, want_eq, symmetrize):
    """Shared core of the two closed-form estimators.

    With ``symmetrize`` the counts are reversibilized as (C + Cᵀ)/2
    first, which makes the stationary distribution a cheap row-mass
    ratio; without it the stationary distribution needs the top left
    eigenvector of T.
    """
    counts = _with_pseudocounts(C, pseudo)
    work = counts + counts.T if symmetrize else counts
    T = _stochasticize(work)

    # symmetrization widens some sparse containers (e.g. dia -> csr);
    # pin both outputs back to the caller's container
    if not isinstance(T, type(counts)):
        T = type(counts)(T)
        work = type(counts)(work)

    if symmetrize:
        pi = None
        if want_eq:
            pi = np.ravel(np.asarray(work.sum(axis=1) / work.sum()))
        # halve via scalar multiply: integer sparse types then upcast
        # to float instead of truncating the half-counts
        return work * 0.5, T, pi

    return counts, T, (eq_probs(T) if want_eq else None)


def transpose(C, prior_counts=None, calculate_eq_probs=True):
    """Symmetrization estimator: detailed balance imposed by averaging
    forward and reverse counts, T = rownorm(C + Cᵀ)."""
    return _estimate(C, prior_counts, calculate_eq_probs,
                     symmetrize=True)


def normalize(C, prior_counts=None, calculate_eq_probs=True):
    """Plain row normalization (no detailed-balance constraint); the
    stationary distribution comes from the top left eigenvector, which
    is the expensive part and can be skipped."""
    return _estimate(C, prior_counts, calculate_eq_probs,
                     symmetrize=False)


def mle_device(C, prior_counts=None, calculate_eq_probs=True,
               tol=1e-11, max_iter=2000):
    """Jacobi-style on-device Prinz MLE: all (i, j) pair updates computed
    simultaneously from the current row sums, then row sums refreshed
    exactly — a fixed-point iteration with the same detailed-balance
    stationary point as the Gauss-Seidel kernel, but fully vectorized for
    the device. Roughly O(n^2) per sweep with no sequential dependence.

    Returns the same (C, T, eq) triple as :func:`mle`.
    """
    import jax
    import jax.numpy as jnp

    C_in = _with_pseudocounts(C, prior_counts)
    if scipy.sparse.issparse(C_in):
        C_arr = np.asarray(C_in.todense(), dtype=np.float32)
        recast = type(C_in)
    else:
        C_arr = np.asarray(C_in, dtype=np.float32)
        recast = np.array
    if (C_arr.sum(axis=1) <= 0).any() \
            or ((C_arr + C_arr.T).sum(axis=1) <= 0).any():
        # match the host kernel's contract: a zero-count state would
        # otherwise NaN-poison T silently (0/0 row) — r5 review
        raise ValueError(
            'Prinz MLE requires every state to have at least one '
            'transition. Trim disconnected states first.')

    Cj = jnp.asarray(C_arr)
    C_rs = jnp.sum(Cj, axis=1)
    Csym = Cj + Cj.T

    def sweep(_, X):
        X_rs = jnp.sum(X, axis=1)
        # diagonal update (independent per state)
        denom = C_rs - jnp.diag(Cj)
        diag_new = jnp.where(
            denom > 0,
            jnp.diag(Cj) * (X_rs - jnp.diag(X)) / jnp.maximum(denom, 1e-30),
            jnp.diag(X))
        X = X.at[jnp.diag_indices_from(X)].set(diag_new)
        X_rs = jnp.sum(X, axis=1)

        # all-pairs quadratic-root update from current row sums
        a = (C_rs[:, None] - Cj) + (C_rs[None, :] - Cj.T)
        b = (C_rs[:, None] * (X_rs[None, :] - X)
             + C_rs[None, :] * (X_rs[:, None] - X)
             - Csym * (X_rs[:, None] + X_rs[None, :] - 2 * X))
        c = -Csym * (X_rs[:, None] - X) * (X_rs[None, :] - X)
        disc = jnp.maximum(b * b - 4 * a * c, 0.0)
        v = jnp.where(jnp.abs(a) > 1e-30,
                      (-b + jnp.sqrt(disc)) / (2 * a), X)
        # keep the diagonal from the diagonal pass; Jacobi-average the
        # off-diagonal update for stability
        v = 0.5 * (v + v.T)
        off = ~jnp.eye(X.shape[0], dtype=bool)
        X_new = jnp.where(off, 0.5 * X + 0.5 * v, X)
        return X_new

    def logl_of(X):
        # the host kernels' stopping metric (reference libmsm.pyx:46,
        # incl. its log10 base and off-diagonal divide-outside-the-log
        # quirk), vectorized
        X_rs = jnp.sum(X, axis=1)
        d = jnp.diag(X)
        diag_term = jnp.sum(jnp.where(
            d > 0, jnp.diag(Cj) * jnp.log10(
                jnp.maximum(d, 1e-300) / X_rs), 0.0))
        off = ~jnp.eye(X.shape[0], dtype=bool)
        off_term = jnp.sum(jnp.where(
            off & (X > 0),
            Cj * jnp.log10(jnp.maximum(X, 1e-300)) / X_rs[:, None],
            0.0))
        return diag_term + off_term

    def cond(state):
        i, _, dl = state
        return (i < max_iter) & (dl > tol)

    def step(state):
        i, X, _ = state
        old = logl_of(X)
        X = sweep(i, X)
        return i + 1, X, jnp.abs(logl_of(X) - old)

    # tol-driven stopping (r5 review: tol was dead and every call paid
    # all max_iter sweeps)
    n_done, X, delta = jax.lax.while_loop(
        cond, step, (jnp.int32(0), Csym, jnp.float32(jnp.inf)))
    if int(n_done) >= max_iter and float(delta) > tol:
        warnings.warn(
            'Prinz MLE (device) reached max_iter=%d without the '
            'log-likelihood change dropping below tol=%g (last '
            'change %g)' % (max_iter, tol, float(delta)),
            ConvergenceWarning)
    X_rs = jnp.sum(X, axis=1)
    T = X / X_rs[:, None]
    pi = X_rs / jnp.sum(X_rs)

    T = np.asarray(T, dtype=np.float64)
    T /= T.sum(axis=1, keepdims=True)
    pi = np.asarray(pi, dtype=np.float64)
    pi /= pi.sum()
    eq = pi if calculate_eq_probs else None
    return recast(C_arr), recast(T), eq
