"""Vector-feature distance kernels (device path).

Device replacement for the reference's Cython+OpenMP libdist
(enspara/geometry/libdist.pyx:77-203). The point-vs-set forms are plain
elementwise reductions; the set-vs-set euclidean form is rewritten as
a Gram-matrix matmul (``|x-y|^2 = |x|^2 + |y|^2 - 2 x.y``) so the FLOPs
go to a matrix product. Everything is jittable and shards over the frame axis.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    'euclidean_to_point', 'manhattan_to_point', 'hamming_to_point',
    'pairwise_euclidean', 'pairwise_manhattan', 'pairwise_hamming',
    'pairwise_distance',
]


@jax.jit
def euclidean_to_point(X, y):
    """Distance from each row of ``X`` (n, d) to point ``y`` (d,)."""
    d = X - y[None, :]
    return jnp.sqrt(jnp.sum(d * d, axis=-1))


@jax.jit
def manhattan_to_point(X, y):
    return jnp.sum(jnp.abs(X - y[None, :]), axis=-1)


@jax.jit
def hamming_to_point(X, y):
    return jnp.mean((X != y[None, :]).astype(jnp.float32), axis=-1)


@functools.partial(jax.jit, static_argnames=('squared',))
def pairwise_euclidean(X, Y, squared=False):
    """All-pairs euclidean distances (n, m) via the Gram-matrix identity.

    The cross term is one (n, d) x (d, m) matmul. A small
    clamp guards fp32 cancellation for near-identical points.
    """
    X = jnp.asarray(X, jnp.float32)
    Y = jnp.asarray(Y, jnp.float32)
    xx = jnp.sum(X * X, axis=-1)
    yy = jnp.sum(Y * Y, axis=-1)
    cross = jnp.dot(X, Y.T, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    d2 = jnp.maximum(xx[:, None] + yy[None, :] - 2.0 * cross, 0.0)
    return d2 if squared else jnp.sqrt(d2)


@jax.jit
def pairwise_manhattan(X, Y):
    """All-pairs L1 distances; broadcast-reduce, vmapped over Y."""
    def one(y):
        return jnp.sum(jnp.abs(X - y[None, :]), axis=-1)
    return jax.vmap(one)(Y).T


@jax.jit
def pairwise_hamming(X, Y):
    def one(y):
        return jnp.mean((X != y[None, :]).astype(jnp.float32), axis=-1)
    return jax.vmap(one)(Y).T


_PAIRWISE = {
    'euclidean': pairwise_euclidean,
    'manhattan': pairwise_manhattan,
    'cityblock': pairwise_manhattan,
    'hamming': pairwise_hamming,
}

_TO_POINT = {
    'euclidean': euclidean_to_point,
    'manhattan': manhattan_to_point,
    'cityblock': manhattan_to_point,
    'hamming': hamming_to_point,
}


def pairwise_distance(X, Y, metric='euclidean'):
    """(n, m) distances between row sets under the named metric."""
    try:
        fn = _PAIRWISE[metric]
    except KeyError:
        raise ValueError('Unknown metric %r; choose from %s'
                         % (metric, sorted(_PAIRWISE)))
    return fn(X, Y)


def distance_to_point(X, y, metric='euclidean'):
    try:
        fn = _TO_POINT[metric]
    except KeyError:
        raise ValueError('Unknown metric %r; choose from %s'
                         % (metric, sorted(_TO_POINT)))
    return fn(X, y)


def pairwise_distance_np(X, Y, metric='euclidean'):
    """Host/numpy mirror used by small host-side paths and tests."""
    X = np.asarray(X)
    Y = np.asarray(Y)
    if metric == 'euclidean':
        d2 = (np.sum(X * X, -1)[:, None] + np.sum(Y * Y, -1)[None, :]
              - 2.0 * X @ Y.T)
        return np.sqrt(np.maximum(d2, 0.0))
    if metric in ('manhattan', 'cityblock'):
        return np.abs(X[:, None, :] - Y[None, :, :]).sum(-1)
    if metric == 'hamming':
        return (X[:, None, :] != Y[None, :, :]).mean(-1)
    raise ValueError('Unknown metric %r' % metric)
