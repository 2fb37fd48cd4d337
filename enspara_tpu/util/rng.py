"""Random-state normalisation with scikit-learn's semantics, so the
clustering path needs no scikit-learn install."""

import numbers

import numpy as np

__all__ = ['check_random_state']


def check_random_state(seed):
    """Turn ``seed`` into a ``np.random.RandomState``.

    None (or the ``np.random`` module) gives the global RandomState, an
    integer a new RandomState seeded with it, and a RandomState passes
    through; anything else raises ValueError — the contract of
    ``sklearn.utils.check_random_state``."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, numbers.Integral):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError('%r cannot be used to seed a numpy.random.'
                     'RandomState instance' % (seed,))
