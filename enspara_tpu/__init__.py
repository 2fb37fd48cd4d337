"""enspara_tpu: an accelerator-native framework for building and analyzing
Markov State Models from molecular-dynamics data at scale.

Capability-parity rebuild of bowman-lab/enspara, re-architected for an
accelerator (an NVIDIA GPU):
JAX/XLA/Pallas kernels replace Cython+OpenMP, a jax.sharding device mesh
replaces MPI, padded+masked device arrays replace host raggedness in every
kernel, and lax control flow replaces stateful Python loops.
"""

import logging

logging.basicConfig(level=logging.WARNING)

__version__ = '0.1.0'

from . import exception  # noqa: F401,E402
from . import citation  # noqa: F401,E402
from . import ra  # noqa: F401,E402


def __getattr__(name):
    """Lazily import heavyweight subpackages on first access
    (``enspara_tpu.msm`` etc.) so that ``import enspara_tpu`` stays
    cheap and jax is only initialized when needed."""
    import importlib
    if name in ('cluster', 'msm', 'tpt', 'info_theory', 'cards',
                'geometry', 'io', 'util', 'parallel', 'apps', 'ops',
                'data'):
        mod = importlib.import_module('.' + name, __name__)
        globals()[name] = mod
        return mod
    raise AttributeError('module %r has no attribute %r'
                         % (__name__, name))
