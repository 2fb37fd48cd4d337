"""Backend selection and the one capability query the library asks.

Every choice between an accelerator path and a host path goes through
:func:`on_accelerator`; nothing else in the package compares platform
names.
"""

import logging
import os

logger = logging.getLogger(__name__)

__all__ = ['select_platform', 'on_accelerator', 'device_memory_bytes']


def select_platform(platform=None):
    """Pin jax to ``platform`` ('cpu', 'gpu', ...) for this process.

    When ``platform`` is None, reads ``$ENSPARA_TPU_PLATFORM`` and is a
    no-op if that is unset/empty. Safe to call multiple times; logs
    (rather than raises) if the backend already initialized to
    something else — at that point the choice is frozen.
    """
    if platform is None:
        platform = os.environ.get('ENSPARA_TPU_PLATFORM', '')
    if not platform:
        return
    import jax

    try:
        jax.config.update('jax_platforms', platform)
    except Exception as e:  # pragma: no cover - backend already live
        logger.warning('could not pin jax platform to %r: %s',
                       platform, e)


def on_accelerator(mesh=None):
    """True when work placed on ``mesh`` (default: the default backend)
    runs on an accelerator rather than the host CPU."""
    if mesh is not None:
        return mesh.devices.flat[0].platform != 'cpu'
    import jax
    return jax.default_backend() != 'cpu'


def device_memory_bytes(device):
    """Memory the allocator may hand out on ``device`` (its
    ``bytes_limit``), or None where the backend does not report it."""
    stats = device.memory_stats()
    return None if not stats else stats.get('bytes_limit')
