"""Lightweight timing/observability helpers.

``timed`` mirrors the reference's context manager (enspara/util/log.py:5)
and is used to wrap hot sections throughout the framework. On top of the
reference's wall-time logging we add optional JAX profiler trace regions
and device-memory stats, which are the device observability analogue.
"""

import logging
import time
from contextlib import contextmanager

logger = logging.getLogger(__name__)


@contextmanager
def timed(tick_msg, log_func=logger.debug):
    """Context manager that logs the wall time of its block.

    Parameters
    ----------
    tick_msg : str
        printf-style format string with one ``%s``/``%f``-style slot that
        receives the elapsed seconds.
    log_func : callable
        Logging function, e.g. ``logger.info`` or ``print``.
    """
    tick = time.perf_counter()
    yield
    tock = time.perf_counter()
    if log_func is not None:
        log_func(tick_msg, tock - tick)


@contextmanager
def trace_region(name):
    """JAX profiler named trace region; no-op if the profiler is absent."""
    try:
        import jax.profiler
        with jax.profiler.TraceAnnotation(name):
            yield
    except Exception:
        yield


def device_memory_stats():
    """Best-effort per-device memory statistics (bytes in use / limit)."""
    import jax
    stats = {}
    for d in jax.devices():
        try:
            s = d.memory_stats()
        except Exception:
            s = None
        if s:
            stats[str(d)] = {
                'bytes_in_use': s.get('bytes_in_use'),
                'bytes_limit': s.get('bytes_limit'),
                'peak_bytes_in_use': s.get('peak_bytes_in_use'),
            }
    return stats


def setup_logging(level=logging.INFO):
    logging.basicConfig(
        level=level,
        format='%(asctime)s %(name)s %(levelname)s %(message)s')
