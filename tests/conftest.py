"""Test configuration: run everything on CPU with 8 virtual XLA devices so
sharded == unsharded equivalence can be asserted without accelerator
hardware (the analogue of the reference's `mpirun -n 2 pytest -m mpi`
strategy, SURVEY.md §4)."""

import os

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
os.environ.setdefault('JAX_PLATFORM_NAME', 'cpu')
flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8').strip()
os.environ.setdefault('JAX_ENABLE_X64', 'False')
# The smFRET tests use the reference checkout's dye library as their
# oracle data; outside this harness users fetch the library with
# `python -m enspara_tpu.data.fetch_dye_library` instead.
os.environ.setdefault('ENSPARA_TPU_USE_REFERENCE_DATA', '1')

# Installed pytest plugins (jaxtyping) import jax before this conftest
# runs, which freezes jax's env-var-derived config defaults. Backends are
# created lazily, so updating the config here still takes effect.
import jax  # noqa: E402

# `JAX_PLATFORMS=cuda,cpu pytest -m chip` runs the GPU tests on a card
jax.config.update('jax_platforms', os.environ['JAX_PLATFORMS'])
jax.config.update('jax_num_cpu_devices', 8)


import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none. The
    check runs when the test runs, never at import or collection."""
    try:
        devices = jax.devices('gpu')
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip('needs a GPU: the kernel has no compiled form here')
    return devices[0]
