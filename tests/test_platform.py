import numpy as np
import pytest


def test_platform():
    import jax
    assert jax.default_backend() == 'cpu'
    assert len(jax.devices()) == 8, jax.devices()


def test_select_platform_pins_config():
    from enspara_tpu.util.backend import select_platform
    import jax
    # already on cpu in tests; re-pinning must be a safe no-op
    select_platform('cpu')
    assert jax.default_backend() == 'cpu'
    # unset env -> no-op
    select_platform(None)
    assert jax.default_backend() == 'cpu'


def test_compile_cache_honours_env_dir(tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins: jax already reads it, and the
    library sets no other directory."""
    import jax
    from enspara_tpu.util import backend, compile_cache

    monkeypatch.setattr(backend, 'on_accelerator', lambda mesh=None: True)
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compilation_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update('jax_compilation_cache_dir', before)


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    import os

    import jax
    from enspara_tpu.util import backend, compile_cache

    monkeypatch.setattr(backend, 'on_accelerator', lambda mesh=None: True)
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        loc = compile_cache.enable_compilation_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(
            __file__)))
        assert loc == os.path.join(repo, '.jax_cache')
        assert jax.config.jax_compilation_cache_dir == loc
    finally:
        jax.config.update('jax_compilation_cache_dir', before)


def test_compile_cache_off_on_cpu(monkeypatch):
    import jax
    from enspara_tpu.util.compile_cache import enable_compilation_cache

    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert enable_compilation_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize('seed', [None, 3, np.int64(3), 'state'])
def test_check_random_state_semantics(seed):
    from enspara_tpu.util.rng import check_random_state

    if seed == 'state':
        rs = np.random.RandomState(5)
        assert check_random_state(rs) is rs
    elif seed is None:
        assert check_random_state(None) is np.random.mtrand._rand
    else:
        a = check_random_state(seed).randint(1000, size=4)
        b = np.random.RandomState(3).randint(1000, size=4)
        assert (a == b).all()


def test_check_random_state_rejects_other_types():
    from enspara_tpu.util.rng import check_random_state

    with pytest.raises(ValueError):
        check_random_state('seven')
