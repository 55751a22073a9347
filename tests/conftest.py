import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop jax's compiled-executable caches after each test module.

    The suite compiles hundreds of distinct executables; on some CPU boxes
    the accumulated jit state eventually segfaults XLA's backend_compile
    partway through the run (the same compilation succeeds in a fresh
    process).  Modules don't share compiled functions — each builds its own
    configs/servers — so clearing between modules costs nothing and keeps
    the per-compilation state bounded to one module's worth.
    """
    yield
    import jax

    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA kernels); the "
        "test skips itself where there is none")
