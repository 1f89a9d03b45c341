"""Memory hygiene for the port's comparison tests.

Every ``tests/test_torch_*.py`` module holds the port against tpufem, whose
Pallas kernels run in interpret mode on the CPU. The programs JAX compiles
for them stay in its caches, and freed buffers stay in the C allocator,
long after the module is done; an xdist worker that has run a few such
modules keeps gigabytes it no longer needs. Those modules import
``release_memory``, an autouse module fixture that drops both when the
module starts (what earlier modules left) and when it ends."""

import ctypes
import gc

import jax
import numpy as np
import pytest


def release():
    """Drop JAX's compiled programs and hand freed heap back to the OS."""
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):  # not glibc
        pass


@pytest.fixture(scope="module", autouse=True)
def release_memory():
    release()
    yield
    release()


def test_release_drops_compiled_programs():
    f = jax.jit(lambda x: 2.0 * x)
    assert float(f(np.ones(3)).sum()) == 6.0
    assert f._cache_size() == 1
    release()
    assert f._cache_size() == 0
    assert float(f(np.ones(3)).sum()) == 6.0  # recompiles on demand
