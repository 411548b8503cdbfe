"""Test configuration: run JAX on a virtual 8-device CPU mesh with x64 on.

Mirrors the driver's multi-chip dry-run environment so the sharded algebra
paths are exercised without TPU hardware.
"""

import os

os.environ['JAX_PLATFORMS'] = 'cpu'
flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8').strip()
os.environ.setdefault('JAX_ENABLE_X64', '1')

import jax  # noqa: E402

# belt and braces: the env var only works if jax was not initialized by a
# pytest plugin first; the config update always does
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'gpu: needs a CUDA device; skips (with a reason) '
        'where torch finds none')


@pytest.fixture(autouse=True)
def _seed():
    np.random.seed(1)
    yield
