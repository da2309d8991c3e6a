"""Test configuration: run JAX on a virtual 8-device CPU mesh with x64.

The device paths are the same traced code; tests validate numerics (float64,
parity with the reference CPU implementation) and multi-device sharding on
the host-platform device mesh.  Tests marked ``gpu`` need an NVIDIA card
and skip elsewhere; ``python chip_smoke.py`` runs the on-card checks.
"""

import os
import shutil
import subprocess

# must be set before jax is imported anywhere; fast-math off because the
# XLA CPU backend's default LLVM fast-math breaks the two-float error-free
# transformations under jit (see pyiga_jax/config.py)
_flags = os.environ.get('XLA_FLAGS', '')
for _flag in ('--xla_force_host_platform_device_count=8',
              '--xla_cpu_enable_fast_math=false'):
    if _flag.split('=')[0] not in _flags:
        _flags += ' ' + _flag
os.environ['XLA_FLAGS'] = _flags.strip()
# prefer the CPU platform in any environment where other backends exist
os.environ.setdefault('JAX_PLATFORMS', 'cpu')

import jax  # noqa: E402

jax.config.update('jax_enable_x64', True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _seed_rng():
    np.random.seed(38219)
    yield


def _have_gpu():
    """Whether an NVIDIA card is visible, asked of nvidia-smi (the test
    process itself keeps JAX on the CPU)."""
    if shutil.which('nvidia-smi') is None:
        return False
    out = subprocess.run(['nvidia-smi', '-L'], capture_output=True,
                         text=True, timeout=60)
    return out.returncode == 0 and 'GPU' in out.stdout


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    if request.node.get_closest_marker('gpu') and not _have_gpu():
        pytest.skip('needs an NVIDIA GPU (on a card: python -m pytest -m gpu '
                    'tests/test_bench_smoke.py)')
    yield
