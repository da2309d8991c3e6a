"""The platform decision (config.platform), the paths it routes, the compile
cache rule and the no-GPU failure of the card scripts."""

import contextlib
import os
import shutil
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from pyiga_jax import bspline, config, geometry, parallel
from pyiga_jax.assemblers import StiffnessAssembler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fake_gpu(monkeypatch):
    """Make JAX's default backend report 'gpu' (nothing is pinned)."""
    monkeypatch.setattr(jax, 'default_backend', lambda: 'gpu')


def test_platform_cpu():
    assert config.platform() == 'cpu'


def test_platform_gpu_default_backend(fake_gpu):
    assert config.platform() == 'gpu'


def test_platform_honours_cpu_pin(fake_gpu):
    with jax.default_device(jax.devices('cpu')[0]):
        assert config.platform() == 'cpu'
    assert config.platform() == 'gpu'


def test_platform_unknown_raises(monkeypatch):
    monkeypatch.setattr(jax, 'default_backend', lambda: 'metal')
    with pytest.raises(RuntimeError, match='metal'):
        config.platform()
    with pytest.raises(RuntimeError):
        config.default_assembly_mode()


@pytest.mark.parametrize('gpu', [False, True])
def test_default_assembly_mode_exact(monkeypatch, gpu):
    if gpu:
        monkeypatch.setattr(jax, 'default_backend', lambda: 'gpu')
    assert config.default_assembly_mode() == 'exact'


@pytest.mark.parametrize('gpu', [False, True])
def test_host_routing_of_tiny_assemblies(monkeypatch, gpu):
    # below host_assembly_cutoff the GPU routes assembly to the CPU device;
    # on the CPU nothing is re-pinned
    from pyiga_jax import _hdiscr
    from pyiga_jax.assemble import _host_route_ctx
    if gpu:
        monkeypatch.setattr(jax, 'default_backend', lambda: 'gpu')
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 4),)
    asm = StiffnessAssembler(kvs, geometry.unit_square())
    for ctx in (_hdiscr._level_device_ctx(10), _host_route_ctx(asm)):
        assert isinstance(ctx, contextlib.nullcontext) != gpu


@pytest.mark.parametrize('gpu', [False, True])
def test_aca_driver_routing(monkeypatch, gpu):
    # the device-resident 3D ACA driver is the GPU's; the CPU runs the
    # host driver
    from pyiga_jax import lowrank
    if gpu:
        monkeypatch.setattr(jax, 'default_backend', lambda: 'gpu')
    from pyiga_jax.compile import compile_vform
    from pyiga_jax.vform import stiffness_vf
    kvs = 3 * (bspline.make_knots(2, 0.0, 1.0, 3),)
    asm = compile_vform(stiffness_vf(3))(kvs, geo=geometry.unit_cube())
    shape = [len(bx) for bx in asm.structure.bidx]
    called = []

    def fake(kind):
        def run(*a, **kw):
            called.append(kind)
            return np.zeros(shape)
        return run

    monkeypatch.setattr(lowrank, 'aca_3d_device', fake('device'))
    monkeypatch.setattr(lowrank, 'aca_3d', fake('host'))
    lowrank.fast_assemble(asm, kvs, verbose=0)
    assert called == ['device' if gpu else 'host']


def test_twofloat_paths_refused_on_gpu(fake_gpu):
    # the GPU compiler does not keep the two-float transformations exact:
    # every path built on them raises there instead of returning
    # degraded float64
    import scipy.sparse
    from pyiga_jax.ops import mg
    from pyiga_jax.ops import twofloat as tf
    kvs = 2 * (bspline.make_knots(2, 0.0, 1.0, 4),)
    asm = StiffnessAssembler(kvs, geometry.unit_square())
    with pytest.raises(NotImplementedError, match='ozaki'):
        asm.assemble(mode='ozaki')
    with pytest.raises(NotImplementedError, match='two-float'):
        tf.two_sum(np.float32(1.0), np.float32(2.0 ** -30))
    A0 = scipy.sparse.csr_matrix(np.diag(np.arange(1.0, 9.0)))
    A1 = scipy.sparse.csr_matrix(np.diag(np.arange(1.0, 17.0)))
    P = scipy.sparse.random(16, 8, 0.3, format='csr', random_state=0)
    with pytest.raises(NotImplementedError, match="'df'"):
        mg.DeviceMGSolver([A0, A1], [P], [np.arange(8), np.arange(16)],
                          ('symmetric', 'symmetric'), 1, smoother_impl='df')


def test_set_backend():
    assert config.get_backend() == 'auto'
    try:
        config.set_backend('gpu')
        assert config.get_backend() == 'gpu'
        config.set_backend('cpu')
        assert config.default_device().platform == 'cpu'
        with pytest.raises(ValueError):
            config.set_backend('metal')
        assert config.get_backend() == 'cpu'
    finally:
        config.set_backend('auto')


def test_compile_cache_dir_rule(monkeypatch):
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    assert config.compile_cache_dir() == os.path.join(REPO, '.jax_cache')
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', '/some/cache')
    assert config.compile_cache_dir() == '/some/cache'


def _child(code, env_extra, drop=()):
    env = dict(os.environ, **env_extra)
    for k in drop:
        env.pop(k, None)
    return subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize('from_env', [False, True])
def test_compile_cache_dir_in_a_fresh_process(tmp_path, from_env):
    # with JAX_COMPILATION_CACHE_DIR set the package sets no directory of
    # its own; without it the cache is the fixed path in the checkout
    code = ('import pyiga_jax, jax; '
            'print(jax.config.jax_compilation_cache_dir)')
    if from_env:
        out = _child(code, {'JAX_COMPILATION_CACHE_DIR': str(tmp_path)})
        want = str(tmp_path)
    else:
        out = _child(code, {}, drop=('JAX_COMPILATION_CACHE_DIR',))
        want = os.path.join(REPO, '.jax_cache')
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == want


def test_cpu_executables_stay_out_of_the_cache(tmp_path):
    code = ('import pyiga_jax, jax, jax.numpy as jnp; '
            'jax.config.update("jax_persistent_cache_min_compile_time_secs",'
            ' 0.0); '
            'print(float(jax.jit(lambda x: jnp.sin(x) * 2)(1.0)))')
    out = _child(code, {'JAX_COMPILATION_CACHE_DIR': str(tmp_path),
                        'JAX_PLATFORMS': 'cpu'})
    assert out.returncode == 0, out.stderr[-2000:]
    assert not [f for f in os.listdir(tmp_path)
                if not f.startswith('.')], os.listdir(tmp_path)


def test_make_mesh_raises_with_too_few_devices():
    n = len(jax.devices())
    with pytest.raises(RuntimeError, match='requested %d devices' % (n + 1)):
        parallel.make_mesh(n + 1)
    assert parallel.make_mesh(n).devices.size == n


def _run_script(script, cwd, env_extra):
    env = dict(os.environ, JAX_PLATFORMS='cpu', **env_extra)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    return out, time.perf_counter() - t0


@pytest.mark.parametrize('script', ['chip_smoke.py', 'bench.py'])
def test_card_scripts_fail_without_gpu(script):
    out, secs = _run_script(os.path.join(REPO, script), REPO, {})
    assert out.returncode != 0
    assert 'no GPU found' in out.stderr
    assert '"ok": true' not in out.stdout
    assert secs < 60


def test_chip_smoke_alone_fails(tmp_path):
    # a directory holding chip_smoke.py and nothing else of the repo
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
    out, _ = _run_script('chip_smoke.py', str(tmp_path), {})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
