#!/usr/bin/env python
"""Run the *reference's own test suite* against pyiga_jax.

Aliases ``pyiga`` -> ``pyiga_jax`` in ``sys.modules`` and executes the
upstream test files (from a read-only checkout of c-f-h/pyiga, default
``/root/reference/test``) under pytest.  Passing means a user of the
reference can switch imports and keep their code — the strongest parity
check we have.

Exclusions (architecture, not behavior):
  * ``test_codegen.py`` — targets the reference's Cython source generator;
    this rebuild lowers vforms to XLA contraction plans (pyiga_jax/compile.py)
    and has no ``pyiga.codegen`` module.
  * ``test_vform.py::test_tostring`` — asserts internal ``__str__`` spellings
    that the reference itself labels "implementation detail of current
    generators".

Usage:  python scripts/refcompat.py [path-to-reference-test-dir]
"""
import importlib
import os
import shutil
import subprocess
import sys
import tempfile

SUBMODULES = [
    'bspline', 'geometry', 'assemble', 'vform', 'tensor', 'kronecker',
    'utils', 'operators', 'approx', 'solvers', 'hierarchical', 'lowrank',
    'mlmatrix', 'vis', 'spline', 'stilde', 'quadrature', 'assemblers',
    'compile', 'config',
]

CONFTEST = '''\
import sys, importlib
sys.path.insert(0, {repo!r})
import pyiga_jax
sys.modules['pyiga'] = pyiga_jax
for sub in {subs!r}:
    sys.modules['pyiga.' + sub] = importlib.import_module('pyiga_jax.' + sub)
'''


def main():
    ref = sys.argv[1] if len(sys.argv) > 1 else '/root/reference/test'
    if not os.path.isdir(ref):
        print('reference test dir %s not found; nothing to do' % ref)
        return 0
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tmp = tempfile.mkdtemp(prefix='refcompat_')
    try:
        for fn in os.listdir(ref):
            if (fn.startswith('test_') and fn.endswith('.py')
                    and fn != 'test_codegen.py') or fn.endswith('.mtx.gz'):
                shutil.copy(os.path.join(ref, fn), tmp)
        open(os.path.join(tmp, '__init__.py'), 'w').close()
        with open(os.path.join(tmp, 'conftest.py'), 'w') as f:
            f.write(CONFTEST.format(repo=repo, subs=SUBMODULES))
        env = dict(os.environ)
        env['JAX_PLATFORMS'] = 'cpu'
        rc = subprocess.call(
            [sys.executable, '-m', 'pytest', tmp, '-q', '-p',
             'no:cacheprovider', '-k', 'not test_tostring'],
            env=env)
        return rc
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == '__main__':
    sys.exit(main())
