"""Run the reference's own test suite against pyiga_jax (module alias).

The strongest drop-in parity check we have: every upstream behavior test
must pass with ``pyiga`` aliased to ``pyiga_jax``.  Skipped when the
read-only reference checkout is not present (e.g. public CI).
"""
import os
import subprocess
import sys

import pytest

REF = '/root/reference/test'


@pytest.mark.slow
@pytest.mark.skipif(not os.path.isdir(REF),
                    reason='reference checkout not available')
def test_reference_suite_passes():
    script = os.path.join(os.path.dirname(__file__), os.pardir,
                          'scripts', 'refcompat.py')
    rc = subprocess.call([sys.executable, script, REF])
    assert rc == 0
