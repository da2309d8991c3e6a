"""bench.py must print valid JSON metric lines with the expected schema.
It measures only on the GPU, so the check runs where a card is."""
import json
import os
import subprocess
import sys

import pytest


@pytest.mark.gpu
def test_bench_json_schema():
    env = dict(os.environ)
    env.pop('JAX_PLATFORMS', None)
    env.update(PYIGA_BENCH_CONFIGS='2,8,float64',
               PYIGA_BENCH_NO_ACA='1', PYIGA_BENCH_NO_VFORM='1',
               PYIGA_BENCH_NO_LOCALMG='1', PYIGA_BENCH_NO_NS='1',
               PYIGA_BENCH_NO_CPU='1')
    out = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(__file__), os.pardir,
                                      'bench.py')],
        env=env, capture_output=True, text=True, timeout=560)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith('{')]
    assert lines, out.stdout
    for ln in lines:
        rec = json.loads(ln)
        assert {'metric', 'value', 'unit', 'vs_baseline'} <= rec.keys()
        assert isinstance(rec['value'], (int, float))
