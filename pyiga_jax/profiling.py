# -*- coding: utf-8 -*-
"""Lightweight timing and profiling helpers.

The reference has no built-in profiling beyond ACA's verbose pivot log and
tqdm progress bars (SURVEY 5.1); the equivalents here are

* :func:`timed` / :class:`Timings` — wall-clock phase timers that wait for
  the device (``jax.block_until_ready``) on a result passed to sync on;
* :func:`trace` — a ``jax.profiler`` trace context writing a TensorBoard-
  readable profile directory.
"""

import contextlib
import time

import numpy as np


class Timings:
    """Accumulates named phase timings; ``report()`` prints a table."""

    def __init__(self):
        self.records = {}

    def add(self, label, seconds):
        self.records.setdefault(label, []).append(seconds)

    @contextlib.contextmanager
    def __call__(self, label, sync=None):
        with _timed_box(sync) as box:
            yield box
        self.add(label, box['seconds'])

    def report(self, stream=None):
        import sys
        out = stream or sys.stdout
        for label, ts in self.records.items():
            ts = np.asarray(ts)
            out.write('%-32s %3d calls  best %8.2f ms  mean %8.2f ms\n'
                      % (label, len(ts), 1e3 * ts.min(), 1e3 * ts.mean()))


@contextlib.contextmanager
def _timed_box(sync):
    """Shared timing protocol of :func:`timed` and :class:`Timings`:
    device-synchronize on the block's result, record elapsed seconds."""
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        result = box.get('result', sync)
        if result is not None:
            import jax
            jax.block_until_ready(result)
        box['seconds'] = time.perf_counter() - t0


@contextlib.contextmanager
def timed(label='elapsed', sync=None, verbose=True):
    """Time a block; pass ``sync=result`` (or set ``box['result']``) to
    synchronize on device values before stopping the clock.

    >>> with timed('assembly') as box:
    ...     box['result'] = asm.assemble()
    """
    with _timed_box(sync) as box:
        yield box
    if verbose:
        print('%s: %.2f ms' % (label, 1e3 * box['seconds']))


@contextlib.contextmanager
def trace(logdir):
    """``jax.profiler`` trace context (TensorBoard format)."""
    import jax

    jax.profiler.start_trace(str(logdir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()
