#!/usr/bin/env python
"""Wipe the persistent XLA compilation cache used by pyiga_jax.

The analog of the reference's scripts/clear-cache.py (which wipes its
on-disk compiled-module cache).  The cache directory is
``config.compile_cache_dir()``: ``JAX_COMPILATION_CACHE_DIR`` when set,
else ``.jax_cache`` at the root of the checkout (see pyiga_jax/config.py).
"""

import os
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from pyiga_jax import config     # noqa: E402


def main():
    path = config.compile_cache_dir()
    if os.path.isdir(path):
        n = sum(len(files) for _, _, files in os.walk(path))
        shutil.rmtree(path)
        print('removed %s (%d cached entries)' % (path, n))
    else:
        print('nothing to remove at %s' % path)


if __name__ == '__main__':
    main()
