#!/usr/bin/env python
"""CLI: parse a variational-form expression string and dump its lowered
assembly plan (the analog of the reference's scripts/str2asm.py which dumped
generated Cython source — here the 'code' is a contraction plan).

Usage:
    python scripts/str2asm.py "inner(grad(u), grad(v)) * dx" --dim 2

Installed entry point: ``pyiga-jax-str2asm`` (see pyproject.toml).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from pyiga_jax._cli import str2asm_main  # noqa: E402

if __name__ == '__main__':
    str2asm_main()
