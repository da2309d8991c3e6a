# Sphinx configuration for pyiga_jax.
#
# Build:  pip install -r docs/requirements.txt && make -C docs html
# Mirrors the reference pyiga's docs layout (guide + API autodoc,
# /root/reference/docs) with content describing this JAX rebuild.

import os
import sys

sys.path.insert(0, os.path.abspath('../..'))

# autodoc imports pyiga_jax, which initializes JAX; force the CPU backend
# so doc builds never try to reach an accelerator.
os.environ.setdefault('JAX_PLATFORMS', 'cpu')

project = 'pyiga_jax'
copyright = '2026, the pyiga_jax authors'
author = 'the pyiga_jax authors'

extensions = [
    'sphinx.ext.autodoc',
    'sphinx.ext.autosummary',
    'sphinx.ext.mathjax',
    'sphinx.ext.napoleon',
    'sphinx.ext.viewcode',
]

autodoc_member_order = 'bysource'
autodoc_mock_imports = ['matplotlib']

templates_path = []
exclude_patterns = []

html_theme = os.environ.get('PYIGA_DOCS_THEME', 'alabaster')
html_static_path = []
