#!/usr/bin/env python
"""Execute every notebook in notebooks/ and report errors.

Mirror of the reference's ``run-notebooks.py`` (reference repo root), built
on nbclient instead of shelling out to ``jupyter nbconvert``.  Runs on the
CPU backend.

Usage: python scripts/run_notebooks.py [pattern ...]
"""
import os
import sys
from glob import glob

import nbformat
from nbclient import NotebookClient


def run_notebook(path, timeout=600):
    nb = nbformat.read(path, as_version=4)
    client = NotebookClient(nb, timeout=timeout, kernel_name='python3',
                            resources={'metadata': {'path':
                                                    os.path.dirname(path)}})
    errors = []
    try:
        client.execute()
    except Exception as e:          # collect, keep going with other notebooks
        errors.append(e)
    for cell in nb.cells:
        for out in cell.get('outputs', ()):
            if out.get('output_type') == 'error':
                errors.append('%s: %s' % (out.get('ename'),
                                          out.get('evalue')))
    return errors


def main():
    os.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.environ['JAX_PLATFORMS'] = 'cpu'
    patterns = sys.argv[1:] or ['notebooks/*.ipynb']
    nbfiles = sorted(f for p in patterns for f in glob(p))
    n_err = 0
    for nbfile in nbfiles:
        print('========== Running', nbfile, '==========', flush=True)
        errors = run_notebook(nbfile)
        for e in errors:
            print('ERROR:', e)
        n_err += bool(errors)
    print('%d notebooks, %d with errors' % (len(nbfiles), n_err))
    return 1 if n_err else 0


if __name__ == '__main__':
    sys.exit(main())
