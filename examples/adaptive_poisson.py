# -*- coding: utf-8 -*-
"""Adaptive Poisson with THB-splines and the local multigrid solver
(BASELINE config 5 workload): refine toward a corner singularity, assemble
over the hierarchical space, solve with local MG, repeat."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from pyiga_jax import assemble, bspline, geometry, solvers, vform
from pyiga_jax.hierarchical import HDiscretization, HSpace


def main(p=3, n0=8, num_refinements=3, truncate=True):
    geo = geometry.unit_square()
    hs = HSpace(2 * (bspline.make_knots(p, 0.0, 1.0, n0),),
                truncate=truncate, disparity=1,
                bdspecs=[(0, 0), (0, 1), (1, 0), (1, 1)])

    for sweep in range(num_refinements):
        # refine towards the reentrant-like corner at the origin
        hs.refine_region(sweep, lambda x, y: max(x, y) < 0.5 ** sweep * 0.5)

        hd = HDiscretization(hs, vform.stiffness_vf(dim=2),
                             {'geo': geo, 'f': lambda *x: 1.0})
        A = hd.assemble_matrix()
        f = hd.assemble_rhs()

        u, iters = solvers.solve_hmultigrid(hs, A, f, strategy='cell_supp',
                                            smoother='symmetric_gs',
                                            tol=1e-8)
        print('sweep %d: levels=%d dofs=%d MG iterations=%s'
              % (sweep, hs.numlevels, hs.numdofs, iters))
    return hs, u


if __name__ == '__main__':
    main()
