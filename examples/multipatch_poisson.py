# -*- coding: utf-8 -*-
"""Poisson on an L-shaped domain built from three unit-square patches
(reference notebook: multipatch.ipynb): interfaces are matched
automatically, shared dofs get a union numbering, per-patch stiffness
matrices are assembled on device and scattered into the global system."""

import os
import sys

import numpy as np
import scipy.sparse.linalg

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from pyiga_jax import bspline, geometry, vform
from pyiga_jax.assemble import Multipatch, RestrictedLinearSystem


def main(p=2, n=8):
    kvs = 2 * (bspline.make_knots(p, 0.0, 1.0, n),)
    squ = geometry.unit_square()
    patches = [(kvs, squ),
               (kvs, squ.translate((1, 0))),
               (kvs, squ.translate((1, 1)))]
    MP = Multipatch(patches, automatch=True)
    print('patches: %d, global dofs: %d' % (MP.numpatches, MP.numdofs))

    A, b = MP.assemble_system(vform.stiffness_vf(2),
                              vform.L2functional_vf(2, physical=True),
                              f=lambda x, y: 1.0)

    # homogeneous Dirichlet on the entire outer boundary
    zero = lambda x, y: 0.0
    outer = [(0, 'left', zero), (0, 'bottom', zero), (0, 'top', zero),
             (1, 'bottom', zero), (1, 'right', zero),
             (2, 'left', zero), (2, 'top', zero), (2, 'right', zero)]
    bcidx, bcvals = MP.compute_dirichlet_bcs(outer)
    LS = RestrictedLinearSystem(A, b, (bcidx, bcvals))
    u = LS.complete(scipy.sparse.linalg.spsolve(LS.A.tocsc(), LS.b))

    print('interior residual (free dofs): %.2e'
          % (np.linalg.norm(LS.R_free @ (A @ u - b)) / np.linalg.norm(b)))
    print('max u = %.6f (positive source, zero boundary)' % u.max())
    assert u.max() > 0 and np.all(np.isfinite(u))

    # the solution is continuous across the interfaces by construction:
    # evaluate both patches on the shared edge and compare
    u0 = (MP.global_to_patch(0) @ u).reshape((n + p,) * 2)
    u1 = (MP.global_to_patch(1) @ u).reshape((n + p,) * 2)
    f0 = bspline.BSplineFunc(kvs, u0).grid_eval(
        (np.linspace(0, 1, 17), np.array([1.0])))
    f1 = bspline.BSplineFunc(kvs, u1).grid_eval(
        (np.linspace(0, 1, 17), np.array([0.0])))
    jump = np.abs(f0 - f1).max()
    print('interface jump: %.2e' % jump)
    assert jump < 1e-12
    return u


if __name__ == '__main__':
    main()
