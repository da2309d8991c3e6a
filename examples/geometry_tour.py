# -*- coding: utf-8 -*-
"""Tour of the geometry layer (reference notebook: geometry.ipynb):
exact NURBS conics, B-spline approximations, transforms and combinators,
with quadrature checks against closed-form areas/volumes."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from pyiga_jax import assemble, bspline, geometry


def area(geo, n=40):
    kvs = geo.sdim * (bspline.make_knots(3, 0.0, 1.0, n),)
    return assemble.integrate(kvs, lambda *x: 1.0, geo=geo)


def main():
    # exact NURBS quarter annulus: area = pi*(r2^2 - r1^2)/4
    qa = geometry.quarter_annulus(r1=1.0, r2=2.0)
    a = area(qa)
    exact = np.pi * (4 - 1) / 4
    print('quarter annulus area: %.12f (exact %.12f, err %.1e)'
          % (a, exact, abs(a - exact)))
    assert abs(a - exact) < 1e-10           # NURBS circles are exact

    # the polynomial B-spline variant is a different (coarser) domain —
    # only NURBS represent circles exactly
    qb = geometry.bspline_quarter_annulus()
    print('b-spline variant area deviation from the circle: %.3f'
          % abs(area(qb) - exact))

    # transforms compose
    big = qa.scale(2.0).rotate_2d(np.pi / 3).translate((1.0, -2.0))
    print('scaled/rotated/translated area: %.12f (expect %.12f)'
          % (area(big), 4 * exact))
    assert abs(area(big) - 4 * exact) < 1e-9

    # full disk from a NURBS circle boundary; unit cube; twisted box volume
    disk = geometry.disk(r=1.5)
    print('disk area: %.12f (exact %.12f)' % (area(disk), np.pi * 1.5**2))
    tb = geometry.twisted_box()
    print('twisted box volume: %.6f' % area(tb, n=16))

    # combinators: extrude the exact 2D domain into a 3D solid
    cyl = geometry.tensor_product(geometry.line_segment(0.0, 2.0), qa)
    v = area(cyl, n=12)
    print('cylinderized quarter annulus volume: %.10f (exact %.10f)'
          % (v, 2 * exact))
    assert abs(v - 2 * exact) < 1e-8

    # point inversion: map physical points back to parameters
    G = geometry.quarter_annulus()
    x = G.eval(0.3, 0.7)
    uv = G.find_inverse(x)
    print('find_inverse roundtrip err: %.2e'
          % np.linalg.norm(np.asarray(G.eval(*uv)) - np.asarray(x)))

    # Jacobian determinants are positive on the parameter grid
    grid = 2 * (np.linspace(0, 1, 25),)
    det = np.linalg.det(qa.grid_jacobian(grid))
    print('det J range on grid: [%.4f, %.4f]' % (det.min(), det.max()))
    assert det.min() > 0


if __name__ == '__main__':
    main()
