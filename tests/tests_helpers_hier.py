from pyiga_jax import bspline
from pyiga_jax.hierarchical import HSpace


def example_hspace2(p=2, n0=4):
    hs = HSpace(2 * (bspline.make_knots(p, 0.0, 1.0, n0),))
    hs.refine_region(0, lambda x, y: x > 0.5 and y > 0.5)
    return hs
