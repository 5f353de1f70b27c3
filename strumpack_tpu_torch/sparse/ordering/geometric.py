"""Geometric nested dissection for regular nx x ny x nz grids.

Role of the reference's ``sparse/ordering/GeometricReordering.cpp:43-107``
(recursive coordinate bisection with a planar separator of the stencil
``width``, building permutation + separator tree directly).  Supports
multiple dofs per grid point (``components``) and stencil ``width`` like the
reference's --sp_nx/--sp_ny/--sp_nz/--sp_components/--sp_separator_width.
"""
from __future__ import annotations

import numpy as np

from ..separator_tree import TreeAssembler


def geometric_nd(nx: int, ny: int = 1, nz: int = 1, components: int = 1,
                 width: int = 1, leaf: int = 4):
    """Return (perm, iperm, SeparatorTree) for a nx*ny*nz*components grid.

    Vertex (x,y,z,c) has natural index c + components*(z + nz*(y + ny*x))
    matching a row-major (x outer) grid numbering; the separator of each
    bisection is a full hyperplane of thickness ``width`` orthogonal to the
    longest grid dimension.
    """
    tb = TreeAssembler()

    def vid(xs, ys, zs):
        base = (((xs[:, None] * ny + ys[None, :])[:, :, None] * nz
                 + zs[None, None, :]).ravel() * components)
        if components == 1:
            return base
        return (base[:, None] + np.arange(components)[None, :]).ravel()

    def rec(x0, x1, y0, y1, z0, z1):
        dims = (x1 - x0, y1 - y0, z1 - z0)
        npts = dims[0] * dims[1] * dims[2]
        if npts <= leaf or max(dims) <= width:
            lo, hi = tb.emit(vid(np.arange(x0, x1), np.arange(y0, y1),
                                 np.arange(z0, z1)))
            return tb.add_node(lo, hi, -1, -1)
        ax = int(np.argmax(dims))
        lohi = [(x0, x1), (y0, y1), (z0, z1)]
        a0, a1 = lohi[ax]
        mid = (a0 + a1 - width) // 2  # separator occupies [mid, mid+width)
        l_rng = list(lohi)
        r_rng = list(lohi)
        s_rng = list(lohi)
        l_rng[ax] = (a0, mid)
        r_rng[ax] = (mid + width, a1)
        s_rng[ax] = (mid, mid + width)
        left = rec(l_rng[0][0], l_rng[0][1], l_rng[1][0], l_rng[1][1],
                   l_rng[2][0], l_rng[2][1]) if mid > a0 else -1
        right = rec(r_rng[0][0], r_rng[0][1], r_rng[1][0], r_rng[1][1],
                    r_rng[2][0], r_rng[2][1]) if a1 > mid + width else -1
        lo, hi = tb.emit(vid(np.arange(s_rng[0][0], s_rng[0][1]),
                             np.arange(s_rng[1][0], s_rng[1][1]),
                             np.arange(s_rng[2][0], s_rng[2][1])))
        return tb.add_node(lo, hi, left, right)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        rec(0, nx, 0, ny, 0, nz)
    finally:
        sys.setrecursionlimit(old)
    return tb.finish(nx * ny * nz * components)
