"""Right-hand-side loads of the fused kernels, built in torch.

The TPU kernels evaluate a problem's Python hooks (``source_xy``,
``robin_g_xy``) inside the kernel, on coordinates rebuilt from iotas. A
Python hook cannot be compiled into an ``nvcc`` kernel, so here each load
is built in torch from the problem's own hook on the same coordinates
(:func:`family_coordinates`) and handed to the kernels as (3, n, n) planes
that they add to the right-hand side:

- :class:`EmissionLoads`: the source load ``dt M s`` of every sourced
  species, on the whole canvas (kernels B1, B2, B4, B6);
- :class:`RobinFluxLoads`: the inhomogeneous Robin flux load
  ``dt g(mid_e, t) |e|`` on the wall lines only (kernel B4), added into a
  plane that may also carry a source load, O(n) work per step.

Both are linear in the state-free data, so a sum of them is one plane.
"""

from __future__ import annotations

import torch

#: (x, y) offsets of each family's DOF from its cell's lower-left vertex,
#: in mesh steps: H edges at (i + 1/2, j), V at (i, j + 1/2), D at the
#: cell centre.
FAMILY_OFFSETS = ((0.5, 0.0), (0.0, 0.5), (0.5, 0.5))


def family_coordinates(n: int, grid, dtype, device, row0: int = 0,
                       rows: int | None = None):
    """(X, Y): the (3, n, n) canvases of each family's DOF coordinates,
    ``x = xmin + (col + ox) h`` and ``y = ymin + (row + oy) h`` with the
    offsets of :data:`FAMILY_OFFSETS`, the coordinates the TPU kernels
    rebuild from iotas; ``grid = (xmin, ymin, h)``
    (mesh.data.structured_grid). Cells outside a family's grid get
    coordinates too; every load is masked to zero there. ``rows``: the
    (3, rows, n) coordinates of a row block whose row 0 is the global row
    ``row0`` (the counterpart of the TPU kernel's global iotas in its
    sharded-block mode), equal to the whole canvas's on every global row."""
    xmin, ymin, h = (float(g) for g in grid)
    idx = torch.arange(n, dtype=dtype, device=device)
    r = idx if rows is None else torch.arange(row0, row0 + rows, dtype=dtype,
                                              device=device)
    shape = (r.shape[0], n)
    X = torch.stack([(xmin + (idx + ox) * h).expand(shape)
                     for ox, _ in FAMILY_OFFSETS])
    Y = torch.stack([(ymin + (r + oy) * h)[:, None].expand(shape)
                     for _, oy in FAMILY_OFFSETS])
    return X, Y


class EmissionLoads:
    """The per-species emission loads of a fused solve, as the kernels
    take them: one (3, n, n) plane per sourced species in ``planes`` (an
    (n_src, 3, n, n) tensor, None when no species is sourced), and
    ``index[k]``, the plane of species k or -1.

    A species' load for the step that ends at time t is, on each family
    canvas, ``(dt M) s`` (mass-lumped: ``mass3`` is the masked mass, zero
    on Dirichlet rows and dead DOFs) or ``mask (dt s)`` (the reference
    quadrature: the family rectangle ``masks``), with ``s = source_fn(X, Y,
    t)``, and zero on dead DOFs (``live`` 0 there) under either rule.
    Backward Euler samples t; Crank-Nicolson takes the trapezoid of t and
    t - dt. A steady species' plane is built once (its trapezoid 0.5 (a +
    a) is a exactly); :meth:`advance` rebuilds the others for the next
    step, in place, before that step's launches. Step j (counted from 1)
    ends at ``t0 + dt j``. ``mass3``, ``masks`` and ``live`` may be the
    (3, rows, n) rows of a row block whose row 0 is the global row
    ``row0``: the planes are then that block's (family_coordinates).
    """

    def __init__(self, source_fns, steady, *, grid, dt, t0, use_ka,
                 lumped, mass3, masks, live=None, row0=0):
        self.index = []
        self._fns = []
        self._X, self._Y = family_coordinates(
            masks.shape[-1], grid, masks.dtype, masks.device, row0=row0,
            rows=masks.shape[-2])
        self._dt, self._t0, self._use_ka = float(dt), float(t0), use_ka
        self._lumped, self._mass3, self._masks = lumped, mass3, masks
        self._live = live
        self._step = 0
        for fn, st in zip(source_fns, steady):
            if fn is None:
                self.index.append(-1)
            else:
                self.index.append(len(self._fns))
                self._fns.append((fn, bool(st)))
        self.steady = all(st for _, st in self._fns)
        self.planes = None
        if self._fns:
            self.planes = torch.stack([self._load(fn, self._t0 + self._dt)
                                       for fn, _ in self._fns])

    def _at(self, fn, t):
        s = fn(self._X, self._Y, t)
        if self._lumped:
            load = (self._dt * self._mass3) * s
        else:
            load = self._masks * (self._dt * s)
        return load if self._live is None else load * self._live

    def _load(self, fn, t):
        if not self._use_ka:
            return self._at(fn, t)
        return 0.5 * (self._at(fn, t) + self._at(fn, t - self._dt))

    def advance(self):
        """Planes for the next step (steps count from 1)."""
        self._step += 1
        if self._step > 1:
            t = self._t0 + self._dt * self._step
            for j, (fn, steady) in enumerate(self._fns):
                if not steady:
                    self.planes[j].copy_(self._load(fn, t))
        return self.planes

    def window(self, count):
        """The planes of the next ``count`` steps, one per step:
        (count, n_src, 3, n, n)."""
        return torch.stack([self.advance().clone() for _ in range(count)])


#: The wall lines of the family canvases: (side, family, line). H edges
#: lie on the bottom / top walls in rows 0 / c, V edges on the left /
#: right walls in columns 0 / c; D edges never lie on a wall.
WALL_LINES = (("bottom", 0, 0), ("top", 0, None), ("left", 1, 0),
              ("right", 1, None))


class RobinFluxLoads:
    """The inhomogeneous Robin flux load ``dt g(mid_e, t) |e|`` of a fused
    canvas solve on the wall lines of ``sides``, the one-point edge
    quadrature of the scan path's Robin load (|e| = h on a wall edge).

    ``g_fn(x, y, t, side)`` is the problem's elementwise ``robin_g_xy``,
    evaluated on the wall edges' midpoints; each line is multiplied by the
    (Robin-widened) family rectangle ``masks`` and by ``live`` (0 on
    obstacle dead DOFs, as the scan path masks its load). Backward Euler
    samples t; Crank-Nicolson always takes the trapezoid of t and t - dt
    (g may depend on t). Only the O(n) wall lines are built per step.
    ``masks`` and ``live`` may be the (3, rows, n) rows of a row block
    whose row 0 is the global row ``row0``: the walls are then the block's
    part of them, at global coordinates.
    """

    def __init__(self, g_fn, sides, *, grid, dt, use_ka, masks, live=None,
                 row0=0):
        n, rows = masks.shape[-1], masks.shape[-2]
        c = n - 1
        xmin, ymin, h = (float(g) for g in grid)
        dtype, device = masks.dtype, masks.device
        self._g_fn, self._dt, self._h = g_fn, float(dt), h
        self._use_ka = use_ka
        idx = torch.arange(n, dtype=dtype, device=device)
        r = torch.arange(row0, row0 + rows, dtype=dtype, device=device)
        self._walls = []
        for side, fam, line in WALL_LINES:
            if side not in sides:
                continue
            line = c if line is None else line
            if fam == 0:  # H: y fixed on the wall, x varies along the row
                if not 0 <= line - row0 < rows:
                    continue  # the wall row lies outside the block
                sel = (0, line - row0, slice(None))
                x = xmin + (idx + 0.5) * h
                y = torch.full_like(idx, ymin + line * h)
            else:  # V: x fixed on the wall, y varies along the column
                sel = (1, slice(None), line)
                x = torch.full_like(r, xmin + line * h)
                y = ymin + (r + 0.5) * h
            m = masks[sel] if live is None else masks[sel] * live[sel]
            self._walls.append((side, sel, x, y, m))

    def _line(self, side, x, y, m, t):
        return m * (self._dt * (self._g_fn(x, y, t, side) * self._h))

    def add(self, plane, base, t):
        """Write ``base + load(t)`` into ``plane`` on every wall line for
        the step that ends at t (``base`` None counts as 0; it may be
        ``plane`` itself). The rest of ``plane`` is left as it is."""
        for side, sel, x, y, m in self._walls:
            gl = self._line(side, x, y, m, t)
            if self._use_ka:
                gl = 0.5 * (gl + self._line(side, x, y, m, t - self._dt))
            plane[sel] = gl if base is None else base[sel] + gl
