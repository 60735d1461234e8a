"""Gmsh ``.msh`` files in and out, a copy of
``airpollution_tpu/mesh/msh_io.py``.

``read_msh`` parses the two ASCII formats gmsh writes (legacy 2.2 and
4.x, 4.0 and 4.1) into a :class:`~airpollution_tpu_torch.mesh.structured.
Mesh`; ``write_msh`` writes 4.1. 2D triangulations only (element type 2):
the z coordinate is dropped, other elements are skipped, binary files are
refused. ``structured="auto"`` maps a regular grid onto the canonical
``create_mesh`` grid, directly or through a reflection (tagged
``mirror=(sx, sy)``, see mesh/mirror.py), so that it takes the stencil,
canvas and fused engines instead of the general ELL path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from airpollution_tpu_torch.mesh.structured import (Mesh, create_mesh,
                                                   orient_ccw)

__all__ = ["read_msh", "write_msh"]

_TRIANGLE = 2  # gmsh element type: 3-node triangle


def _blocks(lines: list[str]) -> dict[str, list[str]]:
    """Split a .msh file into its $Section blocks (content lines only)."""
    out: dict[str, list[str]] = {}
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("$") and not line.startswith("$End"):
            name = line[1:]
            end = f"$End{name}"
            j = i + 1
            body = []
            while j < len(lines) and lines[j].strip() != end:
                body.append(lines[j].strip())
                j += 1
            if j >= len(lines):
                raise ValueError(f"unterminated ${name} section")
            out[name] = body
            i = j + 1
        else:
            i += 1
    return out


def _parse_v2(blocks: dict[str, list[str]]) -> tuple[np.ndarray, np.ndarray]:
    """Legacy MSH 2.2 ASCII: flat node/element lists with explicit tags."""
    nodes = blocks["Nodes"]
    n_nodes = int(nodes[0])
    tags = np.empty(n_nodes, dtype=np.int64)
    pts = np.empty((n_nodes, 2), dtype=np.float64)
    for k, line in enumerate(nodes[1:1 + n_nodes]):
        parts = line.split()
        tags[k] = int(parts[0])
        pts[k, 0] = float(parts[1])
        pts[k, 1] = float(parts[2])
    index = {int(t): i for i, t in enumerate(tags)}

    elems = blocks["Elements"]
    n_elems = int(elems[0])
    tris = []
    for line in elems[1:1 + n_elems]:
        parts = line.split()
        etype = int(parts[1])
        if etype != _TRIANGLE:
            continue
        n_etags = int(parts[2])
        conn = parts[3 + n_etags:3 + n_etags + 3]
        tris.append([index[int(c)] for c in conn])
    return pts, np.asarray(tris, dtype=np.int32).reshape(-1, 3)


def _parse_v4(blocks: dict[str, list[str]],
              v40: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """MSH 4.x ASCII: entity-blocked nodes and elements. 4.1 stores a
    block's node tags first and coordinates after; 4.0 stores
    ``tag x y z`` per line (``v40``)."""
    nodes = blocks["Nodes"]
    n_blocks, n_nodes = (int(x) for x in nodes[0].split()[:2])
    tags = np.empty(n_nodes, dtype=np.int64)
    pts = np.empty((n_nodes, 2), dtype=np.float64)
    pos = 1
    k = 0
    for _ in range(n_blocks):
        n_in = int(nodes[pos].split()[3])
        pos += 1
        if v40:
            for b in range(n_in):
                parts = nodes[pos + b].split()
                tags[k + b] = int(parts[0])
                pts[k + b, 0] = float(parts[1])
                pts[k + b, 1] = float(parts[2])
            pos += n_in
        else:
            for b in range(n_in):
                tags[k + b] = int(nodes[pos + b])
            for b in range(n_in):
                parts = nodes[pos + n_in + b].split()
                pts[k + b, 0] = float(parts[0])
                pts[k + b, 1] = float(parts[1])
            pos += 2 * n_in
        k += n_in
    index = {int(t): i for i, t in enumerate(tags)}

    elems = blocks["Elements"]
    n_blocks = int(elems[0].split()[0])
    pos = 1
    tris = []
    for _ in range(n_blocks):
        hdr = elems[pos].split()
        etype, n_in = int(hdr[2]), int(hdr[3])
        pos += 1
        if etype == _TRIANGLE:
            for line in elems[pos:pos + n_in]:
                parts = line.split()
                tris.append([index[int(c)] for c in parts[1:4]])
        pos += n_in
    return pts, np.asarray(tris, dtype=np.int32).reshape(-1, 3)


def _axis_levels(v: np.ndarray, tol: float) -> np.ndarray:
    """Distinct coordinate levels, merging values within ``tol``."""
    s = np.sort(np.unique(v))
    out = [s[0]]
    for x in s[1:]:
        if x - out[-1] > tol:
            out.append(x)
    return np.asarray(out)


def _match_canonical(pts: np.ndarray, tris: np.ndarray):
    """Match ``(pts, tris)`` against the canonical create_mesh grid.

    Detection requires (a) an n x n tensor grid with uniform spacing on
    a centered square, and (b) the SAME diagonal split as create_mesh
    (every cell cut along the (v00, v11) diagonal). Triangle equality is
    checked as vertex-id sets (orientation-free; read_msh re-orients CCW
    anyway). Returns the canonical Mesh or None.
    """
    n2 = len(pts)
    n = int(round(np.sqrt(n2)))
    if n < 2 or n * n != n2 or len(tris) != 2 * (n - 1) ** 2:
        return None
    span = max(float(np.ptp(pts[:, 0])), float(np.ptp(pts[:, 1])))
    if span <= 0:
        return None
    tol = span * 1e-9
    xs = _axis_levels(pts[:, 0], tol)
    ys = _axis_levels(pts[:, 1], tol)
    if len(xs) != n or len(ys) != n:
        return None
    hx = np.diff(xs)
    hy = np.diff(ys)
    if (abs(hx - hx[0]).max() > tol or abs(hy - hy[0]).max() > tol
            or abs(hx[0] - hy[0]) > tol):
        return None
    # Centered square box [-L, L]^2 (the Domain contract).
    if (abs(xs[0] + xs[-1]) > tol or abs(ys[0] + ys[-1]) > tol
            or abs(xs[0] - ys[0]) > tol):
        return None
    L = float(xs[-1])
    canon = create_mesh(n, L)
    # Map every file node onto its canonical grid id; verify coordinates.
    ix = np.rint((pts[:, 0] - xs[0]) / hx[0]).astype(np.int64)
    iy = np.rint((pts[:, 1] - ys[0]) / hy[0]).astype(np.int64)
    if (ix < 0).any() or (ix >= n).any() or (iy < 0).any() \
            or (iy >= n).any():
        return None
    grid_id = iy * n + ix  # file node -> canonical node
    if len(np.unique(grid_id)) != n2:
        return None
    cp = np.asarray(canon.points)
    if np.abs(cp[grid_id] - pts).max() > tol:
        return None
    # Same triangle SET (as vertex-id sets) => same FE space.
    def tri_keys(t):
        return {frozenset(map(int, row)) for row in t}

    if tri_keys(grid_id[tris]) != tri_keys(np.asarray(canon.triangles)):
        return None
    return canon


def _as_structured(pts: np.ndarray, tris: np.ndarray):
    """Detect a structured grid, directly or through a reflection.

    A gmsh-exported regular grid is geometrically the grid of
    ``create_mesh`` with its nodes and triangles in another order; without
    detection it would take the general ELL path. A grid cut along the
    other cell diagonal is another finite-element space, but the
    reflection ``sigma = diag(-1, 1)`` (or ``diag(1, -1)``) maps it
    isometrically onto the canonical one (gmsh makes no promise about
    the diagonal, reference crbe.py:22-40). Such grids return the
    canonical Mesh tagged ``mirror=(sx, sy)``; solving on them needs the
    flip-solve-flip pullback (mesh/mirror.py). Grids with mixed
    diagonals match neither frame and stay on the general path. Returns
    a Mesh or None.
    """
    canon = _match_canonical(pts, tris)
    if canon is not None:
        return canon
    for flip in ((-1, 1), (1, -1)):
        canon = _match_canonical(pts * np.asarray(flip, pts.dtype), tris)
        if canon is not None:
            return dataclasses.replace(canon, mirror=flip)
    return None


def read_msh(path: str, structured: str | bool = "auto") -> Mesh:
    """Read a gmsh ASCII ``.msh`` file (2.2 or 4.x) into a :class:`Mesh`.

    ``structured``: ``"auto"`` (default) detects a regular grid and
    returns the canonical structured Mesh, which takes the stencil,
    canvas and fused engines. A grid cut along the other cell diagonal
    comes back as the canonical mesh tagged ``mirror=(sx, sy)``: solve
    the pulled-back problem and permute the field back (mesh/mirror.py;
    MeshData refuses a mirror-tagged mesh without ``mirror_ok=True``, so
    a direct solve cannot compute the reflected problem unawares).
    ``True`` requires the detection (either frame) to succeed and raises
    otherwise; ``False`` never detects (always the general path).
    Unstructured meshes come back with ``n_points_per_axis=None``.
    Triangles are reoriented CCW; non-triangle elements are skipped;
    unreferenced nodes are kept (hanging vertices with no DOFs: the CR
    DOFs live on edges of triangles).
    """
    with open(path) as f:
        raw = f.read()
    if "\x00" in raw[:256]:
        raise ValueError(
            f"{path}: binary .msh is not supported — re-export ASCII "
            f"(gmsh: File > Export with ASCII checked, or "
            f"`gmsh in.msh -save -format msh2`)"
        )
    blocks = _blocks(raw.splitlines())
    if "MeshFormat" not in blocks:
        raise ValueError(f"{path}: missing $MeshFormat — not a .msh file")
    fmt = blocks["MeshFormat"][0].split()
    version = float(fmt[0])
    if len(fmt) > 1 and int(fmt[1]) != 0:
        raise ValueError(
            f"{path}: binary .msh (file-type {fmt[1]}) is not supported "
            f"— re-export ASCII"
        )
    if "Nodes" not in blocks or "Elements" not in blocks:
        raise ValueError(f"{path}: missing $Nodes/$Elements section")
    try:
        if version >= 4.0:
            # 4.0 and 4.1 differ in the $Nodes block layout (4.0: one
            # 'tag x y z' line per node; 4.1: tags first, coords after).
            pts, tris = _parse_v4(blocks, v40=version < 4.1)
        elif version >= 2.0:
            pts, tris = _parse_v2(blocks)
        else:
            raise ValueError(f"{path}: unsupported .msh version {version}")
    except KeyError as e:
        # A triangle references a node tag absent from $Nodes — surface
        # it as a file-format error, not a raw dict lookup failure.
        raise ValueError(
            f"{path}: element references undefined node tag {e.args[0]}"
        ) from None
    if tris.shape[0] == 0:
        raise ValueError(f"{path}: no 3-node triangles in $Elements")
    if structured not in ("auto", True, False):
        raise ValueError(f"structured must be 'auto', True or False, "
                         f"got {structured!r}")
    if structured in ("auto", True):
        canon = _as_structured(pts, tris)
        if canon is not None:
            return canon
        if structured is True:
            raise ValueError(
                f"{path}: structured=True but the mesh is not a "
                f"canonical structured grid (n x n uniform centered "
                f"square with the (v00, v11) diagonal split)"
            )
    return Mesh(points=pts, triangles=orient_ccw(pts, tris),
                n_points_per_axis=None)


def write_msh(mesh: Mesh, path: str) -> str:
    """Write a :class:`Mesh` as gmsh 4.1 ASCII (one surface entity).

    Round-trips through :func:`read_msh` preserving node/triangle order,
    and loads in gmsh/meshio — the export half of the reference's
    file-based mesh pipeline (crbe.py:41 ``gmsh.write``).
    """
    pts = np.asarray(mesh.points, dtype=np.float64)
    tris = np.asarray(mesh.triangles, dtype=np.int64)
    n, t = len(pts), len(tris)
    lines = [
        "$MeshFormat", "4.1 0 8", "$EndMeshFormat",
        # One surface entity, TAG 1 (the tag the $Nodes/$Elements
        # blocks reference below): tag, 6 bbox coords, 0 physical
        # tags, 0 bounding curves.
        "$Entities", "0 0 1 0", "1 0 0 0 0 0 0 0 0", "$EndEntities",
        "$Nodes", f"1 {n} 1 {n}", f"2 1 0 {n}",
    ]
    lines += [str(i + 1) for i in range(n)]
    lines += [f"{x:.17g} {y:.17g} 0" for x, y in pts]
    lines += ["$EndNodes", "$Elements", f"1 {t} 1 {t}",
              f"2 1 {_TRIANGLE} {t}"]
    lines += [f"{i + 1} {a + 1} {b + 1} {c + 1}"
              for i, (a, b, c) in enumerate(tris)]
    lines += ["$EndElements", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path
