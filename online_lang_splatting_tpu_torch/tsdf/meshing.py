"""Isosurface meshing of TSDF volumes: marching cubes + Surface Nets (a copy
of tsdf/meshing.py for the port, which imports nothing of the JAX package).

The JAX package meshes on the host in numpy, and so does the port: the
same constructed 256-case marching-cubes table, the same vertex placement
(the linear-interpolation zero crossings of grid edges) and the same
Surface Nets, so both packages give identical meshes from identical
volumes. `extract_mesh` reads the port's TSDFVolume; `write_mesh_ply`
writes the same bytes as the JAX package's, through numpy records instead
of one `struct.pack` per vertex.

Per configuration the triangulation is built from first principles:
contour segments on each cube face (ambiguous 4-crossing faces resolved by
isolating the positive corners, a face-local rule shared by both cells of
the face, so meshes stay watertight), chained into closed polygons,
oriented outward, and fan-triangulated. Per-vertex features are sampled
from the feature volume.
"""

from __future__ import annotations

import functools

import numpy as np

# Cell-corner offsets and the 12 cube edges as corner-index pairs.
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]]
)
_EDGES = np.array(
    [[0, 1], [2, 3], [4, 5], [6, 7], [0, 2], [1, 3], [4, 6], [5, 7],
     [0, 4], [1, 5], [2, 6], [3, 7]]
)


# Cube faces as cyclically ordered corner quads (corner index = x+2y+4z).
_FACE_LOOPS = [
    (0, 2, 6, 4),  # x = 0
    (1, 3, 7, 5),  # x = 1
    (0, 1, 5, 4),  # y = 0
    (2, 3, 7, 6),  # y = 1
    (0, 1, 3, 2),  # z = 0
    (4, 5, 7, 6),  # z = 1
]

_EDGE_OF_PAIR = {
    (min(a, b), max(a, b)): e for e, (a, b) in enumerate(_EDGES)
}


def _config_triangles(config: int):
    """Triangulation (list of local-edge-index triples) for one corner-sign
    configuration. bit c of `config` set <=> corner c is positive (> level).

    Per face, contour segments pair the crossed edges bounding each
    cyclically-contiguous run of positive corners (on an ambiguous
    alternating face this isolates the positive corners). Every crossed
    edge lies on two faces -> two segment partners -> the segments chain
    into disjoint closed polygons. Each polygon is oriented so its normal
    points toward the positive side, then fan-triangulated."""
    pos = [(config >> c) & 1 == 1 for c in range(8)]
    if all(pos) or not any(pos):
        return []

    # Segment partners per crossed edge.
    partners: dict[int, list[int]] = {}
    for loop in _FACE_LOOPS:
        k = len(loop)
        # Crossed edge after corner i (between loop[i] and loop[i+1]).
        crossed = [
            _EDGE_OF_PAIR[
                (min(loop[i], loop[(i + 1) % k]),
                 max(loop[i], loop[(i + 1) % k]))
            ] if pos[loop[i]] != pos[loop[(i + 1) % k]] else None
            for i in range(k)
        ]
        # Runs of positive corners: segment connects the crossed edge
        # entering the run with the one leaving it.
        for i in range(k):
            if pos[loop[i]] and not pos[loop[i - 1]]:
                j = i
                while pos[loop[(j + 1) % k]]:
                    j += 1
                e_in = crossed[(i - 1) % k]
                e_out = crossed[j % k]
                partners.setdefault(e_in, []).append(e_out)
                partners.setdefault(e_out, []).append(e_in)

    # Chain segments into closed polygons.
    mid = {
        e: (_CORNERS[a] + _CORNERS[b]) / 2.0 for e, (a, b) in enumerate(_EDGES)
    }
    unvisited = set(partners)
    tris = []
    while unvisited:
        start = min(unvisited)
        cycle = [start]
        prev, cur = None, start
        while True:
            a, b = partners[cur]
            nxt = b if a == prev else a
            if nxt == start:
                break
            cycle.append(nxt)
            prev, cur = cur, nxt
        unvisited -= set(cycle)
        pts = [mid[e] for e in cycle]
        # Newell normal of the polygon.
        nrm = np.zeros(3)
        for i in range(len(pts)):
            p0, p1 = pts[i], pts[(i + 1) % len(pts)]
            nrm += np.cross(p0, p1)
        # Orient toward the positive side: across each of THIS cycle's
        # crossed edges the implicit function increases negative->positive
        # corner, so the outward normal has positive dot with that edge
        # direction; sum over the cycle's own edges (a global +/- centroid
        # difference degenerates on symmetric configs).
        outward = np.zeros(3)
        for e in cycle:
            a, b = _EDGES[e]
            p_c, n_c = (a, b) if pos[a] else (b, a)
            outward = outward + (_CORNERS[p_c] - _CORNERS[n_c])
        if float(np.dot(nrm, outward)) < 0.0:
            cycle.reverse()
        for i in range(1, len(cycle) - 1):
            tris.append((cycle[0], cycle[i], cycle[i + 1]))
    return tris


@functools.cache
def _mc_tables():
    """(256, MAXT, 3) int8 triangle table (local edge indices, -1 pad)."""
    per_cfg = [_config_triangles(cfg) for cfg in range(256)]
    maxt = max(len(t) for t in per_cfg)
    table = np.full((256, maxt, 3), -1, np.int8)
    for cfg, tris in enumerate(per_cfg):
        for i, tri in enumerate(tris):
            table[cfg, i] = tri
    return table


def marching_cubes(tsdf: np.ndarray, weights: np.ndarray | None = None,
                   level: float = 0.0):
    """Classic marching cubes. tsdf: (X, Y, Z) signed distance grid →
    (verts (V,3) in voxel coords, faces (F,3) int, facing the positive
    side). Vertices are the linear-interpolation zero crossings of grid
    edges — the same placement as skimage.measure.marching_cubes. Unobserved voxels
    (weight 0) are treated as outside and, as in `surface_nets`, only
    fully-observed cells emit geometry (no phantom truncation shell)."""
    vol = tsdf.astype(np.float32).copy()
    observed = np.ones(vol.shape, bool) if weights is None else weights > 0
    vol[~observed] = 1.0
    x, y, z = vol.shape
    dims = np.array([x, y, z])

    # Global edge-crossing vertices, one id grid per axis.
    eids, verts = [], []
    n_total = 0
    for axis in range(3):
        sl0 = tuple(slice(0, d - (1 if a == axis else 0))
                    for a, d in enumerate(dims))
        sl1 = tuple(slice(1 if a == axis else 0, None)
                    for a in range(3))
        v0, v1 = vol[sl0], vol[sl1]
        cross = (v0 > level) != (v1 > level)
        eid = np.full(v0.shape, -1, np.int64)
        n = int(cross.sum())
        eid[cross] = n_total + np.arange(n)
        n_total += n
        base = np.argwhere(cross).astype(np.float64)
        t = (level - v0[cross]) / (v1[cross] - v0[cross])
        base[:, axis] += t
        eids.append(eid)
        verts.append(base)
    verts = (np.concatenate(verts, axis=0) if n_total
             else np.zeros((0, 3)))

    # Per-cell corner signs / observedness.
    corners = np.stack(
        [vol[dx: x - 1 + dx, dy: y - 1 + dy, dz: z - 1 + dz]
         for dx, dy, dz in _CORNERS], axis=-1)
    obs_c = np.stack(
        [observed[dx: x - 1 + dx, dy: y - 1 + dy, dz: z - 1 + dz]
         for dx, dy, dz in _CORNERS], axis=-1)
    signs = corners > level
    active = signs.any(-1) & ~signs.all(-1) & obs_c.all(-1)
    cells = np.argwhere(active)
    if len(cells) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    config = (signs[active] << np.arange(8)).sum(-1)

    # Local edge -> global vertex id, per active cell. Edge e runs from
    # corner a along its axis; its crossing lives at cell + _CORNERS[a]
    # in that axis' id grid.
    cell_edges = np.empty((len(cells), 12), np.int64)
    for e, (a, b) in enumerate(_EDGES):
        axis = int(np.argmax(_CORNERS[b] - _CORNERS[a]))
        at = cells + _CORNERS[a]
        cell_edges[:, e] = eids[axis][at[:, 0], at[:, 1], at[:, 2]]

    table = _mc_tables()
    tris = table[config]                       # (N, MAXT, 3) local edges
    valid = tris[:, :, 0] >= 0
    tri_edges = tris[valid]                    # (F, 3)
    rows = np.broadcast_to(
        np.arange(len(cells))[:, None], valid.shape)[valid]
    faces = cell_edges[rows[:, None], tri_edges]
    # Compact: crossings on edges of non-emitting cells (e.g. the
    # truncation back shell) are never referenced — drop them.
    used = np.unique(faces)
    remap = np.full(n_total, -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces]


def surface_nets(tsdf: np.ndarray, weights: np.ndarray | None = None,
                 level: float = 0.0):
    """tsdf: (X, Y, Z) signed distance grid → (verts (V,3) in voxel coords,
    faces (F,3) int). Unobserved voxels (weight 0) are treated as outside."""
    vol = tsdf.astype(np.float32).copy()
    observed = np.ones(vol.shape, bool) if weights is None else weights > 0
    vol[~observed] = 1.0
    x, y, z = vol.shape
    # Corner samples for every cell.
    corners = np.stack(
        [vol[dx : x - 1 + dx, dy : y - 1 + dy, dz : z - 1 + dz]
         for dx, dy, dz in _CORNERS],
        axis=-1,
    )  # (X-1, Y-1, Z-1, 8)
    obs_c = np.stack(
        [observed[dx : x - 1 + dx, dy : y - 1 + dy, dz : z - 1 + dz]
         for dx, dy, dz in _CORNERS],
        axis=-1,
    )
    signs = corners > level
    # Cells touching unobserved space would mesh the truncation boundary
    # (a phantom back shell); only fully-observed cells emit geometry.
    active = signs.any(-1) & ~signs.all(-1) & obs_c.all(-1)
    idx = np.full(active.shape, -1, np.int64)
    cells = np.argwhere(active)
    idx[active] = np.arange(len(cells))

    # Vertex position: centroid of edge zero-crossings within the cell.
    c = corners[active]  # (N, 8)
    pos_acc = np.zeros((len(cells), 3))
    cnt = np.zeros((len(cells), 1))
    for e0, e1 in _EDGES:
        v0, v1 = c[:, e0], c[:, e1]
        cross = (v0 > level) != (v1 > level)
        t = np.where(cross, (level - v0) / np.where(cross, v1 - v0, 1.0), 0.0)
        p = _CORNERS[e0] + t[:, None] * (_CORNERS[e1] - _CORNERS[e0])
        pos_acc += np.where(cross[:, None], p, 0.0)
        cnt += cross[:, None]
    verts = cells + pos_acc / np.maximum(cnt, 1)

    # Quads: for each volume edge along axis a with a sign change, connect
    # the 4 cells sharing that edge.
    faces = []
    for axis, (d1, d2) in enumerate([((0, 1, 0), (0, 0, 1)),
                                     ((1, 0, 0), (0, 0, 1)),
                                     ((1, 0, 0), (0, 1, 0))]):
        step = np.zeros(3, int)
        step[axis] = 1
        a = vol[1 : x - 1, 1 : y - 1, 1 : z - 1]
        sl = tuple(
            slice(1 + s, dim - 1 + s)
            for s, dim in zip(step, (x, y, z))
        )
        b = vol[sl]
        change = (a > level) != (b > level)
        flip = a[change] > level
        base = np.argwhere(change) + 1  # grid coords of edge start
        d1 = np.asarray(d1)
        d2 = np.asarray(d2)
        q = []
        for off in [d1 + d2, d2, np.zeros(3, int), d1]:
            cell = base - off
            q.append(idx[cell[:, 0], cell[:, 1], cell[:, 2]])
        q = np.stack(q, axis=1)  # (M, 4)
        ok = (q >= 0).all(axis=1)
        q, fl = q[ok], flip[ok]
        tri1 = np.where(fl[:, None], q[:, [0, 1, 2]], q[:, [0, 2, 1]])
        tri2 = np.where(fl[:, None], q[:, [0, 2, 3]], q[:, [0, 3, 2]])
        faces.append(tri1)
        faces.append(tri2)
    faces = np.concatenate(faces, axis=0) if faces else np.zeros((0, 3), int)
    return verts, faces


def extract_mesh(volume, level: float = 0.0, method: str = "marching_cubes"):
    """TSDFVolume -> (verts world coords, faces, per-vertex features).

    method: "marching_cubes" (default) or "surface_nets"."""
    tsdf, feats = volume.get_volume()
    w = volume.get_weights()
    mesher = marching_cubes if method == "marching_cubes" else surface_nets
    verts, faces = mesher(tsdf, w, level)
    vi = np.clip(np.round(verts).astype(int), 0, np.asarray(volume.dims) - 1)
    vfeat = feats[:, vi[:, 0], vi[:, 1], vi[:, 2]].T
    world = volume.origin + (verts + 0.5) * volume.voxel_size
    return world.astype(np.float32), faces.astype(np.int32), vfeat


_VERT = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
_VERT_RGB = np.dtype(_VERT.descr + [("r", "u1"), ("g", "u1"), ("b", "u1")])
_FACE = np.dtype([("n", "u1"), ("i", "<i4", (3,))])


def write_mesh_ply(path, verts, faces, colors=None):
    """Triangle mesh PLY (binary little endian)."""
    n, f = len(verts), len(faces)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {f}", "property list uchar int vertex_indices",
               "end_header"]
    v = np.asarray(verts, np.float32).reshape(n, 3)
    rec = np.empty(n, _VERT if colors is None else _VERT_RGB)
    for j, c in enumerate("xyz"):
        rec[c] = v[:, j]
    if colors is not None:
        cols = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
        for j, c in enumerate("rgb"):
            rec[c] = cols[:, j]
    face = np.empty(f, _FACE)
    face["n"] = 3
    face["i"] = np.asarray(faces).reshape(f, 3)
    with open(path, "wb") as out:
        out.write(("\n".join(header) + "\n").encode())
        out.write(rec.tobytes())
        out.write(face.tobytes())
