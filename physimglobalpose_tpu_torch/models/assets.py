"""Mesh asset loading and preparation (host-side, numpy).

The reference consumes per-object artifacts prepared offline
(models_search/<name>/{model_search.ply, model_validation.ply, hull.ply,
PPFMap.txt}, Objects.cpp:22-49). This module regenerates them from a single
mesh: binary/ascii PLY + OBJ parsing, area-weighted surface sampling with
face normals, voxel thinning, and convex hull extraction (scipy). A numpy
copy of the JAX package's models/assets.py; the PPF table build lives in
ops/ppf.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray  # [V, 3] float32
    faces: np.ndarray  # [F, 3] int32 (triangulated)


_PLY_DTYPES = {
    "float": ("<f4", 4), "float32": ("<f4", 4), "double": ("<f8", 8),
    "uchar": ("<u1", 1), "uint8": ("<u1", 1), "char": ("<i1", 1), "int8": ("<i1", 1),
    "short": ("<i2", 2), "ushort": ("<u2", 2), "int16": ("<i2", 2), "uint16": ("<u2", 2),
    "int": ("<i4", 4), "uint": ("<u4", 4), "int32": ("<i4", 4), "uint32": ("<u4", 4),
}


def load_ply(path: str) -> Mesh:
    """Minimal PLY reader: binary_little_endian or ascii, vertex + face elements."""
    with open(path, "rb") as fh:
        data = fh.read()
    header_end = data.find(b"end_header")
    if header_end < 0:
        raise ValueError(f"not a PLY file: {path}")
    header = data[:header_end].decode("ascii", "ignore")
    body = data[header_end + len(b"end_header") + 1 :]

    fmt = "ascii"
    elements: list[tuple[str, int, list]] = []  # (name, count, [props])
    for line in header.splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append(("scalar", parts[1], parts[2]))

    if fmt == "ascii":
        return _parse_ply_ascii(body, elements)
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt}")
    return _parse_ply_binary(body, elements)


def _parse_ply_binary(body: bytes, elements) -> Mesh:
    offset = 0
    vertices = None
    faces = None
    for name, count, props in elements:
        if all(p[0] == "scalar" for p in props):
            dt = np.dtype([(f"f{i}", _PLY_DTYPES[p[1]][0]) for i, p in enumerate(props)])
            arr = np.frombuffer(body, dtype=dt, count=count, offset=offset)
            offset += dt.itemsize * count
            if name == "vertex":
                names = [p[2] for p in props]
                ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
                vertices = np.stack(
                    [arr[f"f{ix}"], arr[f"f{iy}"], arr[f"f{iz}"]], axis=1
                ).astype(np.float32)
        else:
            # Variable-length rows: walk every property; only the
            # vertex_indices list yields triangles (meshes may carry extra
            # lists like per-face texcoords - e.g. VCGLIB exports).
            tris = []
            for _ in range(count):
                for p in props:
                    if p[0] == "scalar":
                        offset += _PLY_DTYPES[p[1]][1]
                        continue
                    cnt_dt, cnt_sz = _PLY_DTYPES[p[1]]
                    idx_dt, idx_sz = _PLY_DTYPES[p[2]]
                    k = int(np.frombuffer(body, dtype=cnt_dt, count=1, offset=offset)[0])
                    offset += cnt_sz
                    if name == "face" and p[3] in ("vertex_indices", "vertex_index"):
                        idxs = np.frombuffer(body, dtype=idx_dt, count=k, offset=offset)
                        for t in range(1, k - 1):
                            tris.append((idxs[0], idxs[t], idxs[t + 1]))
                    offset += idx_sz * k
            if name == "face":
                faces = np.asarray(tris, dtype=np.int32)
    if vertices is None:
        raise ValueError("PLY without vertex element")
    if faces is None:
        faces = np.zeros((0, 3), np.int32)
    return Mesh(vertices=vertices, faces=faces)


def _parse_ply_ascii(body: bytes, elements) -> Mesh:
    lines = body.decode("ascii", "ignore").splitlines()
    li = 0
    vertices = None
    faces = None
    for name, count, props in elements:
        rows = lines[li : li + count]
        li += count
        if name == "vertex":
            names = [p[2] for p in props if p[0] == "scalar"]
            vals = np.array([[float(x) for x in r.split()] for r in rows], np.float32)
            ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
            vertices = vals[:, [ix, iy, iz]]
        elif name == "face":
            tris = []
            for r in rows:
                toks = [int(float(x)) for x in r.split()]
                k = toks[0]
                for t in range(1, k - 1):
                    tris.append((toks[1], toks[1 + t], toks[2 + t]))
            faces = np.asarray(tris, np.int32)
    if vertices is None:
        raise ValueError("PLY without vertex element")
    if faces is None:
        faces = np.zeros((0, 3), np.int32)
    return Mesh(vertices=vertices, faces=faces)


def load_obj(path: str) -> Mesh:
    """Minimal Wavefront OBJ reader (v / f lines, fan triangulation)."""
    verts: list = []
    tris: list = []
    with open(path, "r", errors="ignore") as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif parts[0] == "f":
                idxs = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for t in range(1, len(idxs) - 1):
                    tris.append((idxs[0], idxs[t], idxs[t + 1]))
    return Mesh(np.asarray(verts, np.float32), np.asarray(tris, np.int32))


def load_mesh(path: str) -> Mesh:
    """Load a .obj or .ply mesh, preferring the native C++ parser (runtime/)
    when it builds; the numpy parsers otherwise."""
    from physimglobalpose_tpu_torch.runtime import load_mesh_native

    nat = load_mesh_native(path)
    if nat is not None:
        return Mesh(vertices=nat[0], faces=nat[1])
    if path.endswith(".obj"):
        return load_obj(path)
    return load_ply(path)


def face_normals_areas(mesh: Mesh) -> tuple[np.ndarray, np.ndarray]:
    v = mesh.vertices
    f = mesh.faces
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    cr = np.cross(e1, e2)
    areas = 0.5 * np.linalg.norm(cr, axis=1)
    n = cr / np.maximum(np.linalg.norm(cr, axis=1, keepdims=True), 1e-12)
    return n.astype(np.float32), areas.astype(np.float32)


def sample_surface(
    mesh: Mesh, n: int, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Area-weighted surface sampling -> (points [n,3], normals [n,3])."""
    rng = np.random.default_rng(seed)
    normals, areas = face_normals_areas(mesh)
    if len(areas) == 0 or areas.sum() <= 0:
        idx = rng.integers(0, len(mesh.vertices), size=n)
        pts = mesh.vertices[idx]
        nrm = np.zeros_like(pts)
        nrm[:, 2] = 1.0
        return pts, nrm
    p = areas / areas.sum()
    fidx = rng.choice(len(areas), size=n, p=p)
    u = rng.random(n)
    v = rng.random(n)
    flip = u + v > 1
    u[flip] = 1 - u[flip]
    v[flip] = 1 - v[flip]
    tri = mesh.vertices[mesh.faces[fidx]]
    pts = tri[:, 0] + u[:, None] * (tri[:, 1] - tri[:, 0]) + v[:, None] * (tri[:, 2] - tri[:, 0])
    return pts.astype(np.float32), normals[fidx]


def voxel_thin(
    points: np.ndarray, normals: np.ndarray, voxel: float, max_out: int, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Keep one sample per voxel (matches the reference's modelDiscretization
    sampling of model_search.ply, obj_config.yml:3), capped at max_out."""
    ijk = np.floor(points / voxel).astype(np.int64)
    key = (ijk[:, 0] + 4096) * 8192 * 8192 + (ijk[:, 1] + 4096) * 8192 + (ijk[:, 2] + 4096)
    _, first = np.unique(key, return_index=True)
    rng = np.random.default_rng(seed)
    if len(first) > max_out:
        first = rng.choice(first, size=max_out, replace=False)
    pts = points[first]
    nrm = normals[first]
    # normalize (averaging not needed - representative sample policy)
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    return pts.astype(np.float32), nrm.astype(np.float32)


def convex_hull_planes(vertices: np.ndarray, max_faces: int = 96) -> np.ndarray:
    """Hull face planes [F, 4] with n.x + d <= 0 inside; padded with far planes.

    Used by the physics settle for convex vertex-face contact (in place of
    Bullet's btConvexHullShape, PhySim.cpp:61-64).
    """
    from scipy.spatial import ConvexHull, QhullError

    try:
        hull = ConvexHull(vertices.astype(np.float64), qhull_options="QJ")
        eqs = hull.equations  # [F, 4], n.x + d <= 0 inside
    except (QhullError, ValueError):
        # Fallback: AABB planes.
        lo, hi = vertices.min(0), vertices.max(0)
        eqs = np.array(
            [
                [1, 0, 0, -hi[0]], [-1, 0, 0, lo[0]],
                [0, 1, 0, -hi[1]], [0, -1, 0, lo[1]],
                [0, 0, 1, -hi[2]], [0, 0, -1, lo[2]],
            ],
            np.float64,
        )
    if len(eqs) > max_faces:
        # Keep the faces most spread in normal direction (greedy FPS on normals).
        n = eqs[:, :3]
        chosen = [0]
        d = 1.0 - n @ n[0]
        for _ in range(max_faces - 1):
            nxt = int(np.argmax(d))
            chosen.append(nxt)
            d = np.minimum(d, 1.0 - n @ n[nxt])
        eqs = eqs[chosen]
    out = np.zeros((max_faces, 4), np.float32)
    out[: len(eqs)] = eqs
    # Padding: planes at -infinity (never violated).
    out[len(eqs) :] = np.array([0, 0, 1, -1e9], np.float32)
    return out


def convex_hull_points(vertices: np.ndarray, max_points: int = 64, seed: int = 0) -> np.ndarray:
    """Convex hull vertex set, reduced to max_points by farthest-point sampling.

    Replaces the reference's pre-baked hull.ply requirement
    (super4pcs_test.cc:76); used by the physics settle and pose-set distances.
    """
    from scipy.spatial import ConvexHull, QhullError  # host-side asset prep only

    try:
        hull = ConvexHull(vertices.astype(np.float64), qhull_options="QJ")
        pts = vertices[hull.vertices]
    except (QhullError, ValueError):
        pts = vertices
    if len(pts) <= max_points:
        return pts.astype(np.float32)
    # farthest point sampling
    rng = np.random.default_rng(seed)
    chosen = [int(rng.integers(len(pts)))]
    d = np.linalg.norm(pts - pts[chosen[0]], axis=1)
    for _ in range(max_points - 1):
        nxt = int(np.argmax(d))
        chosen.append(nxt)
        d = np.minimum(d, np.linalg.norm(pts - pts[nxt], axis=1))
    return pts[chosen].astype(np.float32)


def decimate_vertex_clustering(mesh: Mesh, cell: float) -> Mesh:
    """Vertex-clustering decimation: weld vertices per grid cell.

    Standard coarse decimator (cells -> centroid vertices; faces collapsing
    to fewer than 3 distinct cells are dropped). Bounds the face count for
    the O(F x pixels) triangle rasterizer (ops/raster_tri.py).
    """
    if len(mesh.faces) == 0:
        return mesh
    ijk = np.floor(mesh.vertices / cell).astype(np.int64)
    key = (ijk[:, 0] + 4096) * 8192 * 8192 + (ijk[:, 1] + 4096) * 8192 + (ijk[:, 2] + 4096)
    uniq, inverse = np.unique(key, return_inverse=True)
    new_verts = np.zeros((len(uniq), 3), np.float64)
    counts = np.zeros(len(uniq), np.int64)
    np.add.at(new_verts, inverse, mesh.vertices.astype(np.float64))
    np.add.at(counts, inverse, 1)
    new_verts /= counts[:, None]
    nf = inverse[mesh.faces]
    keep = (nf[:, 0] != nf[:, 1]) & (nf[:, 1] != nf[:, 2]) & (nf[:, 0] != nf[:, 2])
    return Mesh(new_verts.astype(np.float32), nf[keep].astype(np.int32))


def decimate_to_max_faces(mesh: Mesh, max_faces: int) -> Mesh:
    """Decimate until the face count fits, growing the cell size as needed."""
    if len(mesh.faces) <= max_faces:
        return mesh
    ext = float(np.max(mesh.vertices.max(0) - mesh.vertices.min(0)))
    cell = ext / 64.0
    out = mesh
    for _ in range(8):
        out = decimate_vertex_clustering(mesh, cell)
        if len(out.faces) <= max_faces:
            break
        cell *= 1.6
    return out
