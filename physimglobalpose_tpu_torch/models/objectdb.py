"""Object database: per-object model assets + the PPF table on the device.

Reference: GlobalCfg loads obj_config.yml and builds an Objects entry per
object (GlobalCfg.cpp:30-62), each loading a sparse matching cloud, a dense
LCP cloud, a render mesh and a PPFMap.txt (Objects.cpp:8-49). Here the same
content is derived from one mesh (models/assets.py, ops/ppf.py) and cached to
an .npz laid out as the JAX package's. Its name carries the port's own salt, so
the port never reads a file the JAX package wrote, even in a shared directory:
what the port loads, the port built. The clouds stay numpy on the host; the
PPF table lives on the device the caller names.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
from typing import Dict, List, Optional

import numpy as np

from physimglobalpose_tpu_torch import _torchcfg
from physimglobalpose_tpu_torch.config import PipelineConfig, DEFAULT_CONFIG
from physimglobalpose_tpu_torch.models import assets
from physimglobalpose_tpu_torch.ops import ppf as ppf_mod

# The .npz cache arrays (one file per object and asset configuration).
_CACHE_KEYS = (
    "search_pts", "search_nrm", "search_mask", "validation_pts", "validation_nrm",
    "hull_pts", "hull_mask", "hull_eqs", "presence", "offsets", "counts", "pairs",
    "diameter",
)
# Ends the cache tag: the JAX package's tags end in ":v2".
_CACHE_SALT = "v2:torch"


def default_cache_dir() -> str:
    """The command lines' asset cache: the port's own directory under the
    temporary directory (TMPDIR honoured)."""
    return os.path.join(tempfile.gettempdir(), "physimglobalpose_tpu_torch_cache")


@dataclasses.dataclass
class ObjectModel:
    name: str
    class_id: int
    symmetry: np.ndarray  # [3] degrees per axis (90/180/360/0)
    mesh: Optional[assets.Mesh]  # render/physics mesh
    search_pts: np.ndarray  # [Nm, 3] sparse matching cloud
    search_nrm: np.ndarray  # [Nm, 3]
    search_mask: np.ndarray  # [Nm] bool (padding mask)
    validation_pts: np.ndarray  # [Nv, 3] dense LCP cloud
    validation_nrm: np.ndarray  # [Nv, 3]
    hull_pts: np.ndarray  # [Nh, 3] convex hull vertices (padded)
    hull_mask: np.ndarray  # [Nh] bool
    hull_eqs: np.ndarray  # [Nf, 4] hull face planes (n.x + d <= 0 inside)
    ppf_table: ppf_mod.PPFTable
    diameter: float


def _pad(arr: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    m = min(len(arr), n)
    out = np.zeros((n,) + arr.shape[1:], arr.dtype)
    out[:m] = arr[:m]
    mask = np.zeros(n, bool)
    mask[:m] = True
    return out, mask


def from_numpy(
    fields: dict, config: PipelineConfig = DEFAULT_CONFIG, device=None
) -> ObjectModel:
    """ObjectModel from plain arrays: the .npz cache keys plus name,
    class_id, symmetry and optionally mesh_vertices / mesh_faces. Carries
    assets prepared elsewhere (e.g. by the JAX package) across unchanged;
    the PPF table goes to `device`."""
    st = config.stocs
    table = ppf_mod.table_from_arrays(
        fields["offsets"], fields["counts"], fields["pairs"],
        st.trans_disc_mm, st.rot_disc_deg, st.max_ppf_dist_mm, device,
    )
    mesh = None
    if "mesh_vertices" in fields:
        mesh = assets.Mesh(
            np.asarray(fields["mesh_vertices"], np.float32),
            np.asarray(fields["mesh_faces"], np.int32),
        )
    return ObjectModel(
        name=str(fields["name"]),
        class_id=int(fields["class_id"]),
        symmetry=np.asarray(fields["symmetry"], np.float32),
        mesh=mesh,
        search_pts=np.asarray(fields["search_pts"], np.float32),
        search_nrm=np.asarray(fields["search_nrm"], np.float32),
        search_mask=np.asarray(fields["search_mask"], bool),
        validation_pts=np.asarray(fields["validation_pts"], np.float32),
        validation_nrm=np.asarray(fields["validation_nrm"], np.float32),
        hull_pts=np.asarray(fields["hull_pts"], np.float32),
        hull_mask=np.asarray(fields["hull_mask"], bool),
        hull_eqs=np.asarray(fields["hull_eqs"], np.float32),
        ppf_table=table,
        diameter=float(fields["diameter"]),
    )


def prepare_object(
    name: str,
    mesh_path: str,
    class_id: int,
    symmetry,
    config: PipelineConfig = DEFAULT_CONFIG,
    model_discretization: float = 0.01,
    cache_dir: Optional[str] = None,
    seed: int = 0,
    device=None,
) -> ObjectModel:
    """Build (or load cached) per-object assets from a mesh file. The PPF
    table goes to `device` (the card unless the caller asks for the CPU)."""
    dev = _torchcfg.resolve_device(device)
    cache_file = None
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        tag = hashlib.sha1(
            f"{mesh_path}:{os.path.getmtime(mesh_path)}:{model_discretization}:"
            f"{config.max_model_points}:{config.max_validation_points}:"
            f"{config.max_hull_points}:{config.stocs.trans_disc_mm}:"
            f"{config.stocs.rot_disc_deg}:{config.stocs.max_ppf_dist_mm}:{_CACHE_SALT}".encode()
        ).hexdigest()[:16]
        cache_file = os.path.join(cache_dir, f"{name}_{tag}.npz")

    mesh = assets.load_mesh(mesh_path)
    fields = dict(name=name, class_id=class_id, symmetry=symmetry,
                  mesh_vertices=mesh.vertices, mesh_faces=mesh.faces)

    if cache_file and os.path.exists(cache_file):
        z = np.load(cache_file)
        fields.update({k: z[k] for k in _CACHE_KEYS})
        return from_numpy(fields, config, dev)

    # Dense validation cloud (model_validation.ply analogue).
    vpts, vnrm = assets.sample_surface(mesh, config.max_validation_points, seed=seed)
    # Sparse search cloud at the reference's modelDiscretization (1 cm).
    raw_pts, raw_nrm = assets.sample_surface(mesh, config.max_model_points * 8, seed=seed + 1)
    spts, snrm = assets.voxel_thin(
        raw_pts, raw_nrm, model_discretization, config.max_model_points, seed=seed + 2
    )
    spts_p, smask = _pad(spts, config.max_model_points)
    snrm_p, _ = _pad(snrm, config.max_model_points)
    hull = assets.convex_hull_points(mesh.vertices, config.max_hull_points, seed=seed)
    hull_p, hull_mask = _pad(hull, config.max_hull_points)
    hull_eqs = assets.convex_hull_planes(mesh.vertices)
    diameter = float(np.linalg.norm(vpts.max(axis=0) - vpts.min(axis=0)))

    table = ppf_mod.build_ppf_table(
        spts.astype(np.float32), snrm.astype(np.float32),
        trans_disc=config.stocs.trans_disc_mm, rot_disc=config.stocs.rot_disc_deg,
        max_dist_mm=config.stocs.max_ppf_dist_mm, device="cpu",
    )
    arrays = dict(
        search_pts=spts_p, search_nrm=snrm_p, search_mask=smask,
        validation_pts=vpts, validation_nrm=vnrm,
        hull_pts=hull_p, hull_mask=hull_mask, hull_eqs=hull_eqs,
        presence=table.presence.numpy(), offsets=table.offsets.numpy(),
        counts=table.counts.numpy(), pairs=table.pairs.numpy(), diameter=diameter,
    )
    if cache_file:
        np.savez_compressed(cache_file, **arrays)
    fields.update(arrays)
    return from_numpy(fields, config, dev)


class ObjectDB:
    """All objects of a dataset, loaded from an obj_config.yml-style file."""

    def __init__(self, objects: Dict[str, ObjectModel], by_class: Dict[int, str]):
        self.objects = objects
        self.by_class = by_class

    def __getitem__(self, name: str) -> ObjectModel:
        return self.objects[name]

    def class_of(self, name: str) -> int:
        return self.objects[name].class_id

    def name_for_class(self, class_id: int) -> str:
        return self.by_class[class_id]

    @property
    def names(self) -> List[str]:
        return list(self.objects)


def _find_mesh(model_dir: str, name: str) -> str:
    for ext in (".obj", ".ply"):
        p = os.path.join(model_dir, name, name + ext)
        if os.path.exists(p):
            return p
        p = os.path.join(model_dir, name + ext)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no mesh for object {name!r} under {model_dir}")


def load_object_db(
    config_yaml: str,
    model_dir: str,
    config: PipelineConfig = DEFAULT_CONFIG,
    cache_dir: Optional[str] = None,
    only: Optional[List[str]] = None,
    device=None,
) -> ObjectDB:
    """Parse an obj_config.yml (reference schema; needs PyYAML) and prepare
    every object (restricted to `only` when given)."""
    import yaml

    with open(config_yaml) as fh:
        cfg = yaml.safe_load(fh)
    objs = cfg["objects"]
    n = int(objs["num_objects"])
    disc = float(objs.get("modelDiscretization", 0.01))
    out: Dict[str, ObjectModel] = {}
    by_class: Dict[int, str] = {}
    for i in range(1, n + 1):
        entry = objs[f"object_{i}"]
        name = entry["name"]
        class_id = int(entry["classId"])
        by_class[class_id] = name
        if only is not None and name not in only:
            continue
        out[name] = prepare_object(
            name, _find_mesh(model_dir, name), class_id,
            entry.get("symmetry", [0, 0, 0]), config=config,
            model_discretization=disc, cache_dir=cache_dir, device=device,
        )
    return ObjectDB(out, by_class)
