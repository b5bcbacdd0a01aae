"""Shared setup for the port's CPU parity tests (not collected by pytest).

The tests run under pytest-xdist with several workers on a shared host:
torch gets one thread per worker. Inputs are made with numpy from a seed and
handed to both packages; JAX stays on the CPU (tests/conftest.py). Procedural
box meshes and the scene camera come from chip_smoke.py, which drives the
same kind of scene on the card.
"""

import numpy as np
import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")


def t(a, dtype=torch.float32):
    """numpy (or JAX) array -> CPU torch tensor."""
    return torch.as_tensor(np.array(a), dtype=dtype)


def tb(a):
    return t(a, torch.bool)


def n(x):
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_object_fields(obj):
    """The JAX ObjectModel's arrays as the dict objectdb.from_numpy takes."""
    tab = obj.ppf_table
    return dict(
        name=obj.name, class_id=obj.class_id, symmetry=obj.symmetry,
        mesh_vertices=obj.mesh.vertices, mesh_faces=obj.mesh.faces,
        search_pts=obj.search_pts, search_nrm=obj.search_nrm, search_mask=obj.search_mask,
        validation_pts=obj.validation_pts, validation_nrm=obj.validation_nrm,
        hull_pts=obj.hull_pts, hull_mask=obj.hull_mask, hull_eqs=obj.hull_eqs,
        presence=np.asarray(tab.presence), offsets=np.asarray(tab.offsets),
        counts=np.asarray(tab.counts), pairs=np.asarray(tab.pairs), diameter=obj.diameter,
    )


def scoring_inputs(arrays):
    """The nine arrays of bench.make_inputs (JAX or numpy arrays: transforms,
    search cloud + normals, validation cloud + normals, segment points,
    normals, probabilities, mask) as the port's CPU tensors, so that both
    packages score the same inputs."""
    *floats, mask = arrays
    return tuple(t(a) for a in floats) + (tb(mask),)
