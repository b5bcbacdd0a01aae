"""ADD-S of the JAX package's estimate_pose on chip_smoke.py's three-box scene
in the SUPER4PCS, V4PCS and PPF_VOTING hypothesis modes (GT segmentation, LCP
verification, the default configuration, seed 0), on the CPU.

chip_smoke.py's [e2e-modes] phase holds the PyTorch port on the card to a bar
taken from this run: 1 cm for a mode where every object here is within 1 cm,
else the worst ADD-S here plus 1 cm.

    JAX_PLATFORMS=cpu python scripts/jax_scene_modes_bar.py [--modes SUPER4PCS ...]

Prints one JSON line per mode: the ADD-S per object (m), the worst, the bar
and the wall time of the call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the numpy ray-cast scene; imports no JAX)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--modes", nargs="*", default=["SUPER4PCS", "V4PCS", "PPF_VOTING"])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from physimglobalpose_tpu.config import DEFAULT_CONFIG
    from physimglobalpose_tpu.geometry import metrics
    from physimglobalpose_tpu.models import objectdb
    from physimglobalpose_tpu.pipeline import api, scene as scene_mod

    cam = chip_smoke.camera_pose()
    depth, label = chip_smoke.render_scene(cam)
    inv_cam = np.linalg.inv(cam)
    with tempfile.TemporaryDirectory() as tmp:
        objs = {}
        for name, cls, size, _xy, _yaw in chip_smoke.BOXES:
            ply = os.path.join(tmp, f"{name}.ply")
            chip_smoke.write_box_ply(ply, size)
            objs[name] = objectdb.prepare_object(name, ply, cls, [180, 180, 180],
                                                 config=DEFAULT_CONFIG)
    db = objectdb.ObjectDB(objs, {o.class_id: n for n, o in objs.items()})
    sc = scene_mod.scene_from_arrays(
        color=chip_smoke.shade_scene(depth, label), depth=depth,
        intrinsics=chip_smoke.INTRINSICS, cam_pose=cam,
        object_names=[b[0] for b in chip_smoke.BOXES], class_mask=label,
    )
    for mode in args.modes:
        t0 = time.perf_counter()
        res = api.estimate_pose("<memory>", db, hypothesis_mode=mode, cfg=DEFAULT_CONFIG,
                                seed=args.seed, scene=sc, write_result=False)
        wall = time.perf_counter() - t0
        adds = {}
        for (name, _cls, size, xy, yaw), est in zip(chip_smoke.BOXES, res.objects):
            gt = inv_cam @ chip_smoke.box_pose_world(size, xy, yaw)
            adds[name] = float(metrics.adds_error(
                jnp.asarray(est.pose_cam, jnp.float32), jnp.asarray(gt, jnp.float32),
                jnp.asarray(objs[name].validation_pts)))
        worst = max(adds.values())
        bar = 0.01 if worst < 0.01 else worst + 0.01
        print(json.dumps({"mode": mode, "seed": args.seed, "adds_m": adds, "worst_m": worst,
                          "bar_m": bar, "wall_s": wall}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
