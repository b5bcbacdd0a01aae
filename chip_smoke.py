#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches an error and goes on):
1. device: the card's name and power limit (nvidia-smi);
2. build: compile every CUDA kernel of the main path from csrc/ (first use);
3. kernel vs plain: each kernel against its plain PyTorch version on the card,
   at the main-path shape and at ragged shapes, then timed alone;
4. end to end: a 640x480 scene of three boxes on a table, ray-cast here in
   numpy, through the port's prepare_object and estimate_pose (GT / PCS / LCP)
   at the default configuration; every object must come back within ADD-S
   1 cm, and the kernel launch counts of that run must be non-zero;
5. one JSON line describing every kernel, the card line, and last a JSON
   line {"ok": true, "device": {...}}.

Imports nothing of JAX. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores (data sheet)
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
TOL_LCP = 2.0  # max abs score error allowed, in units of 1/Nv

# Scene: three boxes of distinct sizes (full extents, m), their centre (x, y)
# on the table and their yaw (deg).
BOXES = (
    ("box_a", 1, (0.12, 0.08, 0.06), (-0.13, 0.04), 20.0),
    ("box_b", 2, (0.07, 0.05, 0.14), (0.0, -0.07), -35.0),
    ("box_c", 3, (0.16, 0.10, 0.045), (0.12, 0.08), 60.0),
)
TABLE_HALF = 0.4
WIDTH, HEIGHT = 640, 480
INTRINSICS = np.array([[570.0, 0.0, 319.5], [0.0, 570.0, 239.5], [0.0, 0.0, 1.0]], np.float32)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------- scene


def _rot_z(deg: float) -> np.ndarray:
    a = math.radians(deg)
    return np.array([[math.cos(a), -math.sin(a), 0.0], [math.sin(a), math.cos(a), 0.0],
                     [0.0, 0.0, 1.0]])


def camera_pose(distance: float = 0.75, elevation_deg: float = 45.0) -> np.ndarray:
    """Camera-to-world pose (OpenCV axes: x right, y down, z forward) looking
    at the table centre from `elevation_deg` above the table plane."""
    e = math.radians(elevation_deg)
    target = np.array([0.0, 0.0, 0.03])
    eye = target + distance * np.array([0.0, -math.cos(e), math.sin(e)])
    f = (target - eye) / np.linalg.norm(target - eye)
    r = np.cross(f, [0.0, 0.0, 1.0])
    r /= np.linalg.norm(r)
    y = np.cross(f, r)
    pose = np.eye(4)
    pose[:3, :3] = np.stack([r, y, f], axis=1)
    pose[:3, 3] = eye
    return pose


def box_pose_world(size, xy, yaw) -> np.ndarray:
    pose = np.eye(4)
    pose[:3, :3] = _rot_z(yaw)
    pose[:3, 3] = [xy[0], xy[1], size[2] / 2.0]
    return pose


def render_scene(cam_pose: np.ndarray):
    """Ray-cast the boxes and the table top: (depth [H, W] m, class mask [H, W])."""
    fx, fy, cx, cy = INTRINSICS[0, 0], INTRINSICS[1, 1], INTRINSICS[0, 2], INTRINSICS[1, 2]
    vv, uu = np.meshgrid(np.arange(HEIGHT), np.arange(WIDTH), indexing="ij")
    d_cam = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu, float)], -1).reshape(-1, 3)
    rot, eye = cam_pose[:3, :3], cam_pose[:3, 3]
    d_w = d_cam @ rot.T  # ray directions with unit camera-z: t is the depth
    best = np.full(len(d_w), np.inf)
    label = np.zeros(len(d_w), np.int32)

    with np.errstate(divide="ignore", invalid="ignore"):
        t_tab = -eye[2] / d_w[:, 2]
        hit = eye[None, :2] + t_tab[:, None] * d_w[:, :2]
        ok = (t_tab > 0) & (np.abs(hit) < TABLE_HALF).all(-1)
        best = np.where(ok, t_tab, best)
        for _name, cls, size, xy, yaw in BOXES:
            pose = box_pose_world(size, xy, yaw)
            rb, cb = pose[:3, :3], pose[:3, 3]
            o = rb.T @ (eye - cb)
            d = d_w @ rb  # rb^T d per ray
            half = np.asarray(size) / 2.0
            t1 = (-half[None] - o[None]) / d
            t2 = (half[None] - o[None]) / d
            t_near = np.nanmax(np.minimum(t1, t2), axis=-1)
            t_far = np.nanmin(np.maximum(t1, t2), axis=-1)
            ok = (t_near <= t_far) & (t_near > 0) & (t_near < best)
            best = np.where(ok, t_near, best)
            label = np.where(ok, cls, label)
    depth = np.where(np.isfinite(best), best, 0.0).reshape(HEIGHT, WIDTH).astype(np.float32)
    return depth, label.reshape(HEIGHT, WIDTH)


def write_box_ply(path: str, size):
    """Closed box mesh centred at the origin, faces wound outward (ascii
    PLY). Returns (vertices [8, 3], triangles [12, 3])."""
    half = np.asarray(size) / 2.0
    verts = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]) * half
    tris = []
    for axis in range(3):
        for sign in (-1, 1):
            quad = [i for i, v in enumerate(verts) if np.sign(v[axis]) == sign]
            a, b, c, d = quad  # two triangles (a, b, d), (a, d, c) of the face
            for tri in ((a, b, d), (a, d, c)):
                p = verts[list(tri)]
                n = np.cross(p[1] - p[0], p[2] - p[0])
                tris.append(tri if n[axis] * sign > 0 else (tri[0], tri[2], tri[1]))
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n")
        fh.write(f"element vertex {len(verts)}\nproperty float x\nproperty float y\nproperty float z\n")
        fh.write(f"element face {len(tris)}\nproperty list uchar int vertex_indices\nend_header\n")
        for v in verts:
            fh.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in tris:
            fh.write(f"3 {t[0]} {t[1]} {t[2]}\n")
    return verts.astype(np.float32), np.asarray(tris, np.int32)


def adds_error(pose_est: np.ndarray, pose_gt: np.ndarray, pts: np.ndarray, device) -> float:
    """ADD-S: mean over GT-placed model points of the distance to the nearest
    estimate-placed model point."""
    p = torch.as_tensor(pts, dtype=torch.float64, device=device)
    a = p @ torch.as_tensor(pose_gt[:3, :3], dtype=torch.float64, device=device).T
    a = a + torch.as_tensor(pose_gt[:3, 3], dtype=torch.float64, device=device)
    b = p @ torch.as_tensor(pose_est[:3, :3], dtype=torch.float64, device=device).T
    b = b + torch.as_tensor(pose_est[:3, 3], dtype=torch.float64, device=device)
    return float(torch.cdist(a, b).amin(dim=1).mean())


# ----------------------------------------------------------------- LCP inputs


def _box_surface(rng, n, size):
    half = np.asarray(size) / 2.0
    areas = np.array([size[1] * size[2], size[0] * size[2], size[0] * size[1]]).repeat(2)
    face = rng.choice(6, size=n, p=areas / areas.sum())
    axis, sign = face // 2, np.where(face % 2 == 0, 1.0, -1.0)
    pts = rng.uniform(-1, 1, size=(n, 3)) * half
    nrm = np.zeros((n, 3))
    pts[np.arange(n), axis] = sign * half[axis]
    nrm[np.arange(n), axis] = sign
    return pts.astype(np.float32), nrm.astype(np.float32)


def lcp_inputs(seed: int, h: int, nv: int, ns: int, n_masked: int, device):
    """A box model seen in a scene segment (noise + clutter + masked rows)
    and h hypotheses scattered a few mm / degrees around the truth."""
    rng = np.random.default_rng(seed)
    mpts, mnrm = _box_surface(rng, nv, (0.12, 0.08, 0.06))
    true_rot = _rot_z(30.0) @ np.array([[1, 0, 0], [0, 0.8, -0.6], [0, 0.6, 0.8]])
    true_t = np.array([0.05, -0.02, 0.7])
    n_obj = ns - ns // 8
    idx = rng.choice(nv, size=n_obj, replace=n_obj > nv)
    spts = mpts[idx] @ true_rot.T + true_t + rng.normal(scale=0.001, size=(n_obj, 3))
    snrm = mnrm[idx] @ true_rot.T
    clutter = true_t + rng.uniform(-0.15, 0.15, size=(ns - n_obj, 3))
    cnrm = rng.normal(size=(ns - n_obj, 3))
    cnrm /= np.linalg.norm(cnrm, axis=1, keepdims=True)
    spts = np.concatenate([spts, clutter]).astype(np.float32)
    snrm = np.concatenate([snrm, cnrm]).astype(np.float32)
    sprob = rng.uniform(0.3, 1.0, size=ns).astype(np.float32)
    smask = np.ones(ns, bool)
    smask[rng.choice(ns, size=n_masked, replace=False)] = False
    tfs = np.tile(np.eye(4), (h, 1, 1))
    for k in range(h):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ang = rng.uniform(0, math.radians(8.0))
        kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        dr = np.eye(3) + math.sin(ang) * kx + (1 - math.cos(ang)) * kx @ kx
        tfs[k, :3, :3] = dr @ true_rot
        tfs[k, :3, 3] = true_t + rng.normal(scale=0.004, size=3)
    as_t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=device)
    return (as_t(tfs), as_t(mpts), as_t(mnrm), as_t(spts), as_t(snrm), as_t(sprob),
            as_t(smask, torch.bool))


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median time of fn() on the card, each run between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ----------------------------------------------------------------- phases


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def phase_build() -> float:
    from physimglobalpose_tpu_torch import _build

    secs = _build.build()
    log(f"[build] {len(_build.KERNEL_SOURCES)} kernel source(s) built in {secs:.2f} s")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line or "error" in line.lower():
                log(f"[build] {name}: {line.strip()}")
    return secs


def phase_lcp(device) -> dict:
    """lcp_segside against lcp_scores_plain; then timed at the main-path H."""
    from physimglobalpose_tpu_torch.ops import lcp

    cases = (
        # (label, seed, H, Nv, Ns, masked)  - main path shape first
        ("main", 0, 512, 4096, 1024, 24),
        ("ragged", 1, 37, 1000, 333, 40),
        ("ragged_smem64k", 2, 13, 4096, 2048, 100),
        ("ragged_ns1500", 3, 9, 2500, 1500, 7),
    )
    worst = 0.0
    for label, seed, h, nv, ns, masked in cases:
        args = lcp_inputs(seed, h, nv, ns, masked, device)
        for weighted in (True, False):
            got = lcp.lcp_scores(*args, weighted=weighted)
            want = lcp.lcp_scores_plain(*args, weighted=weighted)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()) or got.shape != (h,):
                fail(f"lcp_segside {label}: non-finite or misshapen output")
            err = float((got - want).abs().max())
            tol = TOL_LCP / nv
            log(f"[lcp] {label} H={h} Nv={nv} Ns={ns} weighted={weighted}: "
                f"max_abs_err={err:.3e} (tol {tol:.3e}) mean_score={float(want.mean()):.4f}")
            if err > tol:
                fail(f"lcp_segside disagrees with plain on {label} (weighted={weighted})")
            if label == "main":
                worst = max(worst, err)

    # Timing at the main path's per-object call: H = 10,000, Nv 4096, Ns 1024.
    h, nv, ns = 10_000, 4096, 1024
    args = lcp_inputs(10, h, nv, ns, 24, device)
    err = float((lcp.lcp_scores(*args) - lcp.lcp_scores_plain(*args)).abs().max())
    log(f"[lcp] main-path H={h} Nv={nv} Ns={ns} weighted=True: max_abs_err={err:.3e}")
    if err > TOL_LCP / nv:
        fail("lcp_segside disagrees with plain at the main-path H")
    worst = max(worst, err)
    kernel_ms = cuda_time_ms(lambda: lcp.lcp_scores(*args, weighted=True), reps=10)
    plain_ms = cuda_time_ms(lambda: lcp.lcp_scores_plain(*args, weighted=True), reps=3, warmup=1)
    kernel_u_ms = cuda_time_ms(lambda: lcp.lcp_scores(*args, weighted=False), reps=10)
    tfs, mpts, _, spts = args[:4]

    def cdist_yardstick():
        # Nearest yardstick only: unweighted nearest d^2 via torch.cdist, in
        # hypothesis chunks (no single PyTorch call computes the score).
        u = torch.einsum("hij,nj->hni", tfs[:, :3, :3], mpts) + tfs[:, None, :3, 3]
        for uc in u.split(256):
            torch.cdist(uc, spts).amin(-1)

    cdist_ms = cuda_time_ms(cdist_yardstick, reps=3, warmup=1)
    pairs = h * nv * ns
    flops = 8.0 * pairs + 40.0 * h * nv  # per pair: 3 FMA + add + compare; per point: transform
    bytes_moved = 4.0 * (12 * h + 6 * nv + 8 * ns + h)
    bound_ms = max(flops / PEAK_FP32_FLOPS, bytes_moved / PEAK_HBM_BYTES) * 1e3
    flop16_ms = 16.0 * pairs / PEAK_FP32_FLOPS * 1e3
    log(f"[lcp] timed H={h} Nv={nv} Ns={ns}: kernel_ms={kernel_ms:.3f} (weighted) "
        f"{kernel_u_ms:.3f} (unweighted) plain_ms={plain_ms:.3f} cdist_yardstick_ms={cdist_ms:.3f}")
    log(f"[lcp] bound: {flops:.3e} FLOP (8/pair) -> {bound_ms:.3f} ms, share {bound_ms / kernel_ms:.3f}; "
        f"16 FLOP/pair count {16.0 * pairs:.3e} -> {flop16_ms:.3f} ms, share {flop16_ms / kernel_ms:.3f}")
    return dict(max_abs_err=worst, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                unweighted_ms=kernel_u_ms, cdist_yardstick_ms=cdist_ms, flop16_bound_ms=flop16_ms)


def phase_e2e(device, workdir: str) -> tuple[dict, dict]:
    """Prepare the three box objects and run estimate_pose twice (warm-up,
    then timed with the launch counts read around it)."""
    from physimglobalpose_tpu_torch.config import DEFAULT_CONFIG
    from physimglobalpose_tpu_torch.models import objectdb
    from physimglobalpose_tpu_torch.ops import lcp
    from physimglobalpose_tpu_torch.pipeline import api, scene as scene_mod

    cam_pose = camera_pose()
    t0 = time.perf_counter()
    depth, label = render_scene(cam_pose)
    objects = {}
    for name, cls, size, _xy, _yaw in BOXES:
        ply = os.path.join(workdir, f"{name}.ply")
        write_box_ply(ply, size)
        objects[name] = objectdb.prepare_object(
            name, ply, cls, [180, 180, 180], config=DEFAULT_CONFIG, device=device
        )
    db = objectdb.ObjectDB(objects, {o.class_id: n for n, o in objects.items()})
    for name, cls, *_ in BOXES:
        log(f"[e2e] {name}: {int((label == cls).sum())} mask pixels")
    log(f"[e2e] scene + assets in {time.perf_counter() - t0:.2f} s "
        f"({WIDTH}x{HEIGHT}, {int((depth > 0).sum())} depth pixels)")
    sc = scene_mod.scene_from_arrays(
        color=np.zeros((HEIGHT, WIDTH, 3), np.uint8), depth=depth, intrinsics=INTRINSICS,
        cam_pose=cam_pose, object_names=[b[0] for b in BOXES], class_mask=label,
    )
    result_path = os.path.join(workdir, "result.txt")
    run = lambda: api.estimate_pose(
        "<memory>", db, segmentation_mode="GT", hypothesis_mode="PCS",
        verification_mode="LCP", cfg=DEFAULT_CONFIG, seed=0, scene=sc,
        result_path=result_path, device=device,
    )
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    log(f"[e2e] warm-up call {time.perf_counter() - t0:.3f} s")

    lcp.lcp_segside.launches = 0
    t0 = time.perf_counter()
    result = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"lcp_segside": lcp.lcp_segside.launches}

    timings = {k: v for k, v in result.timings.items() if k != "result_path"}
    timings["wall_s"] = wall
    log(f"[e2e] timings {json.dumps(timings)}")
    log(f"[e2e] launches during the timed call: {launches}")
    if [o.name for o in result.objects] != [b[0] for b in BOXES]:
        fail("estimate_pose returned another object list")
    inv_cam = np.linalg.inv(cam_pose)
    for (name, _cls, size, xy, yaw), est in zip(BOXES, result.objects):
        gt_cam = inv_cam @ box_pose_world(size, xy, yaw)
        if not np.isfinite(est.pose_cam).all() or est.pose_cam.shape != (4, 4):
            fail(f"{name}: non-finite pose")
        adds = adds_error(est.pose_cam, gt_cam, objects[name].validation_pts, device)
        log(f"[e2e] {name}: score={est.score:.4f} ADD-S={adds * 1000:.2f} mm "
            f"t_world={np.round(est.pose_world[:3, 3], 4).tolist()}")
        if adds >= 0.01:
            fail(f"{name}: ADD-S {adds * 1000:.2f} mm >= 10 mm")
    with open(result_path) as fh:
        rows = [r.split() for r in fh.read().splitlines()]
    if len(rows) != 3 or any(len(r) != 8 for r in rows):
        fail(f"result.txt has {len(rows)} rows, want 3 rows of 8 fields")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    profile_scene(run)
    return timings, launches


def profile_scene(run) -> None:
    """One more scene under torch.profiler: device busy time, its share of
    the wall time, and the device time by kernel (top entries)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        log("[profile] no device events recorded: device busy share not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy, cur_s, cur_e = busy + (cur_e - cur_s), s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy_ms = (busy + cur_e - cur_s) / 1e3
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log("[profile] " + json.dumps({
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms, "device_events": len(events),
        "top_device_ms": {k[:60]: round(v, 3) for k, v in top},
    }))


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (fp32 setup)

    device = torch.device("cuda")
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    lcp_stats = phase_lcp(device)
    with tempfile.TemporaryDirectory() as workdir:
        _timings, launches = phase_e2e(device, workdir)

    kernels = [{
        "name": "lcp_segside",
        "route": "cuda",
        "source": "physimglobalpose_tpu_torch/csrc/lcp_segside.cu",
        "replaces": "physimglobalpose_tpu/ops/lcp.py:420",
        "tpu_kernel": "ops/lcp.py::_lcp_kernel_segside",
        "launches": launches["lcp_segside"],
        "max_abs_err": lcp_stats["max_abs_err"],
        "ms": lcp_stats["ms"],
        "kernel_ms": lcp_stats["ms"],
        "plain_ms": lcp_stats["plain_ms"],
        "bound_ms": lcp_stats["bound_ms"],
        "bound_by": "operations",
        "library_ms": None,
    }]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
