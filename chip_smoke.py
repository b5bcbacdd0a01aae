#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches an error and goes on):
1. [device] the card's name and power limit (nvidia-smi);
2. [build] compile every CUDA kernel from csrc/, one nvcc per source, together;
3. [launch] the time of an empty launch; then kernel vs plain, each kernel
   against its plain PyTorch version on the card at the shapes its path gives
   it, at ragged shapes and on constructed exact ties (RAGGED_LCP), then timed
   alone, weighted and unweighted:
   [lcp] the per-hypothesis LCP kernel, fp32 tier; [lcp-tiers] its "default"
   and "high3" tiers; [lcp-hb] the hypothesis-block LCP kernel, also against
   the per-hypothesis kernel, on constructed cases (model points at delta,
   far hypotheses, a 1 m box, ties, delta^2 on a row's nearest d2 and one
   float32 step beside it), its units side by side at the coarse call, and
   both kernels on the coarse shape of a scoring call on 4,096-point
   segments; [icp] the segment-stationary ICP kernel, one pass at the ICP
   shapes of both scoring calls (512 and 2,048 segment points), ragged models
   and segments, model points tied across the kernel's slices, and four
   iterations; [lcp-stream] the streaming LCP kernel for
   segments of any size, both tiers, also against the per-hypothesis kernel
   on a segment both take; [lcp-wide] its hypothesis-group variant, also
   against the streaming kernel and on ties across its chunk and tile edges;
   [icp-stream] the model-streaming ICP kernel,
   one pass (also on exact ties across its tiles), four iterations, and a
   singular hypothesis that comes out non-finite as in the plain loop;
4. [runtime] the native host runtime (runtime/physim_runtime.cc) built with
   g++ into build/runtime/, a PLY through it equal to the numpy parser, its
   PPF table's counts equal to numpy's, and the scene's asset preparation
   going through it; [trace] utils/tracing.device_trace around one warm LCP
   scene, the trace file's lcp_segside spans beside the launch count; then
   [e2e] a 640x480 scene of three boxes on a table, ray-cast here in numpy,
   through the port's prepare_object and estimate_pose (GT / PCS / LCP) at the
   default configuration; every object must come back within ADD-S 1 cm, and
   the kernel launch counts of that run must be non-zero;
5. [scoring] score_refine_pipeline at the benchmark's full shape (16,384
   hypotheses) with the production flags, easy and clutter inputs, the launch
   counts of one call (and, from the profiler's spans, the coarse call's
   kernel: the hypothesis-block tensor-core filter, once), both fidelity
   gates against the exact pipeline, the warm latency and the device-idle
   share of one call;
6. the large-segment path: [scoring-large] the same pipeline on 4,096-point
   segments, whose exact tier and whose yardstick pipeline take the streaming
   LCP kernel; [e2e-large] the scene again with max_segment_points = 4096,
   whose hypothesis scoring takes it; the direct calls of [lcp-wide] and
   [icp-stream] are the paths of the two kernels no pipeline routes to;
7. the physics-aware search on the three-box scene at the default configuration,
   run after [e2e-large] and before [scoring]: [leaf] one batch of 128
   placements through the leaf evaluator (settle, splat render, pixel cost) on
   the card against the same batch on the CPU,
   then its warm time, launches and device-idle share; [mcts] and [greedy]
   estimate_pose in MCTS and GREEDY mode, every object within ADD-S 1 cm,
   the LCP stage's lcp_segside launched, the search's time and expansions;
   [debug] estimate_pose in MCTS mode with debug_dir: the JAX package's file
   list, and the final assignment's triangle render on the card against the
   same render on the CPU;
8. the other modes of estimate_pose on the three-box scene (ray-cast, and
   coloured as the networks' training renders are), after [greedy]: [fcn]
   the shipped FCN checkpoints ("small" at the 640x640 canvas, "prior" with
   TTA) and [detect] the shipped detection network, each on the card against
   the same network on the CPU, with their frame times; [e2e-modes] the
   SUPER4PCS, V4PCS and PPF_VOTING generators (GT masks, LCP), every object
   within the ADD-S bar taken from the JAX package on the same scene,
   lcp_segside launched once an object; [e2e-neural] the FCN, FCNThreshold,
   RCNN and RCNNThreshold segmentations with the shipped networks, the
   card's probability images against the CPU's (poses not held: the
   networks were trained on other meshes);
9. the multi-scene paths, after [e2e-neural]: [sweep] scene_sweep.sweep_scenes
   over four scene directories of the three boxes (moved and turned per
   scene, written in the reference layout) at the default configuration, its
   job axis over every card of make_mesh(): each scene against serial
   estimate_pose and within ADD-S 1 cm, unchunked and pipelined, lcp_segside
   launched once a job, no host synchronisation while a batch is queued;
   [sweep-mcts] mcts_select_multi on three of them (1,200 expansions a
   scene, equal to one mcts_select a scene, within ADD-S 1 cm), one shared
   batch's launches a leaf against [leaf]'s, and the sweep's own MCTS mode;
   [serve] the /pose_estimation service booted warm on a local port: three
   requests against direct estimate_pose calls, then 503 + Retry-After beside
   a request in flight with max_queue=0;
   then [train-fcn] and [train-detect]: the training scripts' train() on
   synthetic renders of the three boxes, the first step's loss on the card
   against the CPU, 50 Adam steps whose loss falls, steps a second, and the
   saved checkpoint reloaded on the card and the CPU with the same labels;
10. the evaluation and measurement tools (physimglobalpose_tpu_torch/scripts/),
   through their entry points, after [scoring-large]: [synth-eval] the scene
   generator writes plain and --hard scenes of the three boxes (640x480,
   rendered on the card) and pipeline/evaluate grades them in LCP mode, two in
   MCTS mode and one with the exact EMD: every object of a plain scene within
   ADD-S 1 cm in LCP and MCTS mode, the hard scenes reported; [bench-tool]
   bench_scoring, easy and clutter, its gates before its line; [whole-scene]
   whole_scene_bench (repeat 2, 4 sweep copies, the "small" FCN row);
   [loadtest] server_loadtest (4 clients, 12 requests, max_queue 1) and one
   warm boot in a fresh process; [fcn-eval] eval_fcn_checkpoints;
11. the accuracy tools, after [fcn-eval]: [hard-eval] r4_hard_eval on 8
   --hard scenes of the boxes in LCP, MCTS and GREEDY mode, r5_eval's
   hard_six (the boxes, an ellipsoid, a cylinder and a slab), hard_ycb (the
   boxes under YCB names and class ids, plain-mm depth) on 2 --hard scenes in
   LCP and MCTS mode and rcnn (the shipped detector) on 2 plain scenes in LCP
   mode, then r5_hard_miss_analysis on the hard family's MCTS log, its
   joint-substitution costs on the card against the CPU's; every object
   graded with a finite ADD-S, lcp_segside launched at least once an object
   of each run, lcp_stream never, each section with the JAX section's keys;
   the figures reported, not held; a [phase-times] line times the tool
   phases;
12. one JSON line describing every kernel, the card line, and last a JSON
   line {"ok": true, "device": {...}}.

Imports nothing of JAX. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from physimglobalpose_tpu_torch import kernel_inputs
from physimglobalpose_tpu_torch.kernel_inputs import (
    icp_inputs,
    icp_pass_args,
    lcp_inputs,
    packed_lcp_args,
    stream_lcp_args,
)

PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores (data sheet)
PEAK_BF16_TENSOR_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores (data sheet)
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
TOL_LCP = 2.0  # max abs score error allowed, in units of 1/Nv
# Where kernel and plain version compute d2 with the same bits (the lowered
# tiers of lcp_segside, every tier of lcp_stream) they find the same nearest
# points and the same ties, and only the order of the sum over the model is
# left: the constructed tie cases are held to this.
TOL_LCP_SAME_D2 = 1e-6
# ICP pass (A, b) against the plain version, relative to the largest entry:
# both find the same correspondences and weights, only the order of the
# float32 sums over ~500 correspondences differs.
TOL_ICP_PASS = 1e-4
# Four ICP iterations over the kernel against the same loop over the plain
# pass: mean model-point displacement per hypothesis, metres. A last-bit
# difference in a pose can move a bf16 rounding of the "default" tier and with
# it a correspondence, so the loops part by more than one pass does.
TOL_ICP_REFINE = 1e-4

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


def render_scene(cam_pose: np.ndarray, boxes=BOXES):
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
        for _name, cls, size, xy, yaw in boxes:
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


def class_color(class_id: int) -> np.ndarray:
    """The per-class RGB (0-1) of the synthetic renders the shipped FCN and
    detector were trained on (a copy of the JAX package's
    utils/synthdata.class_color)."""
    rng = np.random.default_rng(1000 + class_id)
    hue = rng.uniform(0.0, 1.0)
    i = int(hue * 6) % 6
    f = hue * 6 - int(hue * 6)
    v, s = 0.85, 0.75
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    rgb = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)][i]
    return np.asarray(rgb, np.float32)


def shade_scene(depth: np.ndarray, label: np.ndarray, seed: int = 0) -> np.ndarray:
    """A uint8 [H, W, 3] color image of the ray-cast scene: each box in its
    class color, shaded darker with depth, on a grey table, with sensor noise
    (the appearance model of the training renders, utils/synthdata.py's
    colorize_from_label_depth without domain randomization)."""
    rng = np.random.default_rng(seed)
    obj = label > 0
    color = np.full(label.shape + (3,), rng.uniform(0.1, 0.5), np.float32)
    color += rng.normal(scale=0.05, size=color.shape)
    shade = np.where(obj, 1.0 - 0.5 * (depth - depth[obj].min()), 1.0)
    for c in np.unique(label[obj]):
        sel = label == c
        color[sel] = class_color(int(c)) * shade[sel, None]
    color += rng.normal(scale=0.03, size=color.shape)
    color *= rng.uniform(0.8, 1.2)
    return (np.clip(color, 0.0, 1.0) * 255).astype(np.uint8)


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
    return write_mesh_ply(path, verts, tris)


def write_mesh_ply(path: str, verts, faces):
    """An ascii PLY of (verts [V, 3], triangles [F, 3]). Returns them as
    float32 and int32 arrays."""
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n")
        fh.write(f"element vertex {len(verts)}\nproperty float x\nproperty float y\nproperty float z\n")
        fh.write(f"element face {len(faces)}\nproperty list uchar int vertex_indices\nend_header\n")
        for v in verts:
            fh.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in faces:
            fh.write(f"3 {t[0]} {t[1]} {t[2]}\n")
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def ellipsoid_mesh(radii=(0.06, 0.04, 0.03), n_lat=16, n_lon=24):
    """A closed triangulated ellipsoid centred at the origin, faces wound
    outward: (vertices [V, 3] float32, faces [F, 3] int32) with
    F = 2 n_lon (n_lat - 1)."""
    theta = np.linspace(0, np.pi, n_lat + 1)[1:-1]  # the rings between the poles
    phi = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    ring = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)], -1)
    verts = np.concatenate([[[0, 0, 1]], ring.reshape(-1, 3), [[0, 0, -1]]]) * np.asarray(radii)
    bottom = len(verts) - 1
    idx = lambda i, j: 1 + i * n_lon + j % n_lon  # noqa: E731
    faces = [(0, idx(0, j), idx(0, j + 1)) for j in range(n_lon)]
    for i in range(n_lat - 2):
        for j in range(n_lon):
            faces += [(idx(i, j), idx(i + 1, j), idx(i + 1, j + 1)),
                      (idx(i, j), idx(i + 1, j + 1), idx(i, j + 1))]
    faces += [(bottom, idx(n_lat - 2, j + 1), idx(n_lat - 2, j)) for j in range(n_lon)]
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def cylinder_mesh(radius=0.035, height=0.1, n_seg=32):
    """A closed cylinder along z centred at the origin, faces wound outward:
    (vertices [2 n_seg + 2, 3] float32, faces [4 n_seg, 3] int32)."""
    phi = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    ring = np.stack([radius * np.cos(phi), radius * np.sin(phi)], -1)
    h = height / 2
    verts = np.concatenate([np.c_[ring, np.full(n_seg, -h)], np.c_[ring, np.full(n_seg, h)],
                            [[0, 0, -h], [0, 0, h]]])
    bottom, top = 2 * n_seg, 2 * n_seg + 1
    faces = []
    for j in range(n_seg):
        k = (j + 1) % n_seg
        faces += [(j, k, n_seg + k), (j, n_seg + k, n_seg + j),
                  (bottom, k, j), (top, n_seg + j, n_seg + k)]
    return verts.astype(np.float32), np.asarray(faces, np.int32)


# The sweep's scenes: each box of BOXES shifted by (dx, dy) m and turned by a
# yaw (deg), per scene.
SWEEP_MOVES = (((0.0, 0.0), 0.0), ((0.012, -0.01), 10.0), ((-0.01, 0.014), -15.0),
               ((0.015, 0.012), 25.0))


def moved_boxes(move) -> list:
    (dx, dy), turn = move
    return [(name, cls, size, (xy[0] + dx, xy[1] + dy), yaw + turn)
            for name, cls, size, xy, yaw in BOXES]


def _tq(pose: np.ndarray) -> list:
    """gt_info.yml's pose format: [x y z qw qx qy qz]."""
    from physimglobalpose_tpu_torch.geometry import se3

    q = se3.matrix_to_quat(torch.as_tensor(pose[:3, :3], dtype=torch.float64)).tolist()
    return [float(v) for v in pose[:3, 3]] + q


def write_scene_dir(path: str, cam_pose: np.ndarray, boxes) -> dict:
    """A scene directory in the reference layout (APC: gt_info.yml with the
    camera and the boxes' poses, frame-000000.{depth,mask,color}.png) of the
    ray-cast `boxes`. Returns {name: world pose}."""
    from PIL import Image

    from physimglobalpose_tpu_torch.geometry import depthio

    os.makedirs(path)
    depth, label = render_scene(cam_pose, boxes)
    depthio.write_depth_png(os.path.join(path, "frame-000000.depth.png"), depth, bit_rotated=True)
    Image.fromarray(label.astype(np.uint8)).save(os.path.join(path, "frame-000000.mask.png"))
    Image.fromarray(shade_scene(depth, label)).save(os.path.join(path, "frame-000000.color.png"))
    gt = {name: box_pose_world(size, xy, yaw) for name, _cls, size, xy, yaw in boxes}
    info = {"camera": {"camera_intrinsics": INTRINSICS.tolist(), "camera_pose": _tq(cam_pose)},
            "scene": {"num_objects": len(boxes),
                      **{f"object_{i + 1}": {"name": name, "pose": _tq(gt[name])}
                         for i, name in enumerate(gt)}}}
    with open(os.path.join(path, "gt_info.yml"), "w") as fh:
        json.dump(info, fh)  # JSON is YAML
    return gt


# ----------------------------------------------------------------- LCP inputs


# Shapes and inputs that the kernels' tiling makes ragged: a model that is no
# multiple of a warp's tile, one hypothesis, a segment of one point and of one
# short of 1,024, no unmasked point, the masked points first, and exact ties of
# the nearest distance (16 segment points placed again `offset` rows on, with
# their own normals and probabilities): inside one chunk of 32 points, in two
# and three chunks, and 1,024 rows on, where two chunks share a bit of
# lcp_segside's mask. (label, seed, H, Nv, Ns, masked, twist)
RAGGED_LCP = (
    ("h1_nv300", 100, 1, 300, 333, 10, None),
    ("h33_nv77", 101, 33, 77, 200, 5, None),
    ("ns1", 102, 5, 256, 1, 0, None),
    ("ns1023", 103, 9, 512, 1023, 30, None),
    ("all_masked", 104, 5, 256, 200, 0, "all_masked"),
    ("masked_first", 105, 7, 600, 300, 0, "masked_first"),
    ("tie_one_chunk", 106, 8, 512, 256, 6, (16,)),
    ("tie_two_chunks", 107, 8, 512, 256, 6, (40,)),
    ("tie_three_chunks", 108, 8, 300, 256, 6, (40, 70)),
    ("tie_shared_bit", 109, 4, 512, 2048, 6, (1024,)),
)


def ragged_lcp_inputs(seed, h, nv, ns, masked, twist, device):
    """lcp_inputs with the twist of a RAGGED_LCP row applied; also the rows
    that were placed again (empty unless the twist is a tie)."""
    args = lcp_inputs(seed, h, nv, ns, masked, device)
    spts, smask = args[3], args[6]
    copies = []
    if twist == "all_masked":
        smask[:] = False
    elif twist == "masked_first":
        smask[:100] = False
    elif twist is not None:
        smask[:16] = True
        for offset in twist:
            spts[offset:offset + 16] = spts[:16]
            smask[offset:offset + 16] = True
            copies += range(offset, offset + 16)
    return args, copies


def tie_effect(score_fn, args, copies) -> float:
    """How far the scores move when the rows placed again are masked: above 0
    when the case really has ties that the tie rule decides."""
    masked = list(args)
    masked[6] = args[6].clone()
    masked[6][copies] = False
    return float((score_fn(*args) - score_fn(*masked)).abs().max())


def cuda_time_ms(fn, reps: int, warmup: int = 2, inner: int = 1) -> float:
    """Median time of fn() on the card. Each run is `inner` calls between two
    CUDA events, divided by inner: for a kernel of well under a millisecond
    many queued launches keep the host's launch cost out of the reading."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
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


# Registers a thread of each kernel the build compiled (ptxas), by its mangled
# name; filled by phase_build.
REGISTERS: dict[str, int] = {}


def phase_build() -> float:
    from physimglobalpose_tpu_torch import _build

    secs = _build.build()
    log(f"[build] {len(_build.KERNEL_SOURCES)} kernel source(s) built in {secs:.2f} s")
    for name, text in _build.BUILD_LOG.items():
        kernel = full = spills = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                # The mangled name holds the kernel and its template arguments
                # (Li<tier>E, Lb<weighted>E, Li<model points per thread>E).
                full = line.split("'")[1].split("_GLOBAL__N_", 1)[-1]
                kernel = full[-60:]
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line or "smem" in line or "error" in line.lower():
                log(f"[build] {name}: {kernel}: {line.strip()}; {spills}")
                used = re.search(r"Used (\d+) registers", line)
                if used:
                    REGISTERS[full] = int(used.group(1))
    return secs


def registers_of(kernel: str) -> dict[str, int]:
    """The ptxas register counts of the built kernels whose name holds `kernel`."""
    return {k: v for k, v in REGISTERS.items() if kernel in k}


def phase_runtime(workdir: str) -> dict:
    """[runtime] the native host runtime (runtime/physim_runtime.cc) built
    with g++ from the checkout into build/runtime/; a PLY loads through it
    equal to the numpy parser, and its PPF table build gives the numpy
    bins' counts. (main requires that the assets of the scene phases then
    load through it.)"""
    from physimglobalpose_tpu_torch import runtime
    from physimglobalpose_tpu_torch.models import assets
    from physimglobalpose_tpu_torch.ops import ppf

    t0 = time.perf_counter()
    if runtime.get_lib() is None:
        fail(f"[runtime] the native runtime did not build: {runtime.BUILD_LOG[-2000:]}")
    build_s = time.perf_counter() - t0
    ply = os.path.join(workdir, "runtime_box.ply")
    write_box_ply(ply, BOXES[0][2])
    nat = runtime.load_mesh_native(ply)
    py = assets.load_ply(ply)
    if nat is None or not (np.array_equal(nat[0], py.vertices) and np.array_equal(nat[1], py.faces)):
        fail("[runtime] the native PLY parser disagrees with the numpy parser")
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.05, 0.05, size=(200, 3)).astype(np.float32)
    nrm = rng.normal(size=(200, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    offsets, counts, pairs = runtime.build_ppf_native(pts, nrm, 5, 10, 640)
    ii, jj = np.nonzero(~np.eye(len(pts), dtype=bool))
    bins = ppf.ppf_bins_np(pts[ii], nrm[ii], pts[jj], nrm[jj])
    bins = bins[bins >= 0]
    if not np.array_equal(counts, np.bincount(bins, minlength=len(counts))):
        fail("[runtime] the native PPF table's bin counts differ from numpy's")
    log(f"[runtime] build/runtime/{runtime.library_path().name} built and loaded in "
        f"{build_s:.2f} s; a {len(py.faces)}-face PLY equals the numpy parser; PPF table of "
        f"200 points: {int(counts.sum())} pairs in {int((counts > 0).sum())} bins, the numpy "
        f"counts")
    return {"build_s": build_s, "ppf_pairs": int(counts.sum())}


def check_ragged(tag, rows, tiers, kernels, plain, same_d2, device) -> None:
    """Each of `kernels` (name -> scores(args, **kw)) against `plain` on the
    RAGGED_LCP-style `rows` (a trailing dict of extra keywords allowed),
    weighted and unweighted, in the given tiers. same_d2(tier): kernel and
    plain compute d2 with the same bits there, which holds the tie cases to
    TOL_LCP_SAME_D2."""
    for label, seed, h, nv, ns, masked, twist, *extra in rows:
        args, copies = ragged_lcp_inputs(seed, h, nv, ns, masked, twist, device)
        for tier in tiers:
            tol = TOL_LCP_SAME_D2 if copies and same_d2(tier) else TOL_LCP / nv
            for weighted in (True, False):
                kw = dict(weighted=weighted, matmul_precision=tier, **(extra[0] if extra else {}))
                want = plain(*args, **kw)
                errs = {}
                for name, kernel in kernels.items():
                    if name == "tensor cores" and (tier is None or weighted):
                        continue  # the unweighted lowered tiers alone have that unit
                    got = kernel(args, **kw)
                    errs[name] = _check_scores(tag, f"{label} {tier} weighted={weighted} {name}",
                                               got, want, h, tol)
                    if twist == "all_masked" and float(got.abs().max()) != 0.0:
                        fail(f"{tag} {name}: an all-masked segment scored above 0")
                note = ""
                if copies and weighted:
                    effect = tie_effect(lambda *a: plain(*a, **kw), args, copies)
                    note = f" tie_effect={effect:.3e}"
                    if effect == 0.0:
                        fail(f"{tag} {label}: the case has no tie that matters")
                log(f"{tag} {label} H={h} Nv={nv} Ns={ns} {kw}: max_abs_err="
                    + ", ".join(f"{e:.3e} ({k})" for k, e in errs.items())
                    + f" (tol {tol:.3e}) mean_score={float(want.mean()):.4f}{note}")


def check_ragged_lcp(tag, tiers, device) -> None:
    """lcp_segside against lcp_scores_plain on RAGGED_LCP: through lcp_scores
    (the launcher's own choice of unit) and, unweighted in the lowered tiers,
    on the tensor-core filter, which finishes with the same d2. The fp32 plain
    version takes d2 from a matrix product, the lowered ones term by term as
    the kernel does."""
    from physimglobalpose_tpu_torch.ops import lcp

    check_ragged(tag, RAGGED_LCP, tiers, {
        "lcp_scores": lambda args, **kw: lcp.lcp_scores(*args, hb_lane_pack=False, **kw),
        "tensor cores": lambda args, weighted, matmul_precision: lcp._lcp_segside_on_unit(
            lcp._UNIT_TENSOR_CORES, *packed_lcp_args(args), weighted, matmul_precision),
    }, lcp.lcp_scores_plain, lambda tier: tier is not None, device)


def phase_empty_launch(device) -> float:
    """Time of a launch that does nothing (lcp_empty_kernel, queued back to
    back): the floor under every kernel whose bound is a few microseconds."""
    import ctypes

    from physimglobalpose_tpu_torch import _build

    launch = _build.load("lcp_segside").lcp_empty_launch
    launch.argtypes, launch.restype = [ctypes.c_void_p], ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream

    def run():
        if launch(stream) != 0:
            fail("the empty kernel did not launch")

    ms = cuda_time_ms(run, reps=5, inner=200)
    log(f"[launch] an empty kernel takes {ms * 1e3:.2f} us a launch (200 queued back to back)")
    return ms


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

    check_ragged_lcp("[lcp]", (None,), device)

    # Timing at the main path's per-object call: H = 10,000, Nv 4096, Ns 1024.
    h, nv, ns = 10_000, 4096, 1024
    args = lcp_inputs(10, h, nv, ns, 24, device)
    err = float((lcp.lcp_scores(*args) - lcp.lcp_scores_plain(*args)).abs().max())
    log(f"[lcp] main-path H={h} Nv={nv} Ns={ns} weighted=True: max_abs_err={err:.3e}")
    if err > TOL_LCP / nv:
        fail("lcp_segside disagrees with plain at the main-path H")
    worst = max(worst, err)
    # The kernel's wrapper on packed arguments, two launches queued per reading
    # (as the other phases time theirs); lcp_scores adds the centring and the
    # packing, a dozen small PyTorch launches that the host sends first.
    packed = packed_lcp_args(args)
    kernel_ms = cuda_time_ms(lambda: lcp.lcp_segside(*packed, True), reps=5, inner=2)
    kernel_u_ms = cuda_time_ms(lambda: lcp.lcp_segside(*packed, False), reps=5, inner=2)
    scores_ms = cuda_time_ms(lambda: lcp.lcp_scores(*args, weighted=True), reps=5)
    cores_u_ms = cuda_time_ms(
        lambda: lcp._lcp_segside_on_unit(lcp._UNIT_CUDA_CORES, *packed, False), reps=5, inner=2)
    plain_ms = cuda_time_ms(lambda: lcp.lcp_scores_plain(*args, weighted=True), reps=3, warmup=1)
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
        f"{kernel_u_ms:.3f} (unweighted, the launcher's choice; on the CUDA cores named "
        f"{cores_u_ms:.3f}) lcp_scores_ms={scores_ms:.3f} (weighted, with centring and packing) "
        f"plain_ms={plain_ms:.3f} cdist_yardstick_ms={cdist_ms:.3f}")
    log(f"[lcp] bound: {flops:.3e} FLOP (8/pair) -> {bound_ms:.3f} ms, share {bound_ms / kernel_ms:.3f}; "
        f"16 FLOP/pair count {16.0 * pairs:.3e} -> {flop16_ms:.3f} ms, share {flop16_ms / kernel_ms:.3f}")
    return dict(max_abs_err=worst, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                unweighted_ms=kernel_u_ms, unweighted_warp_items_ms=cores_u_ms,
                lcp_scores_ms=scores_ms, cdist_yardstick_ms=cdist_ms, flop16_bound_ms=flop16_ms)


def _pair_ops_s(pairs: float, tier: str | None) -> tuple[float, float]:
    """Least seconds the card needs for the per-pair work of a nearest-point
    search over `pairs` (point, point) pairs in the given tier, and beside it
    the seconds of the same tier's instruction mix on the CUDA cores alone.

    fp32: 3 FMA + 1 add for d2 and the running min, 8 FLOP a pair at the fp32
    peak. "default": the d2 product is a K = 5 product of bf16 operands with a
    float32 sum, 10 FLOP a pair at the bf16 tensor-core peak; the running min,
    1 operation a pair, stays on the CUDA cores; the two units work side by
    side, so the slower one binds. "high3" emulates a float32 product: three
    such bf16 passes on the tensor cores or the 7 FLOP of the float32 product
    on the CUDA cores, whichever is less, beside the same running min.
    The CUDA-core figure counts what the kernels here issue: 8 FLOP a pair
    for "default" (round, widen, the fp32 chain), 20 for "high3" (9 FMA, an
    add, the min).
    """
    min_s = pairs / PEAK_FP32_FLOPS
    if tier is None:
        return 8.0 * pairs / PEAK_FP32_FLOPS, 8.0 * pairs / PEAK_FP32_FLOPS
    passes = 3 if tier == "high3" else 1
    product_s = min(passes * 10.0 * pairs / PEAK_BF16_TENSOR_FLOPS, 7.0 * pairs / PEAK_FP32_FLOPS)
    core_flop = 20.0 if tier == "high3" else 8.0
    return max(product_s, min_s), core_flop * pairs / PEAK_FP32_FLOPS


def _lcp_bound_ms(h: int, nv: int, ns: int, tier: str | None) -> tuple[float, float]:
    """Least time for one LCP call, (bound_ms, cuda_core_bound_ms): the pair
    work of _pair_ops_s plus 40 FLOP a (hypothesis, model point) for the
    transform and the normal gate at the fp32 peak, against the bytes of its
    inputs and outputs at the memory rate."""
    per_point_s = 40.0 * h * nv / PEAK_FP32_FLOPS
    bytes_s = 4.0 * (12 * h + 6 * nv + 8 * ns + h) / PEAK_HBM_BYTES
    ops_s, core_s = _pair_ops_s(float(h) * nv * ns, tier)
    return max(ops_s + per_point_s, bytes_s) * 1e3, max(core_s + per_point_s, bytes_s) * 1e3


def _cdist_scores_ms(args, delta: float = 0.005, chunk: int = 256) -> float:
    """One-library-call yardstick of the unweighted score: torch.cdist(...)
    .amin(-1) <= delta, averaged over the model, in chunks of `chunk`
    hypotheses."""
    tfs, mpts, _, spts = args[:4]

    def run():
        u = torch.einsum("hij,nj->hni", tfs[:, :3, :3], mpts) + tfs[:, None, :3, 3]
        for uc in u.split(chunk):
            (torch.cdist(uc, spts).amin(-1) <= delta).float().mean(-1)

    return cuda_time_ms(run, reps=3, warmup=1)


def phase_lcp_tiers(device) -> dict:
    """lcp_segside's "default" and "high3" tiers against lcp_scores_plain of
    the same tier: at the bulk fine and exact shapes of the scoring path and
    at ragged shapes with masked points; then timed beside the fp32 tier."""
    from physimglobalpose_tpu_torch.ops import lcp

    cases = (
        # (label, seed, H, Nv, Ns, masked)
        ("fine", 20, 256, 4096, 256, 8),
        ("exact", 21, 32, 4096, 1024, 24),
        ("ragged", 22, 37, 1000, 333, 40),
        ("ragged_ns1500", 23, 9, 2500, 1500, 7),
    )
    stats = {}
    for label, seed, h, nv, ns, masked in cases:
        args = lcp_inputs(seed, h, nv, ns, masked, device)
        for tier in ("default", "high3"):
            for weighted in (True, False):
                got = lcp.lcp_scores(*args, weighted=weighted, matmul_precision=tier,
                                     hb_lane_pack=False)
                want = lcp.lcp_scores_plain(*args, weighted=weighted, matmul_precision=tier)
                f32 = lcp.lcp_scores_plain(*args, weighted=weighted)
                torch.cuda.synchronize()
                if not bool(torch.isfinite(got).all()) or got.shape != (h,):
                    fail(f"lcp_segside[{tier}] {label}: non-finite or misshapen output")
                err = float((got - want).abs().max())
                on_tensor = ""
                if not weighted:
                    err_t = _check_scores(
                        "[lcp-tiers]", f"{label} {tier} unweighted on the tensor cores",
                        lcp._lcp_segside_on_unit(lcp._UNIT_TENSOR_CORES, *packed_lcp_args(args),
                                                 False, tier), want, h, TOL_LCP / nv)
                    on_tensor = f" on the tensor cores {err_t:.3e}"
                log(f"[lcp-tiers] {label} H={h} Nv={nv} Ns={ns} tier={tier} weighted={weighted}: "
                    f"max_abs_err={err:.3e}{on_tensor} (tol {TOL_LCP / nv:.3e}) "
                    f"tier_vs_fp32={float((want - f32).abs().max()):.3e} "
                    f"mean_score={float(want.mean()):.4f}")
                if err > TOL_LCP / nv:
                    fail(f"lcp_segside[{tier}] disagrees with plain on {label} (weighted={weighted})")
                if (label, tier) in (("fine", "default"), ("exact", "high3")):
                    stats.setdefault(tier, dict(max_abs_err=0.0))
                    stats[tier]["max_abs_err"] = max(stats[tier]["max_abs_err"], err)
        if label in ("fine", "exact"):
            tier = "default" if label == "fine" else "high3"
            packed = packed_lcp_args(args)
            run = lambda t: cuda_time_ms(
                lambda: lcp.lcp_segside(*packed, True, t), reps=5, inner=20)
            ms = {t: run(t) for t in (None, "default", "high3")}
            unweighted_ms = cuda_time_ms(
                lambda: lcp.lcp_segside(*packed, False, tier), reps=5, inner=20)
            # The unweighted tier's two units side by side: (CUDA cores, tensor cores).
            units_ms = tuple(cuda_time_ms(
                lambda: lcp._lcp_segside_on_unit(unit, *packed, False, tier), reps=5, inner=20)
                for unit in (lcp._UNIT_CUDA_CORES, lcp._UNIT_TENSOR_CORES))
            plain_ms = cuda_time_ms(
                lambda: lcp.lcp_scores_plain(*args, matmul_precision=tier), reps=3, warmup=1)
            # The other LCP kernel on this shape (it has no "high3" tier and
            # runs its fp32 one): what a measured routing rule would compare.
            hb_tier = None if tier == "high3" else tier
            hb_ms = cuda_time_ms(
                lambda: lcp.lcp_segside_hb(*packed, True, hb_tier), reps=5, inner=20)
            bound, core_bound = _lcp_bound_ms(h, nv, ns, tier)
            cdist_ms = _cdist_scores_ms(args)
            log(f"[lcp-tiers] timed {label} H={h} Nv={nv} Ns={ns} weighted: fp32={ms[None]:.4f} ms "
                f"default={ms['default']:.4f} ms high3={ms['high3']:.4f} ms; "
                f"unweighted {tier}={unweighted_ms:.4f} ms, on (CUDA cores, tensor cores) "
                f"({units_ms[0]:.4f}, {units_ms[1]:.4f}) ms; "
                f"lcp_segside_hb[{hb_tier}]={hb_ms:.4f} ms; plain[{tier}]="
                f"{plain_ms:.3f} ms; bound[{tier}]={bound:.5f} ms share {bound / ms[tier]:.4f} "
                f"(CUDA cores alone {core_bound:.5f} ms share {core_bound / ms[tier]:.3f}); "
                f"cdist_yardstick={cdist_ms:.3f} ms")
            stats[tier].update(ms=ms[tier], fp32_ms=ms[None], plain_ms=plain_ms, bound_ms=bound,
                               cuda_core_bound_ms=core_bound, lcp_segside_hb_ms=hb_ms,
                               cdist_yardstick_ms=cdist_ms, shape=[h, nv, ns],
                               unweighted_ms=unweighted_ms,
                               unweighted_cuda_cores_ms=units_ms[0],
                               unweighted_tensor_cores_ms=units_ms[1])
    check_ragged_lcp("[lcp-tiers]", ("default", "high3"), device)
    check_large_model("[lcp-tiers]", device)
    return stats


def check_large_model(tag, device) -> None:
    """lcp_segside's two units against each other and against plain on a box
    eight times the size (about 1 m, |u| some hundred times delta), where the
    rounding of the tensor-core filter's sum is largest against delta^2: the
    unit the launcher chooses must be the filter, and the scores the same."""
    from physimglobalpose_tpu_torch.ops import lcp

    h, nv, ns = 512, 1024, 1024
    args = lcp_inputs(24, h, nv, ns, 24, device, scale=8.0)
    packed = packed_lcp_args(args)
    for tier in ("default", "high3"):
        if lcp._lcp_segside_unit_for(h, nv, ns, False, tier) != lcp._UNIT_TENSOR_CORES:
            fail(f"{tag} large_model: the launcher does not take the tensor-core filter")
        want = lcp.lcp_scores_plain(*args, weighted=False, matmul_precision=tier)
        got = {unit: lcp._lcp_segside_on_unit(unit, *packed, False, tier)
               for unit in (lcp._UNIT_CUDA_CORES, lcp._UNIT_TENSOR_CORES)}
        got["rule"] = lcp.lcp_segside(*packed, False, tier)
        errs = {k: _check_scores(tag, f"large_model {tier} unit={k}", v, want, h, TOL_LCP / nv)
                for k, v in got.items()}
        between = float((got[lcp._UNIT_CUDA_CORES] - got[lcp._UNIT_TENSOR_CORES]).abs().max())
        mean = float(want.mean())
        log(f"{tag} large_model H={h} Nv={nv} Ns={ns} tier={tier} unweighted: max_abs_err="
            f"{errs} (tol {TOL_LCP / nv:.3e}); CUDA cores against tensor cores {between:.3e} "
            f"(tol {TOL_LCP_SAME_D2:.0e}); mean_score={mean:.4f}")
        if between > TOL_LCP_SAME_D2 or not torch.equal(got["rule"], got[lcp._UNIT_TENSOR_CORES]):
            fail(f"{tag} large_model {tier}: the two units disagree")
        if not 0.01 < mean < 0.99:
            fail(f"{tag} large_model: the case has no mix of inliers and outliers")


def check_hb_cases(device) -> None:
    """lcp_segside_hb on constructed inputs (model points at delta, far
    hypotheses, a 1 m box, and the ragged and tie rows of RAGGED_LCP), within
    TOL_LCP / Nv of plain and of lcp_segside (TOL_LCP_SAME_D2 on the tie rows
    of the "default" tier, where both compute d2 with the same bits)."""
    from physimglobalpose_tpu_torch.ops import lcp

    cases = {
        "at_delta": lambda: kernel_inputs.at_delta_inputs(device),
        "clutter_far_hypotheses": lambda: kernel_inputs.far_hypotheses(
            lcp_inputs(37, 2048, 256, 256, 6, device)),
        "box_1m": lambda: lcp_inputs(38, 512, 256, 256, 6, device, scale=8.0),
    }
    for label, make in cases.items():
        args = make()
        packed = packed_lcp_args(args)
        h, nv = args[0].shape[0], args[1].shape[0]
        for tier in (None, "default"):
            for weighted in (False, True):
                got = lcp.lcp_segside_hb(*packed, weighted, tier)
                want = lcp.lcp_scores_plain(*args, weighted=weighted, matmul_precision=tier)
                k1 = lcp.lcp_segside(*packed, weighted, tier)
                err = _check_scores("[lcp-hb]", f"{label} {tier} weighted={weighted}", got, want,
                                    h, TOL_LCP / nv)
                err_k1 = _check_scores("[lcp-hb]", f"{label} {tier} vs lcp_segside", got, k1, h,
                                       TOL_LCP / nv)
                log(f"[lcp-hb] {label} H={h} Nv={nv} Ns={args[3].shape[0]} tier={tier} "
                    f"weighted={weighted}: vs_plain={err:.3e} vs_lcp_segside={err_k1:.3e} "
                    f"(tol {TOL_LCP / nv:.3e}) mean_score={float(want.mean()):.4f}")
    rows = tuple(r for r in RAGGED_LCP if r[0] in (
        "ns1", "all_masked", "tie_one_chunk", "tie_two_chunks", "tie_three_chunks", "tie_shared_bit"))
    check_ragged("[lcp-hb]", rows, (None, "default"), {
        "lcp_segside_hb": lambda args, weighted, matmul_precision: lcp.lcp_segside_hb(
            *packed_lcp_args(args), weighted, matmul_precision),
    }, lcp.lcp_scores_plain, lambda tier: tier is not None, device)
    check_hb_band(device)


def check_hb_band(device) -> None:
    """lcp_segside_hb on kernel_inputs.band_inputs, with delta^2 on a row's
    nearest d2 and one float32 step to either side of it: against plain and
    lcp_segside, TOL_LCP_SAME_D2 in the "default" tier (the same d2 bits), and
    there, unweighted, every unit of lcp_segside_hb bit for bit against
    lcp_segside. (Not against plain: on the card PyTorch divides its count by
    Nv through a reciprocal, a last-bit difference where Nv is no power of 2.)"""
    from physimglobalpose_tpu_torch.ops import lcp

    args = kernel_inputs.band_inputs(device)
    h, nv = args[0].shape[0], args[1].shape[0]
    for tier in (None, "default"):
        for side in (0, 1, -1):
            delta = kernel_inputs.band_delta(args, tier, side)
            packed = packed_lcp_args(args, delta=delta)
            for weighted in (False, True):
                want = lcp.lcp_scores_plain(*args, delta=delta, weighted=weighted,
                                            matmul_precision=tier)
                got = lcp.lcp_scores(*args, delta=delta, weighted=weighted, matmul_precision=tier,
                                     hb_lane_pack=True)
                k1 = lcp.lcp_segside(*packed, weighted, tier)
                same = tier is not None
                tol = TOL_LCP_SAME_D2 if same else TOL_LCP / nv
                what = f"band side={side} {tier} weighted={weighted}"
                err = _check_scores("[lcp-hb]", what + " vs plain", got, want, h, tol)
                err_k1 = _check_scores("[lcp-hb]", what + " vs lcp_segside", got, k1, h, tol)
                note = ""
                if same and not weighted:
                    units = {u: lcp._lcp_segside_hb_on_unit(u, *packed, False, tier) for u in (
                        lcp._HB_UNIT_CUDA_CORES, lcp._HB_UNIT_TENSOR_CORES)}
                    units["rule"] = got
                    differ = [u for u, v in units.items() if not torch.equal(v, k1)]
                    if differ:
                        fail(f"[lcp-hb] {what}: units {differ} are not lcp_segside's bits")
                    note = " (every unit lcp_segside's bits)"
                log(f"[lcp-hb] {what} H={h} Nv={nv} Ns={args[3].shape[0]} delta^2={delta * delta:.9e}: "
                    f"vs_plain={err:.3e} vs_lcp_segside={err_k1:.3e} (tol {tol:.1e}){note} "
                    f"mean_score={float(want.mean()):.4f}")


def phase_lcp_hb(device) -> dict:
    """lcp_segside_hb against lcp_scores_plain and against lcp_segside: at the
    coarse shape of the scoring path, at ragged H and Nv, once with a model
    that needs the tile loop, and on the constructed cases of check_hb_cases;
    then timed beside lcp_segside."""
    from physimglobalpose_tpu_torch.ops import lcp

    cases = (
        # (label, seed, H, Nv, Ns, masked)
        ("coarse", 30, 16384, 256, 256, 6),
        ("ragged", 31, 1003, 300, 200, 15),
        ("ragged_tiny", 32, 5, 77, 50, 3),
        ("tile_loop", 33, 67, 4096, 256, 9),
    )
    worst = 0.0
    for label, seed, h, nv, ns, masked in cases:
        args = lcp_inputs(seed, h, nv, ns, masked, device)
        for tier in (None, "default"):
            for weighted in (True, False):
                before = lcp.lcp_segside_hb.launches
                got = lcp.lcp_scores(*args, weighted=weighted, matmul_precision=tier,
                                     hb_lane_pack=True)
                if lcp.lcp_segside_hb.launches != before + 1:
                    fail(f"lcp_segside_hb {label}: the call did not take the hypothesis-block kernel")
                k1 = lcp.lcp_scores(*args, weighted=weighted, matmul_precision=tier,
                                    hb_lane_pack=False)
                want = lcp.lcp_scores_plain(*args, weighted=weighted, matmul_precision=tier)
                torch.cuda.synchronize()
                if not bool(torch.isfinite(got).all()) or got.shape != (h,):
                    fail(f"lcp_segside_hb {label}: non-finite or misshapen output")
                err = float((got - want).abs().max())
                err_k1 = float((got - k1).abs().max())
                log(f"[lcp-hb] {label} H={h} Nv={nv} Ns={ns} tier={tier} weighted={weighted}: "
                    f"vs_plain={err:.3e} vs_lcp_segside={err_k1:.3e} (tol {TOL_LCP / nv:.3e}) "
                    f"mean_score={float(want.mean()):.4f}")
                if err > TOL_LCP / nv:
                    fail(f"lcp_segside_hb disagrees with plain on {label} ({tier}, {weighted})")
                if err_k1 > TOL_LCP / nv:
                    fail(f"lcp_segside_hb disagrees with lcp_segside on {label} ({tier}, {weighted})")
                if label == "coarse":
                    worst = max(worst, err)
        if label == "coarse":
            stats = time_hb_coarse(args, h, nv, ns)
    stats["max_abs_err"] = worst
    check_hb_cases(device)

    # The coarse call of the scoring path on 4,096-point segments (every 4th
    # point: Ns 1,024), which the routing rule hands to lcp_segside and its
    # launcher to the tensor-core filter: both kernels and both units on all
    # 16,384 hypotheses, as the path launches them, against plain.
    h, nv, ns = 16384, 256, 1024
    args = lcp_inputs(34, h, nv, ns, 24, device)
    packed = packed_lcp_args(args)
    if lcp._lcp_segside_unit_for(h, nv, ns, False, "default") != lcp._UNIT_TENSOR_CORES:
        fail("[lcp-hb] coarse_ns1024: the launcher does not take the tensor-core filter")
    if lcp._lcp_segside_unit_for(h, nv, ns, True, "default") != lcp._UNIT_CUDA_CORES:
        fail("[lcp-hb] coarse_ns1024: a weighted call does not stay on the CUDA cores")
    timed = {}
    for weighted in (False, True):
        want = lcp.lcp_scores_plain(*args, weighted=weighted, matmul_precision="default",
                                    h_chunk=512)
        runs = {"lcp_segside": lambda: lcp.lcp_segside(*packed, weighted, "default"),
                "lcp_segside_hb": lambda: lcp.lcp_segside_hb(*packed, weighted, "default"),
                "lcp_segside on the CUDA cores": lambda: lcp._lcp_segside_on_unit(
                    lcp._UNIT_CUDA_CORES, *packed, weighted, "default")}
        if not weighted:
            runs["lcp_segside on the tensor cores"] = lambda: lcp._lcp_segside_on_unit(
                lcp._UNIT_TENSOR_CORES, *packed, False, "default")
        for name, run in runs.items():
            err = _check_scores("[lcp-hb]", f"coarse_ns1024 {name} weighted={weighted}",
                                run(), want, h, TOL_LCP / nv)
            timed[name, weighted] = cuda_time_ms(run, reps=5, inner=5)
            log(f"[lcp-hb] coarse_ns1024 H={h} Nv={nv} Ns={ns} default weighted={weighted} {name}: "
                f"max_abs_err={err:.3e} (tol {TOL_LCP / nv:.3e}) mean_score={float(want.mean()):.4f}")
    units = {(1, False): timed["lcp_segside on the CUDA cores", False],
             (2, False): timed["lcp_segside on the tensor cores", False],
             (1, True): timed["lcp_segside on the CUDA cores", True]}
    bound, core_bound = _lcp_bound_ms(h, nv, ns, "default")
    log(f"[lcp-hb] timed coarse_ns1024 H={h} Nv={nv} Ns={ns} default: lcp_segside on (CUDA "
        f"cores, tensor cores): unweighted ({units[1, False]:.4f}, {units[2, False]:.4f}) ms; "
        f"weighted on the CUDA cores {units[1, True]:.4f} ms")
    log(f"[lcp-hb] timed coarse_ns1024 H={h} Nv={nv} Ns={ns} default: unweighted "
        f"lcp_segside={timed['lcp_segside', False]:.4f} ms "
        f"lcp_segside_hb={timed['lcp_segside_hb', False]:.4f} ms; weighted "
        f"lcp_segside={timed['lcp_segside', True]:.4f} ms "
        f"lcp_segside_hb={timed['lcp_segside_hb', True]:.4f} ms; bound={bound:.5f} ms "
        f"(CUDA cores alone {core_bound:.5f} ms)")
    stats["coarse_ns1024"] = dict(
        shape=[h, nv, ns], lcp_segside_ms=timed["lcp_segside", False],
        lcp_segside_hb_ms=timed["lcp_segside_hb", False],
        lcp_segside_weighted_ms=timed["lcp_segside", True],
        lcp_segside_hb_weighted_ms=timed["lcp_segside_hb", True], bound_ms=bound,
        cuda_core_bound_ms=core_bound,
        cuda_cores_ms=units[1, False], tensor_cores_ms=units[2, False],
        weighted_cuda_cores_ms=units[1, True])
    return stats


def time_hb_coarse(args, h, nv, ns) -> dict:
    """lcp_segside_hb at the scoring path's coarse call (unweighted,
    "default"): the launcher's unit, which must be the tensor-core filter,
    beside its CUDA-core unit and kernel 1's tensor-core filter on the same
    call; the share of rows that walked the band; weighted and float32 calls
    on the CUDA cores; registers."""
    from physimglobalpose_tpu_torch.ops import lcp

    if lcp._lcp_segside_hb_unit_for(False, "default") != lcp._HB_UNIT_TENSOR_CORES:
        fail("[lcp-hb] the coarse call does not take the tensor-core filter")
    for weighted, tier in ((True, "default"), (False, None), (True, None)):
        if lcp._lcp_segside_hb_unit_for(weighted, tier) != lcp._HB_UNIT_CUDA_CORES:
            fail(f"[lcp-hb] a {tier} call (weighted={weighted}) leaves the CUDA cores")
    packed = packed_lcp_args(args)
    time = lambda fn: cuda_time_ms(fn, reps=5, inner=20)
    run = lambda: lcp.lcp_segside_hb(*packed, False, "default")
    cores = lambda: lcp._lcp_segside_hb_on_unit(lcp._HB_UNIT_CUDA_CORES, *packed, False, "default")
    ms = time(run)
    cores_ms = time(cores)
    k1_tensor_ms = time(
        lambda: lcp._lcp_segside_on_unit(lcp._UNIT_TENSOR_CORES, *packed, False, "default"))
    k1_ms = time(lambda: lcp.lcp_segside(*packed, False, "default"))
    w_ms = time(lambda: lcp.lcp_segside_hb(*packed, True, "default"))
    fp32_ms = time(lambda: lcp.lcp_segside_hb(*packed, False, None))
    fp32_w_ms = time(lambda: lcp.lcp_segside_hb(*packed, True, None))
    dev_ms = device_ms(run, "lcp_segside_hb_mma_kernel")
    cores_dev_ms = device_ms(cores, "lcp_segside_hb_kernel")
    band = torch.zeros(1, dtype=torch.int32, device=args[0].device)
    lcp._lcp_segside_hb_on_unit(lcp._HB_UNIT_TENSOR_CORES, *packed, False, "default",
                                band_rows=band)
    band_share = int(band.item()) / (h * nv)
    plain_ms = cuda_time_ms(lambda: lcp.lcp_scores_plain(
        *args, weighted=False, matmul_precision="default"), reps=2, warmup=1)
    library_ms = _cdist_scores_ms(args)
    bound, core_bound = _lcp_bound_ms(h, nv, ns, "default")
    regs = registers_of("lcp_segside_hb")
    log(f"[lcp-hb] timed coarse H={h} Nv={nv} Ns={ns} unweighted default: lcp_segside_hb "
        f"(tensor-core filter, the launcher's unit) {ms:.4f} ms, device {dev_ms} ms; rows that "
        f"walked the band {int(band.item())} of {h * nv} ({band_share:.2e}); on the CUDA cores "
        f"{cores_ms:.4f} ms (device {cores_dev_ms} ms); kernel 1 on this call: tensor-core "
        f"filter {k1_tensor_ms:.4f} ms, its launcher's unit {k1_ms:.4f} ms; weighted (CUDA "
        f"cores) {w_ms:.4f} ms; fp32 {fp32_ms:.4f} ms, weighted {fp32_w_ms:.4f} ms; "
        f"plain={plain_ms:.3f} ms cdist_library={library_ms:.3f} ms; bound={bound:.5f} ms "
        f"share {bound / ms:.4f} (CUDA cores alone {core_bound:.5f} ms share "
        f"{core_bound / ms:.3f})")
    log(f"[lcp-hb] registers (ptxas): {json.dumps(regs)}")
    return dict(ms=ms, device_ms=dev_ms, band_rows=int(band.item()), band_share=band_share,
                cuda_cores_ms=cores_ms, cuda_cores_device_ms=cores_dev_ms,
                lcp_segside_tensor_cores_ms=k1_tensor_ms, lcp_segside_ms=k1_ms,
                weighted_ms=w_ms, fp32_ms=fp32_ms,
                fp32_weighted_ms=fp32_w_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound, cuda_core_bound_ms=core_bound, shape=[h, nv, ns], registers=regs)


# Once a process has profiled a large session (the ~37,000 launches of [leaf]),
# torch.profiler loses device spans of later sessions: a few in each, now and
# then most of one. With this pause between the profiler's start and the first
# launch, the scoring call's early coarse span was kept in every session of
# tools/profile_drop_probe.py; the cause inside the profiler is not known
# (PERF.md section 7).
PROFILE_PAUSE_S = 0.02


@contextlib.contextmanager
def profiled(*activities):
    """torch.profiler over the body, which starts PROFILE_PAUSE_S after the
    profiler; yields the profile, read after the block."""
    from torch.profiler import profile

    with profile(activities=list(activities)) as prof:
        time.sleep(PROFILE_PAUSE_S)
        yield prof


def device_spans(fn, kernel: str, reps: int) -> list[tuple[str, float]]:
    """(name, ms) of the device spans of the kernels whose name holds
    `kernel` over reps calls of fn() (after one call outside the profile), no
    host time between launches."""
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with profiled(ProfilerActivity.CUDA) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.name, (e.time_range.end - e.time_range.start) / 1e3) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]


def device_ms(fn, kernel: str, launches: int = 1, reps: int = 20) -> float | None:
    """Device time of one fn() call from torch.profiler: the spans of the
    kernels whose name holds `kernel`, summed over reps calls and divided by
    reps. None unless the profiler kept exactly reps * launches such spans: it
    may drop events, and a sum over some of them reads low. Where it is None
    the CUDA-event time stands alone."""
    spans = device_spans(fn, kernel, reps)
    if len(spans) != reps * launches:
        log(f"[profile] {kernel}: {len(spans)} device spans kept of {reps * launches}; "
            "no device time")
        return None
    return sum(ms for _, ms in spans) / reps


def kernel_means_ms(fn, kernel: str, reps: int = 20) -> dict[str, float] | None:
    """Device time of each kernel whose name holds `kernel`, for a fn() that
    launches each such kernel once a call: per exact kernel name, the mean of
    the spans torch.profiler kept over reps calls. The profiler drops a span
    now and then (one of 20 is common), which leaves device_ms nothing; the
    mean of one kernel's kept spans does not read low. None where a name has
    more than reps spans (`kernel` matched a kernel launched more than once a
    call) or no span was kept."""
    spans: dict[str, list[float]] = {}
    for name, ms in device_spans(fn, kernel, reps):
        spans.setdefault(name, []).append(ms)
    kept = sorted(len(v) for v in spans.values())
    if not spans or kept[-1] > reps:
        log(f"[profile] {kernel}: spans kept per kernel {kept} of {reps} calls; no device time")
        return None
    if kept[0] < reps:
        log(f"[profile] {kernel}: spans kept per kernel {kept} of {reps} calls")
    return {name: sum(v) / len(v) for name, v in spans.items()}


# Model points tied on purpose, (copy, original): the copy takes the
# original's coordinates and keeps its own normal. At Nm = 512 the kernel's
# four model slices start at 0, 128, 256 and 384, so every pair straddles
# slices, among them the first and the last point of a slice.
ICP_TIED_MODEL = ((128, 0), (255, 127), (511, 128), (384, 383), (300, 10))
# Ragged and constructed ICP cases: (label, seed, H, Nm, Ns, masked, garbage, twist).
RAGGED_ICP = (
    ("ties_across_slices", 41, 64, 512, 512, 10, 4, "ties"),
    ("nm1", 42, 16, 1, 300, 5, 2, None),
    ("nm33", 43, 16, 33, 300, 5, 2, None),
    ("nm511", 44, 16, 511, 700, 5, 2, None),
    ("nm513", 45, 16, 513, 700, 5, 2, None),
    ("ns1", 46, 16, 512, 1, 0, 2, None),
    ("all_masked", 47, 16, 512, 300, 0, 2, "all_masked"),
    # The largest model the kernel takes: above 4,096 points it rebuilds the
    # Jacobian rows from the model in device memory.
    ("nm8192", 48, 16, 8192, 120, 4, 2, None),
)


def _check_icp_pass(what, got, want) -> float:
    """Fail unless (A, b) is finite, of the right shape and within
    TOL_ICP_PASS of the plain version's, relative to the largest entry (both
    exactly 0 where the plain version has no correspondence at all)."""
    (a, b), (pa, pb) = got, want
    torch.cuda.synchronize()
    if a.shape != pa.shape or b.shape != pb.shape or not bool(torch.isfinite(a).all()) \
            or not bool(torch.isfinite(b).all()):
        fail(f"[icp] {what}: non-finite or misshapen output")
    if float(pa.abs().max()) == 0.0:
        if float(a.abs().max()) != 0.0 or float(b.abs().max()) != 0.0:
            fail(f"[icp] {what}: A, b != 0 where no segment point is in range")
        return 0.0
    err = max(float((a - pa).abs().max() / pa.abs().max()),
              float((b - pb).abs().max() / pb.abs().max()))
    if err > TOL_ICP_PASS:
        fail(f"[icp] {what}: relative error {err:.3e} above {TOL_ICP_PASS:.0e}")
    return err


def _icp_bound_ms(h: int, nm: int, ns: int) -> tuple[float, float]:
    """(bound, CUDA cores alone) of one "default" pass: the pair work of the
    d2 search plus 60 FLOP a (hypothesis, point) for the transform and the
    normal equations, against the bytes."""
    per_point_s = 60.0 * h * (nm + ns) / PEAK_FP32_FLOPS
    bytes_s = 4.0 * (12 * h + 4 * ns + 6 * nm + 42 * h) / PEAK_HBM_BYTES
    ops_s, core_s = _pair_ops_s(float(h) * nm * ns, "default")
    return max(ops_s + per_point_s, bytes_s) * 1e3, max(core_s + per_point_s, bytes_s) * 1e3


def check_ragged_icp(device) -> None:
    """icp_corr_segside against icp_segside_pass_plain on RAGGED_ICP, both tiers."""
    from physimglobalpose_tpu_torch.ops import icp

    for label, seed, h, nm, ns, masked, garbage, twist in RAGGED_ICP:
        tfs, mpts, mnrm, spts, smask = icp_inputs(seed, h, nm, ns, masked, garbage, device)
        if twist == "all_masked":
            smask[:] = False
        if twist == "ties":
            for copy, orig in ICP_TIED_MODEL:
                mpts[copy] = mpts[orig]
        tr12, seg4, _ = icp_pass_args(tfs, mpts, mnrm, spts, smask)
        for tier in (None, "default"):
            want = icp.icp_segside_pass_plain(tr12, seg4, mpts, mnrm, 0.02, tier)
            err = _check_icp_pass(f"{label} tier={tier}",
                                  icp.icp_corr_segside(tr12, seg4, mpts, mnrm, 0.02, tier), want)
            note = ""
            if twist == "ties":
                # The copies' normals, made the originals': A moves unless no
                # correspondence found a tie.
                same = mnrm.clone()
                for copy, orig in ICP_TIED_MODEL:
                    same[copy] = mnrm[orig]
                effect = float((icp.icp_segside_pass_plain(tr12, seg4, mpts, same, 0.02, tier)[0]
                                - want[0]).abs().max() / want[0].abs().max())
                note = f" tie_effect={effect:.3e}"
                if effect == 0.0:
                    fail(f"[icp] {label}: no correspondence found a tie")
            log(f"[icp] {label} H={h} Nm={nm} Ns={ns} tier={tier}: rel_err={err:.3e} "
                f"(tol {TOL_ICP_PASS:.0e}){note}")


def phase_icp(device) -> dict:
    """icp_corr_segside against icp_segside_pass_plain: (A, b) of one pass at
    the scoring path's two ICP shapes (segments of 512 and 2,048 points) with
    masked points and garbage hypotheses, both tiers, and on RAGGED_ICP; four
    iterations of refine_icp_segside over the kernel against the same loop
    over the plain pass; then the pass timed alone at both shapes."""
    from physimglobalpose_tpu_torch.ops import icp, lcp

    check_ragged_icp(device)
    h, nm, n_garbage = 256, 512, 8
    shapes = {}
    for ns in (512, 2048):
        tfs, mpts, mnrm, spts, smask = icp_inputs(40, h, nm, ns, 20, n_garbage, device)
        tr12, seg4, tr_c = icp_pass_args(tfs, mpts, mnrm, spts, smask)
        stats = {}
        for tier in (None, "default"):
            a, b = icp.icp_segside_pass(tr12, seg4, mpts, mnrm, 0.02, tier)
            pa, pb = icp.icp_segside_pass_plain(tr12, seg4, mpts, mnrm, 0.02, tier)
            err = _check_icp_pass(f"pass Ns={ns} tier={tier}", (a, b), (pa, pb))
            log(f"[icp] pass H={h} Nm={nm} Ns={ns} tier={tier}: rel_err={err:.3e} "
                f"(tol {TOL_ICP_PASS:.0e} of the largest entry) "
                f"max|A|={float(pa.abs().max()):.3f} max|b|={float(pb.abs().max()):.3e}")
            if float(a[h - n_garbage:].abs().max()) != 0.0 or float(b[h - n_garbage:].abs().max()) != 0.0:
                fail(f"icp_corr_segside[{tier}]: a hypothesis without correspondences has A, b != 0")
            if float(a[: h - n_garbage].abs().amax(dim=(1, 2)).min()) <= 0.0:
                fail(f"icp_corr_segside[{tier}]: a near-truth hypothesis found no correspondence")

            if ns == 512:
                got = icp.refine_icp_segside(tfs, mpts, mnrm, spts, smask, iters=4,
                                             matmul_precision=tier)
                want = tr_c.to(torch.float32)  # the same loop over the plain pass
                for _ in range(4):
                    pa, pb = icp.icp_segside_pass_plain(
                        want[:, :3, :].reshape(-1, 12).contiguous(), seg4, mpts, mnrm, 0.02, tier)
                    want = icp.segside_update(want, pa, pb)
                want = want.clone()
                want[:, :3, 3] += lcp.segment_centroid(spts, smask)
                torch.cuda.synchronize()
                place = lambda tf: torch.einsum("hij,nj->hni", tf[:, :3, :3], mpts) + tf[:, None, :3, 3]
                disp = (place(got) - place(want)).norm(dim=-1).mean(dim=-1)
                moved = (place(got) - place(tfs)).norm(dim=-1).mean(dim=-1)
                log(f"[icp] 4 iterations tier={tier}: mean point displacement kernel vs plain "
                    f"loop max={float(disp.max()):.3e} m (bound {TOL_ICP_REFINE:.0e} m); poses "
                    f"moved by {float(moved[: h - n_garbage].mean()) * 1e3:.3f} mm on average")
                if not bool(torch.isfinite(got).all()) or float(disp.max()) > TOL_ICP_REFINE:
                    fail(f"refine_icp_segside[{tier}] over the kernel parts from the plain loop")
                if float((got[h - n_garbage:] - tfs[h - n_garbage:]).abs().max()) > 1e-6:
                    fail(f"refine_icp_segside[{tier}] moved a hypothesis without correspondences")
            run = lambda: icp.icp_corr_segside(tr12, seg4, mpts, mnrm, 0.02, tier)
            stats[tier] = dict(
                ms=cuda_time_ms(run, reps=5, inner=20),
                device_ms=device_ms(run, "icp_corr_segside_kernel"),
                plain_ms=cuda_time_ms(lambda: icp.icp_segside_pass_plain(
                    tr12, seg4, mpts, mnrm, 0.02, tier), reps=3, warmup=1),
                max_abs_err=err)

        def cdist_nearest():
            # Yardstick only: the nearest model point per segment point by one
            # library call (no PyTorch call computes the normal equations).
            u = torch.einsum("hij,nj->hni", tr_c[:, :3, :3], mpts) + tr_c[:, None, :3, 3]
            torch.cdist(seg4[:, :3].expand(h, -1, -1), u).min(-1)

        cdist_ms = cuda_time_ms(cdist_nearest, reps=5)
        bound, core_bound = _icp_bound_ms(h, nm, ns)
        st = stats["default"]
        log(f"[icp] timed pass H={h} Nm={nm} Ns={ns}: default={st['ms']:.4f} ms (device "
            f"{st['device_ms']} ms) fp32={stats[None]['ms']:.4f} ms (device "
            f"{stats[None]['device_ms']} ms) plain[default]={st['plain_ms']:.3f} ms "
            f"cdist_nearest_yardstick={cdist_ms:.3f} ms; bound={bound:.5f} ms "
            f"share {bound / st['ms']:.4f} (CUDA cores alone {core_bound:.5f} ms "
            f"share {core_bound / st['ms']:.3f})")
        shapes[ns] = dict(st, fp32_ms=stats[None]["ms"], fp32_device_ms=stats[None]["device_ms"],
                          bound_ms=bound, cuda_core_bound_ms=core_bound, cdist_yardstick_ms=cdist_ms,
                          shape=[h, nm, ns],
                          max_abs_err=max(stats[None]["max_abs_err"], st["max_abs_err"]))
    out = dict(shapes[512])
    out["ns2048"] = shapes[2048]
    return out


def _check_scores(tag, what, got, want, h, tol):
    """Fail unless got is finite, [h] and within tol of want; returns the error."""
    torch.cuda.synchronize()
    if got.shape != (h,) or not bool(torch.isfinite(got).all()):
        fail(f"{tag} {what}: non-finite or misshapen output")
    err = float((got - want).abs().max())
    if err > tol:
        fail(f"{tag} {what}: max_abs_err {err:.3e} above {tol:.3e}")
    return err


def phase_lcp_stream(device) -> dict:
    """lcp_stream against lcp_scores_stream_plain, weighted and unweighted,
    fp32 and "default": at the exact-tier shape of the large-segment scoring
    path and at ragged shapes (Ns no multiple of the tile, a masked tail, an
    all-masked segment, duplicated segment points that tie across a tile
    edge); against lcp_segside on one 2,048-point segment; then timed at the
    exact-tier shape and at the large-segment scene's shape."""
    from physimglobalpose_tpu_torch.ops import lcp

    cases = (
        # (label, seed, H, Nv, Ns, masked, ns_tile)
        ("exact", 50, 32, 4096, 4096, 50, 1024),
        ("ragged", 51, 37, 1000, 2500, 40, 1024),
        ("ragged_tile64", 52, 13, 700, 333, 20, 64),
        ("cross_tile_ties", 53, 16, 2048, 3000, 30, 1024),
        ("all_masked", 54, 9, 512, 2500, 0, 1024),
    )
    worst = 0.0
    for label, seed, h, nv, ns, masked, tile in cases:
        args = lcp_inputs(seed, h, nv, ns, masked, device)
        if label == "cross_tile_ties":
            # The first 50 segment points again 1,100 places on, in the next
            # tile, with their own probabilities: exact ties across the edge.
            args[3][1100:1150], args[4][1100:1150] = args[3][:50].clone(), args[4][:50].clone()
        if label == "all_masked":
            args[6][:] = False
        if label == "ragged":
            args[6][-300:] = False  # a masked tail, as a padded segment has
        for tier in (None, "default"):
            for weighted in (True, False):
                kw = dict(weighted=weighted, matmul_precision=tier, ns_tile=tile)
                got = lcp.lcp_scores_stream(*args, **kw)
                want = lcp.lcp_scores_stream_plain(*args, **kw)
                err = _check_scores("[lcp-stream]", f"{label} {tier} weighted={weighted}", got,
                                    want, h, TOL_LCP / nv)
                note = ""
                if label == "cross_tile_ties" and weighted:
                    one_tile = lcp.lcp_scores_stream_plain(*args, **dict(kw, ns_tile=4096))
                    effect = float((one_tile - want).abs().max())
                    note = f" tile_rule_effect={effect:.3e}"
                    if effect == 0.0:
                        fail("[lcp-stream] the tie case has no tie across a tile edge")
                if label == "all_masked" and float(got.abs().max()) != 0.0:
                    fail("[lcp-stream] an all-masked segment scored above 0")
                log(f"[lcp-stream] {label} H={h} Nv={nv} Ns={ns} ns_tile={tile} tier={tier} "
                    f"weighted={weighted}: max_abs_err={err:.3e} (tol {TOL_LCP / nv:.3e}) "
                    f"mean_score={float(want.mean()):.4f}{note}")
                if label == "exact":
                    worst = max(worst, err)

    # The ragged shapes and the ties inside a tile: in one chunk of 32 staged
    # points, in two chunks, and 1,024 rows on in a tile of 2,048, where two
    # chunks share a bit of the kernel's mask (across a tile edge: above).
    ragged = tuple((*row, dict(ns_tile=1024)) for row in RAGGED_LCP[:-1]) + (
        ("tie_shared_bit", 110, 16, 512, 2100, 6, (1024,), dict(ns_tile=2048)),
        ("h33_nv77_tile64", 111, 33, 77, 200, 5, None, dict(ns_tile=64)),
    )
    check_ragged("[lcp-stream]", ragged, (None, "default"),
                 {"lcp_scores_stream": lambda args, **kw: lcp.lcp_scores_stream(*args, **kw)},
                 lcp.lcp_scores_stream_plain, lambda tier: True, device)

    # Two formulations of one score on a segment both kernels take.
    args = lcp_inputs(55, 64, 4096, 2048, 30, device)
    k1 = lcp.lcp_scores(*args)
    err = _check_scores("[lcp-stream]", "vs lcp_segside", lcp.lcp_scores_stream(*args), k1, 64,
                        TOL_LCP / 4096)
    log(f"[lcp-stream] H=64 Nv=4096 Ns=2048 fp32 weighted: lcp_stream vs lcp_segside "
        f"{err:.3e} (tol {TOL_LCP / 4096:.3e})")

    # Timing. The exact-tier call of the scoring path: weighted, fp32.
    h, nv, ns = 32, 4096, 4096
    args = lcp_inputs(50, h, nv, ns, 50, device)
    packed = stream_lcp_args(args)
    run = lambda w, t: cuda_time_ms(lambda: lcp.lcp_stream(*packed, w, t), reps=5, inner=10)
    ms, ms_default, ms_unw = run(True, None), run(True, "default"), run(False, None)
    plain_ms = cuda_time_ms(lambda: lcp.lcp_scores_stream_plain(*args), reps=2, warmup=1)
    cdist_ms = _cdist_scores_ms(args, chunk=32)
    bound, _ = _lcp_bound_ms(h, nv, ns, None)
    bound_default, core_default = _lcp_bound_ms(h, nv, ns, "default")
    log(f"[lcp-stream] timed exact H={h} Nv={nv} Ns={ns} weighted: fp32={ms:.4f} ms "
        f"default={ms_default:.4f} ms; unweighted fp32={ms_unw:.4f} ms; plain={plain_ms:.3f} ms; "
        f"bound={bound:.5f} ms share {bound / ms:.4f}; bound[default]={bound_default:.5f} ms "
        f"(CUDA cores alone {core_default:.5f} ms); cdist_yardstick={cdist_ms:.3f} ms")
    stats = dict(max_abs_err=worst, ms=ms, default_ms=ms_default, unweighted_ms=ms_unw,
                 plain_ms=plain_ms, bound_ms=bound, cdist_yardstick_ms=cdist_ms, shape=[h, nv, ns])

    # The per-object call of the large-segment scene: H = 10,000.
    h = 10_000
    args = lcp_inputs(56, h, nv, ns, 50, device)
    packed = stream_lcp_args(args)
    run = lambda w, t: cuda_time_ms(lambda: lcp.lcp_stream(*packed, w, t), reps=3, warmup=1)
    s_ms, s_default, s_unw = run(True, None), run(True, "default"), run(False, None)
    s_cdist = _cdist_scores_ms(args, chunk=32)
    s_bound, _ = _lcp_bound_ms(h, nv, ns, None)
    log(f"[lcp-stream] timed scene H={h} Nv={nv} Ns={ns} weighted: fp32={s_ms:.3f} ms "
        f"default={s_default:.3f} ms; unweighted fp32={s_unw:.3f} ms; bound={s_bound:.3f} ms "
        f"share {s_bound / s_ms:.3f}; cdist_yardstick={s_cdist:.1f} ms "
        f"(plain not timed at this H: hours of float64 blocks)")
    stats.update(scene_ms=s_ms, scene_default_ms=s_default, scene_unweighted_ms=s_unw,
                 scene_bound_ms=s_bound, scene_cdist_yardstick_ms=s_cdist,
                 scene_shape=[h, nv, ns])
    return stats


def phase_lcp_wide(device) -> tuple[dict, int]:
    """lcp_stream_wide against lcp_scores_stream_plain and against lcp_stream,
    both tiers: at ragged shapes and at the coarse shape of the yardstick
    pipeline on 4,096-point segments (H 16,384, Nv 512), where it is then
    driven once as its path and timed beside lcp_stream."""
    from physimglobalpose_tpu_torch.ops import lcp

    tile = lcp.STREAM_WIDE_NS_TILE
    cases = (
        # (label, seed, H, Nv, Ns, masked, hypotheses the plain version scores)
        ("coarse_large", 60, 16384, 512, 4096, 50, 64),
        ("ragged", 61, 37, 700, 333, 20, 37),
        ("ragged_tiny", 62, 5, 77, 2100, 9, 5),
    )
    worst = 0.0
    for label, seed, h, nv, ns, masked, h_plain in cases:
        args = lcp_inputs(seed, h, nv, ns, masked, device)
        for tier in (None, "default"):
            for weighted in (True, False):
                kw = dict(weighted=weighted, matmul_precision=tier)
                got = lcp.lcp_scores_stream_wide(*args, **kw)
                k4 = lcp.lcp_scores_stream(*args, ns_tile=tile, **kw)
                want = lcp.lcp_scores_stream_plain(args[0][:h_plain], *args[1:], ns_tile=tile, **kw)
                what = f"{label} {tier} weighted={weighted}"
                err = _check_scores("[lcp-wide]", what + " vs plain", got[:h_plain], want,
                                    h_plain, TOL_LCP / nv)
                err_k4 = _check_scores("[lcp-wide]", what + " vs lcp_stream", got, k4, h, 1e-6)
                log(f"[lcp-wide] {label} H={h} Nv={nv} Ns={ns} tier={tier} weighted={weighted}: "
                    f"vs_plain={err:.3e} (first {h_plain} hypotheses, tol {TOL_LCP / nv:.3e}) "
                    f"vs_lcp_stream={err_k4:.3e} (tol 1e-6) mean_score={float(want.mean()):.4f}")
                if label == "coarse_large":
                    worst = max(worst, err)

    # Exact ties that straddle the 32-point chunks inside a 128-point tile and
    # the tile edge: the first 16 segment points again at rows 20-35, 120-135,
    # and at 40, 100 and 250.
    check_ragged("[lcp-wide]", (
        ("tie_chunks", 63, 16, 512, 300, 6, (20,), dict(ns_tile=tile)),
        ("tie_tile_edge", 64, 16, 512, 300, 6, (120,), dict(ns_tile=tile)),
        ("tie_chunks_tiles", 65, 16, 300, 700, 6, (40, 100, 250), dict(ns_tile=tile)),
    ), (None, "default"), {
        "lcp_scores_stream_wide": lambda a, **kw: lcp.lcp_scores_stream_wide(*a, **kw),
        "lcp_scores_stream": lambda a, **kw: lcp.lcp_scores_stream(*a, **kw),
    }, lcp.lcp_scores_stream_plain, lambda tier: True, device)

    # Its path: one direct call at the yardstick's coarse shape (weighted, fp32).
    label, seed, h, nv, ns, masked, _ = cases[0]
    args = lcp_inputs(seed, h, nv, ns, masked, device)
    lcp.lcp_stream_wide.launches, lcp.lcp_stream_wide.tier_launches = 0, [0, 0, 0]
    scores = lcp.lcp_scores_stream_wide(*args)
    torch.cuda.synchronize()
    launches = lcp.lcp_stream_wide.launches
    if scores.shape != (h,) or not bool(torch.isfinite(scores).all()) or float(scores.max()) <= 0.1:
        fail("[lcp-wide] the path call gave no usable scores")

    packed = stream_lcp_args(args)
    wide = lambda w, t: cuda_time_ms(lambda: lcp.lcp_stream_wide(*packed, w, t), reps=3, warmup=1)
    ms, ms_default, ms_unw = wide(True, None), wide(True, "default"), wide(False, None)
    k4_ms = cuda_time_ms(lambda: lcp.lcp_stream(*packed, True, None, tile), reps=3, warmup=1)
    k4_unw = cuda_time_ms(lambda: lcp.lcp_stream(*packed, False, None, tile), reps=3, warmup=1)
    plain_ms = cuda_time_ms(lambda: lcp.lcp_scores_stream_plain(*args, ns_tile=tile),
                            reps=1, warmup=0)
    cdist_ms = _cdist_scores_ms(args)
    dev_ms = device_ms(lambda: lcp.lcp_stream_wide(*packed, True, None), "lcp_stream_wide_kernel",
                       reps=3)
    bound, _ = _lcp_bound_ms(h, nv, ns, None)
    regs = registers_of("lcp_stream_wide")
    log(f"[lcp-wide] path call launches={launches}; timed H={h} Nv={nv} Ns={ns} weighted fp32: "
        f"lcp_stream_wide={ms:.3f} ms, device {dev_ms} ms (default {ms_default:.3f} ms, "
        f"unweighted {ms_unw:.3f} ms) lcp_stream={k4_ms:.3f} ms (unweighted {k4_unw:.3f} ms) "
        f"plain={plain_ms:.1f} ms cdist_yardstick={cdist_ms:.3f} ms; bound={bound:.4f} ms "
        f"share {bound / ms:.3f}; registers (ptxas) {json.dumps(regs)}")
    stats = dict(max_abs_err=worst, ms=ms, device_ms=dev_ms, default_ms=ms_default,
                 unweighted_ms=ms_unw, lcp_stream_ms=k4_ms, lcp_stream_unweighted_ms=k4_unw,
                 plain_ms=plain_ms, bound_ms=bound, cdist_yardstick_ms=cdist_ms, shape=[h, nv, ns],
                 registers=regs)
    return stats, launches


def icp_stream_device_ms(run) -> tuple[float | None, float | None]:
    """(scan kernel, whole pass) device ms of an icp_corr_stream call: each of
    its two kernels' mean span (kernel_means_ms), the pass their sum."""
    means = kernel_means_ms(run, "icp_corr_stream") or {}
    scan = [v for k, v in means.items() if "icp_corr_stream_kernel" in k]
    if len(scan) != 1 or len(means) != 2:
        return None, None
    return scan[0], sum(means.values())


def phase_icp_stream(device) -> tuple[dict, int]:
    """icp_corr_stream against icp_stream_pass_plain: (A, b) of one pass at the
    shape the scoring pipeline's large-cloud ICP branch sees (H 256, Nm 1,024,
    Ns 4,096) with masked points and garbage hypotheses, at two tiles, and on
    kernel_inputs.icp_tie_inputs (every d2 exact, most nearest points tied,
    many of them across tiles) at tiles 37, 100 and 256, and at tile 512 on
    larger lattices, and with a model too large to stay staged; then
    refine_icp_stream for four iterations, its path, against the same loop
    over the plain pass; a batch with kernel_inputs.with_singular_hypothesis
    (non-finite at the same hypotheses as the plain loop, as in the JAX
    package); then the pass timed alone (events, and the device time of its
    two kernels from kernel_means_ms), beside one iteration of plain
    refine_icp on the same inputs."""
    from physimglobalpose_tpu_torch.ops import icp

    h, nm, ns, n_garbage = 256, 1024, 4096, 8
    tfs, mpts, mnrm, spts, smask = icp_inputs(70, h, nm, ns, 100, n_garbage, device)
    seg4 = icp.pack_icp_stream_segment(spts, smask)
    tr12 = tfs[:, :3, :].reshape(-1, 12).contiguous()
    worst = 0.0
    for tile in (icp.STREAM_NM_TILE, 100):
        a, b = icp.icp_stream_pass(tr12, seg4, mpts, mnrm, 0.02, tile)
        pa, pb = icp.icp_stream_pass_plain(tr12, seg4, mpts, mnrm, 0.02, tile)
        torch.cuda.synchronize()
        if a.shape != (h, 6, 6) or b.shape != (h, 6) or not bool(torch.isfinite(a).all()):
            fail(f"icp_corr_stream[nm_tile={tile}]: non-finite or misshapen output")
        err_a = float((a - pa).abs().max() / pa.abs().max())
        err_b = float((b - pb).abs().max() / pb.abs().max())
        log(f"[icp-stream] pass H={h} Nm={nm} Ns={ns} nm_tile={tile}: rel_err_A={err_a:.3e} "
            f"rel_err_b={err_b:.3e} (tol {TOL_ICP_PASS:.0e} of the largest entry) "
            f"max|A|={float(pa.abs().max()):.3f} max|b|={float(pb.abs().max()):.3e}")
        if err_a > TOL_ICP_PASS or err_b > TOL_ICP_PASS:
            fail(f"icp_corr_stream[nm_tile={tile}] disagrees with its plain version")
        if float(a[h - n_garbage:].abs().max()) != 0.0 or float(b[h - n_garbage:].abs().max()) != 0.0:
            fail("icp_corr_stream: a hypothesis without correspondences has A, b != 0")
        if float(a[: h - n_garbage].abs().amax(dim=(1, 2)).min()) <= 0.0:
            fail("icp_corr_stream: a near-truth hypothesis found no correspondence")
        worst = max(worst, err_a, err_b)

    # Exact ties: on the 216-point lattice at tiles that are no multiple of a
    # chunk; on 1,000 and 4,096 points at tile 512, more chunks a tile than
    # the match word has bits (chunks c and c + 8 share one), the model staged
    # and streamed (above 1,792 slots the walk rebuilds the points it visits).
    for side, tiles in ((6, (37, 100, 256)), (10, (512,)), (16, (512, 100))):
        tie_tfs, tie_m, tie_n, tie_s, tie_mask = kernel_inputs.icp_tie_inputs(device, side=side)
        tie_args = (tie_tfs[:, :3, :].reshape(-1, 12).contiguous(),
                    icp.pack_icp_stream_segment(tie_s, tie_mask), tie_m, tie_n, 0.02)
        for tile in tiles:
            err = _check_icp_pass(f"icp_corr_stream ties Nm={tie_m.shape[0]} nm_tile={tile}",
                                  icp.icp_corr_stream(*tie_args, tile),
                                  icp.icp_stream_pass_plain(*tie_args, tile))
            log(f"[icp-stream] exact ties H={tie_tfs.shape[0]} Nm={tie_m.shape[0]} "
                f"Ns={tie_s.shape[0]} nm_tile={tile}: rel_err={err:.3e} (tol {TOL_ICP_PASS:.0e})")
            worst = max(worst, err)

    # A random model above the slots the kernel keeps staged (1,792): the scan
    # streams it through shared memory and the walk rebuilds the points it visits.
    b_tfs, b_m, b_n, b_s, b_mask = icp_inputs(71, 16, 4096, 700, 10, 2, device)
    big_args = (b_tfs[:, :3, :].reshape(-1, 12).contiguous(),
                icp.pack_icp_stream_segment(b_s, b_mask), b_m, b_n, 0.02)
    for tile in (256, 100):
        err = _check_icp_pass(f"icp_corr_stream large model nm_tile={tile}",
                              icp.icp_corr_stream(*big_args, tile),
                              icp.icp_stream_pass_plain(*big_args, tile))
        log(f"[icp-stream] large model H=16 Nm=4096 Ns=700 nm_tile={tile}: rel_err={err:.3e} "
            f"(tol {TOL_ICP_PASS:.0e})")
        worst = max(worst, err)

    def plain_loop(tf, m, nrm, s, mask, iters):
        want = tf.to(torch.float32)  # refine_icp_stream's loop over the plain pass
        seg = icp.pack_icp_stream_segment(s, mask)
        for _ in range(iters):
            pa, pb = icp.icp_stream_pass_plain(
                want[:, :3, :].reshape(-1, 12).contiguous(), seg, m, nrm, 0.02)
            want = icp.icp_update(want, pa, pb)
        return want

    icp.icp_corr_stream.launches = 0
    got = icp.refine_icp_stream(tfs, mpts, mnrm, spts, smask, iters=4)
    torch.cuda.synchronize()
    launches = icp.icp_corr_stream.launches
    want = plain_loop(tfs, mpts, mnrm, spts, smask, 4)
    torch.cuda.synchronize()
    place = lambda tf: torch.einsum("hij,nj->hni", tf[:, :3, :3], mpts) + tf[:, None, :3, 3]
    disp = (place(got) - place(want)).norm(dim=-1).mean(dim=-1)
    moved = (place(got) - place(tfs)).norm(dim=-1).mean(dim=-1)
    log(f"[icp-stream] 4 iterations (launches={launches}): mean point displacement kernel vs "
        f"plain loop max={float(disp.max()):.3e} m (bound {TOL_ICP_REFINE:.0e} m); poses moved "
        f"by {float(moved[: h - n_garbage].mean()) * 1e3:.3f} mm on average")
    if not bool(torch.isfinite(got).all()) or float(disp.max()) > TOL_ICP_REFINE:
        fail("refine_icp_stream over the kernel parts from the plain loop")
    if float((got[h - n_garbage:] - tfs[h - n_garbage:]).abs().max()) > 1e-6:
        fail("refine_icp_stream moved a hypothesis without correspondences")

    # Four near-truth hypotheses, two without correspondences and a singular one.
    keep = torch.tensor([0, 1, 2, 3, h - 2, h - 1], device=device)
    sing = kernel_inputs.with_singular_hypothesis(tfs[keep], mpts, mnrm, spts, smask)
    got_s = icp.refine_icp_stream(*sing, iters=2)
    want_s = plain_loop(*sing, 2)
    finite = lambda x: [bool(v) for v in torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)]
    log(f"[icp-stream] singular hypothesis, 2 iterations: finite kernel {finite(got_s)}, "
        f"plain loop {finite(want_s)}")
    if finite(got_s) != finite(want_s) or finite(got_s) != [True] * 6 + [False]:
        fail("refine_icp_stream: non-finite poses differ from the plain loop's")
    m_s = sing[1]
    place_s = lambda tf: torch.einsum("hij,nj->hni", tf[:6, :3, :3], m_s) + tf[:6, None, :3, 3]
    if float((place_s(got_s) - place_s(want_s)).norm(dim=-1).mean(dim=-1).max()) > TOL_ICP_REFINE:
        fail("refine_icp_stream beside a singular hypothesis parts from the plain loop")

    run = lambda: icp.icp_corr_stream(tr12, seg4, mpts, mnrm, 0.02)
    ms = cuda_time_ms(run, reps=5, inner=10)
    dev_ms, pass_dev_ms = icp_stream_device_ms(run)
    plain_ms = cuda_time_ms(lambda: icp.icp_stream_pass_plain(tr12, seg4, mpts, mnrm, 0.02),
                            reps=2, warmup=1)
    refine_icp_ms = cuda_time_ms(
        lambda: icp.refine_icp(tfs, mpts, mnrm, spts, smask, iters=1), reps=3, warmup=1)

    def cdist_nearest():
        # Yardstick only: the nearest model point per segment point.
        u = torch.einsum("hij,nj->hni", tfs[:, :3, :3], mpts) + tfs[:, None, :3, 3]
        for uc in u.split(64):
            torch.cdist(spts.expand(uc.shape[0], -1, -1), uc).min(-1)

    cdist_ms = cuda_time_ms(cdist_nearest, reps=3, warmup=1)
    # 8 FLOP a pair for the search, 60 a (hypothesis, point) for the transform
    # and the normal equations, at the fp32 peak; the bytes never bind.
    ops_s = (8.0 * h * nm * ns + 60.0 * h * (nm + ns)) / PEAK_FP32_FLOPS
    bytes_s = 4.0 * (12 * h + 4 * ns + 6 * nm + 42 * h) / PEAK_HBM_BYTES
    bound = max(ops_s, bytes_s) * 1e3
    regs = registers_of("icp_corr_stream")
    log(f"[icp-stream] timed pass H={h} Nm={nm} Ns={ns}: icp_corr_stream={ms:.4f} ms (device: "
        f"scan kernel {dev_ms} ms, with the finishing kernel {pass_dev_ms} ms) "
        f"plain={plain_ms:.3f} ms; one iteration of plain refine_icp="
        f"{refine_icp_ms:.3f} ms; cdist_nearest_yardstick={cdist_ms:.3f} ms; bound={bound:.5f} ms "
        f"share {bound / ms:.4f}; registers (ptxas) {json.dumps(regs)}")
    stats = dict(max_abs_err=worst, ms=ms, device_ms=dev_ms, pass_device_ms=pass_dev_ms,
                 plain_ms=plain_ms, bound_ms=bound,
                 refine_icp_iteration_ms=refine_icp_ms, cdist_yardstick_ms=cdist_ms,
                 shape=[h, nm, ns], registers=regs)
    return stats, launches


def phase_scoring(device, large: bool = False) -> tuple[dict, dict]:
    """score_refine_pipeline at the benchmark's full shape with the production
    flags: launch counts of one call, the fidelity gates against the exact
    pipeline (easy and clutter inputs), warm latency, device-idle share.
    large=False: 1,024-point segments ([scoring]); large=True: 4,096-point
    segments ([scoring-large]), where the strided coarse and bulk fine tiers
    see 1,024 points and stay on lcp_segside, the ICP tier (2,048 x 512) stays
    on icp_corr_segside, and the exact tier sees the whole segment and takes
    lcp_stream in float32 (it has no "high3"); the exact pipeline of the gates
    then runs its coarse and fine tiers through lcp_stream too."""
    from physimglobalpose_tpu_torch import bench_inputs
    from physimglobalpose_tpu_torch.ops import lcp, scoring

    tag = "[scoring-large]" if large else "[scoring]"
    flags = bench_inputs.prod_flags()
    launches, stats = {}, {}
    for clutter in (False, True):
        name = "clutter" if clutter else "easy"
        inputs = bench_inputs.to_tensors(bench_inputs.make_inputs(
            seed=0, clutter=clutter, ns=4 * bench_inputs.NS if large else bench_inputs.NS), device)
        run = lambda: scoring.score_refine_pipeline(*inputs, **flags)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        log(f"{tag} {name}: H={inputs[0].shape[0]} Nv={inputs[3].shape[0]} "
            f"Nm={inputs[1].shape[0]} Ns={inputs[5].shape[0]}; first call "
            f"{(time.perf_counter() - t0) * 1e3:.2f} ms")

        _reset_launches()
        prod = run()
        torch.cuda.synchronize()
        counts = _launches(tiers=True)
        log(f"{tag} {name}: launches of one call {counts}")
        if large:
            # Coarse (Nv 256, Ns 1,024: beyond the hypothesis-block rule) and
            # bulk fine on lcp_segside "default"; exact on lcp_stream.
            want = {"lcp_segside": 2, "lcp_segside/default": 2, "lcp_segside/high3": 0,
                    "lcp_segside_hb": 0, "icp_corr_segside": flags["icp_iters"],
                    "lcp_stream": 1, "lcp_stream/fp32": 1}
        else:
            want = {"lcp_segside": 2, "lcp_segside/default": 1, "lcp_segside/high3": 1,
                    "lcp_segside_hb": 1, "icp_corr_segside": flags["icp_iters"],
                    "lcp_stream": 0, "lcp_stream/fp32": 0}
        if counts != want:
            fail(f"{tag} ({name}): launches {counts}, expected {want}")
        if not large:
            check_coarse_span(run, name)
        k = flags["top_k"]
        if (prod.top_transforms.shape != (k, 4, 4) or prod.top_scores.shape != (k,)
                or prod.coarse_scores.shape != (inputs[0].shape[0],)
                or not bool(torch.isfinite(prod.top_transforms).all())
                or not bool(torch.isfinite(prod.top_scores).all())):
            fail(f"{tag} ({name}): non-finite or misshapen result")
        lcp.lcp_stream.launches = 0
        gate = bench_inputs.fidelity_gate(inputs, prod, clutter)  # raises on a failed gate
        log(f"{tag} {name}: fidelity gates passed {json.dumps(gate)}; "
            f"top score {float(prod.top_scores[0]):.4f}; the exact pipeline launched "
            f"lcp_stream {lcp.lcp_stream.launches} time(s)")
        if lcp.lcp_stream.launches != (2 if large else 0):  # its coarse and fine tiers
            fail(f"{tag} ({name}): the exact pipeline took another LCP route")

        walls = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall_ms = statistics.median(walls)
        event_ms = cuda_time_ms(run, reps=7, warmup=0)
        h = inputs[0].shape[0]
        stats[name] = dict(wall_ms=wall_ms, event_ms=event_ms, hyp_per_s=h / (wall_ms * 1e-3),
                           walls_ms=walls, gate=gate)
        log(f"{tag} {name}: warm call wall {wall_ms:.3f} ms (7 runs {min(walls):.3f}-"
            f"{max(walls):.3f}), CUDA events {event_ms:.3f} ms, "
            f"{h / (wall_ms * 1e-3):.0f} hyp/s")
        launches = counts
    prof = profile_scene(
        run, label="scoring, clutter inputs" + (", 4,096-point segments" if large else ""))
    if prof is not None:
        busy_ms = prof["busy_ms"]
        # The profiler slows the host; against the unprofiled warm call the
        # same device time gives the idle share a caller sees.
        wall_ms = stats["clutter"]["wall_ms"]
        log(f"{tag} clutter: device busy {busy_ms:.3f} ms of the {wall_ms:.3f} ms warm call: "
            f"idle share {1.0 - busy_ms / wall_ms:.3f} without the profiler")
    return stats, launches


def check_coarse_span(run, name: str, tries: int = 3) -> None:
    """The coarse call of one scoring call, read from the profiler's device
    spans: exactly one lcp_segside_hb kernel, the tensor-core filter
    (lcp_segside_hb_mma_kernel). A run whose profile kept no such span (the
    profiler may drop events) is tried again."""
    from torch.profiler import ProfilerActivity

    for _ in range(tries):
        torch.cuda.synchronize()
        with profiled(ProfilerActivity.CUDA) as prof:
            run()
            torch.cuda.synchronize()
        spans = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and "lcp_segside_hb" in e.name]
        filters = sum("lcp_segside_hb_mma_kernel" in n for n in spans)
        if len(spans) != filters or filters > 1:
            fail(f"[lcp-hb] [scoring] {name}: the coarse call launched {spans}")
        if filters == 1:
            log(f"[lcp-hb] [scoring] {name}: the coarse call's device span is the tensor-core "
                f"filter, once: {spans[0][:80]}")
            return
    fail(f"[lcp-hb] [scoring] {name}: no lcp_segside_hb span in {tries} profiled calls")


def scene_setup(device, workdir: str) -> dict:
    """Ray-cast the three-box scene and prepare its objects (shared by [e2e]
    and [e2e-large])."""
    from physimglobalpose_tpu_torch.config import DEFAULT_CONFIG
    from physimglobalpose_tpu_torch.models import objectdb
    from physimglobalpose_tpu_torch.pipeline import scene as scene_mod

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
        color=shade_scene(depth, label), depth=depth, intrinsics=INTRINSICS,
        cam_pose=cam_pose, object_names=[b[0] for b in BOXES], class_mask=label,
    )
    return dict(cam_pose=cam_pose, objects=objects, db=db, scene=sc, label=label)


def _check_objects(tag, result, setup, bar, device) -> dict:
    """Every object of the three-box scene back, in order, with a finite pose
    within `bar` ADD-S of the truth (no bar when bar is None). Returns the
    ADD-S by name."""
    from physimglobalpose_tpu_torch.geometry import metrics

    if [o.name for o in result.objects] != [b[0] for b in BOXES]:
        fail(f"{tag} estimate_pose returned another object list")
    inv_cam = np.linalg.inv(setup["cam_pose"])
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    adds_all = {}
    for (name, _cls, size, xy, yaw), est in zip(BOXES, result.objects):
        if not np.isfinite(est.pose_cam).all():
            fail(f"{tag} {name}: non-finite pose")
        gt_cam = inv_cam @ box_pose_world(size, xy, yaw)
        adds = float(metrics.adds_error(as_t(est.pose_cam), as_t(gt_cam),
                                        as_t(setup["objects"][name].validation_pts)))
        adds_all[name] = adds
        log(f"{tag} {name}: score={est.score:.4f} ADD-S={adds * 1000:.2f} mm "
            f"t_world={np.round(est.pose_world[:3, 3], 4).tolist()}")
        if bar is not None and not adds < bar:
            fail(f"{tag} {name}: ADD-S {adds * 1000:.2f} mm >= {bar * 1000:.1f} mm")
    return adds_all


def phase_e2e(device, workdir: str, setup: dict, large: bool = False) -> tuple[dict, dict]:
    """Run estimate_pose twice on the three-box scene (warm-up, then timed
    with the launch counts read around it). large=False: the default
    configuration, whose LCP calls take lcp_segside; large=True:
    max_segment_points = 4096, whose LCP calls take lcp_stream."""
    from physimglobalpose_tpu_torch.config import DEFAULT_CONFIG
    from physimglobalpose_tpu_torch.ops import lcp
    from physimglobalpose_tpu_torch.pipeline import api

    tag = "[e2e-large]" if large else "[e2e]"
    cfg = DEFAULT_CONFIG
    if large:
        cfg = dataclasses.replace(cfg, preprocess=dataclasses.replace(
            cfg.preprocess, max_segment_points=4096))
    result_path = os.path.join(workdir, "result_large.txt" if large else "result.txt")
    run = lambda: api.estimate_pose(
        "<memory>", setup["db"], segmentation_mode="GT", hypothesis_mode="PCS",
        verification_mode="LCP", cfg=cfg, seed=0, scene=setup["scene"],
        result_path=result_path, device=device,
    )
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    log(f"{tag} max_segment_points={cfg.preprocess.max_segment_points}: warm-up call "
        f"{time.perf_counter() - t0:.3f} s")

    for fn in (lcp.lcp_segside, lcp.lcp_stream):
        fn.launches, fn.tier_launches = 0, [0, 0, 0]
    t0 = time.perf_counter()
    result = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"lcp_segside": lcp.lcp_segside.tier_launches[0],
                "lcp_stream": lcp.lcp_stream.tier_launches[0]}

    timings = {k: v for k, v in result.timings.items() if k != "result_path"}
    timings["wall_s"] = wall
    log(f"{tag} timings {json.dumps(timings)}")
    log(f"{tag} launches during the timed call: {launches}")
    # One LCP call per object; the segment size decides which kernel takes it.
    want = {"lcp_segside": 0, "lcp_stream": len(BOXES)} if large else \
        {"lcp_segside": len(BOXES), "lcp_stream": 0}
    if launches != want:
        fail(f"{tag} launches {launches}, expected {want}")
    _check_objects(tag, result, setup, 0.01, device)
    with open(result_path) as fh:
        rows = [r.split() for r in fh.read().splitlines()]
    if len(rows) != 3 or any(len(r) != 8 for r in rows):
        fail(f"result.txt has {len(rows)} rows, want 3 rows of 8 fields")
    profile_scene(run, label="scene, 4,096-point segments" if large else "scene")
    return timings, launches


# The runtime API calls that launch a kernel: CUPTI records each on the host
# side, beside the kernel's device span.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def profile_scene(run, label: str = "scene") -> dict | None:
    """One more call of run() under torch.profiler: device busy time, its
    share of the wall time, and the device time by kernel (top entries).
    Launches are counted twice: the host's launch calls and the kernels'
    device spans. The profiler loses a few spans once a process has profiled
    large sessions (PERF.md section 7): spans_lost says how many, and busy
    time then reads low by their share."""
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    all_events = prof.events()
    events = [e for e in all_events if e.device_type == torch.autograd.DeviceType.CUDA]
    launch_calls = sum(1 for e in all_events
                       if e.device_type != torch.autograd.DeviceType.CUDA and e.name in LAUNCH_CALLS)
    if not events:
        log(f"[profile] {label}: no device events recorded: device busy share not measured")
        return None
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
    kernels = sum(1 for e in events if not e.name.startswith(("Memcpy", "Memset")))
    log("[profile] " + json.dumps({
        "what": label, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms, "device_events": len(events),
        "kernel_launches": launch_calls, "kernel_spans": kernels,
        "spans_lost": launch_calls - kernels,
        "top_device_ms": {k[:60]: round(v, 3) for k, v in top},
    }))
    return {"busy_ms": busy_ms, "launches": launch_calls, "spans_lost": launch_calls - kernels}


# The search phases' bar: every object within ADD-S 1 cm of the truth.
SEARCH_ADDS_BAR = 0.01
# [leaf]: the card's leaf batch against the same batch on the CPU.
TOL_LEAF_COST = 2.0  # pixels a leaf
TOL_LEAF_POS = 1e-3  # m
TOL_LEAF_ROT = 1e-3  # rad


def table_pose_world() -> np.ndarray:
    """The physics table box of the scene: top face at world z = 0."""
    from physimglobalpose_tpu_torch.config import DEFAULT_CONFIG

    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -DEFAULT_CONFIG.physics.table_half_extents[2]
    return pose


def phase_leaf(device, setup: dict) -> dict:
    """One BatchedLeafEvaluator on the three-box scene at the default
    configuration (render scale 4, 4,096-point render clouds, full hulls,
    sequential settle): 128 random placements from a numpy seed, on the card
    and on the CPU; then one batch timed warm with CUDA events and once
    under the profiler."""
    from physimglobalpose_tpu_torch.config import DEFAULT_CONFIG
    from physimglobalpose_tpu_torch.pipeline import api, mcts

    cfg = DEFAULT_CONFIG
    lcp_result = api.estimate_pose(
        "<memory>", setup["db"], cfg=cfg, seed=0, scene=setup["scene"], refine_final=False,
        write_result=False, device=device,
    )
    sc = setup["scene"]
    hyp_world, _scores, obj_hulls = mcts._scene_search_inputs(lcp_result.objects, sc, setup["db"], cfg)
    # The observed depth with the table removed exactly (the ray-cast labels).
    obs = np.where(setup["label"] > 0, sc.depth, 0.0).astype(np.float32)
    make = lambda dev: mcts.BatchedLeafEvaluator(
        obj_hulls, hyp_world, obs, sc.intrinsics, sc.cam_pose, table_pose_world(), cfg, device=dev)
    ev, ev_cpu = make(device), make("cpu")
    k, c = hyp_world.shape[:2]
    b = cfg.mcts.leaf_batch
    rng = np.random.default_rng(0)
    choices = rng.integers(0, c, (b, k))
    placed = rng.integers(1, k + 1, b)  # rows place 1..K objects, as the tree's do
    choices[np.arange(k)[None, :] >= placed[:, None]] = -1
    active = choices >= 0
    costs, settled = ev.evaluate(choices, active)
    costs_cpu, settled_cpu = ev_cpu.evaluate(choices, active)
    cost_err = float(np.abs(costs - costs_cpu).max())
    pos_err = float(np.abs(settled[..., :3, 3] - settled_cpu[..., :3, 3]).max())
    # The angle between two rotations from their chordal distance
    # |R1 - R2|_F = 2 sqrt(2) sin(angle / 2), which stays exact near zero.
    chord = np.linalg.norm((settled[..., :3, :3] - settled_cpu[..., :3, :3]).astype(np.float64),
                           axis=(-2, -1))
    rot_err = float((2.0 * np.arcsin(np.minimum(chord / (2.0 * np.sqrt(2.0)), 1.0))).max())
    log(f"[leaf] {b} leaves x {k} objects ({int(active.sum())} placements), render "
        f"{ev.h}x{ev.w}, {obj_hulls[0]['render_pts'].shape[0]}-point clouds: card vs CPU worst "
        f"cost {cost_err:.1f} px, position {pos_err:.2e} m, rotation {rot_err:.2e} rad; "
        f"costs {costs.min():.0f}-{costs.max():.0f}")
    if not (np.isfinite(costs).all() and np.isfinite(settled).all()):
        fail("[leaf] non-finite costs or poses")
    if cost_err > TOL_LEAF_COST or pos_err > TOL_LEAF_POS or rot_err > TOL_LEAF_ROT:
        fail(f"[leaf] the card and the CPU disagree beyond {TOL_LEAF_COST} px / "
             f"{TOL_LEAF_POS} m / {TOL_LEAF_ROT} rad")
    # Queueing a batch must not wait for the card: CUDA's sync debug mode
    # raises on any operation that synchronises with the host.
    torch.cuda.set_sync_debug_mode("error")
    try:
        ev.evaluate_async(choices, active)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("[leaf] evaluate_async queued a batch with no host synchronisation")
    ms = cuda_time_ms(lambda: ev.evaluate_async(choices, active), reps=3, warmup=1)
    log(f"[leaf] warm batch {ms:.2f} ms ({ms / b:.3f} ms a leaf), CUDA events")
    prof = profile_scene(lambda: ev.evaluate(choices, active), label=f"leaf batch of {b}") or {}
    return {"batch_ms": ms, "leaf_ms": ms / b, "device_busy_ms": prof.get("busy_ms"),
            "launches": prof.get("launches"), "spans_lost": prof.get("spans_lost"),
            "cost_err": cost_err,
            "pos_err": pos_err, "rot_err": rot_err}


def phase_search(device, workdir: str, setup: dict, mode: str) -> dict:
    """estimate_pose(verification_mode=mode) on the three-box scene at the
    default configuration (top_k 25, branching 25, 1,200 expansions, the
    TrICP final pass), on the card; every object within SEARCH_ADDS_BAR."""
    from physimglobalpose_tpu_torch.config import DEFAULT_CONFIG
    from physimglobalpose_tpu_torch.ops import lcp
    from physimglobalpose_tpu_torch.pipeline import api

    tag = f"[{mode.lower()}]"
    cfg = DEFAULT_CONFIG
    result_path = os.path.join(workdir, f"result_{mode}.txt")
    lcp.lcp_segside.launches, lcp.lcp_segside.tier_launches = 0, [0, 0, 0]
    t0 = time.perf_counter()
    result = api.estimate_pose(
        "<memory>", setup["db"], verification_mode=mode, cfg=cfg, seed=0,
        scene=setup["scene"], result_path=result_path, device=device,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lcp.lcp_segside.tier_launches[0]
    timings = {k: v for k, v in result.timings.items() if k != "result_path"}
    timings["wall_s"] = wall
    out = {"timings": timings, "lcp_segside_launches": launches}
    if mode == "MCTS":
        log(f"{tag} expansions {timings['search_expansions']} of a budget of "
            f"{timings['search_budget']}; the {cfg.mcts.max_search_seconds:.0f} s deadline cut "
            f"the search: {timings['search_deadline_cut']}")
    log(f"{tag} timings {json.dumps(timings)}; lcp_segside launches {launches}")
    if launches < 1:
        fail(f"{tag} the run launched no lcp_segside")
    out["adds_m"] = _check_objects(tag, result, setup, SEARCH_ADDS_BAR, device)
    with open(result_path) as fh:
        if len(fh.read().splitlines()) != len(BOXES):
            fail(f"{tag} result.txt does not have a row per object")
    return out


def phase_trace(device, workdir: str, setup: dict) -> dict:
    """[trace] utils/tracing.device_trace around one warm LCP scene (GT /
    PCS / LCP at the default configuration): the TensorBoard trace file it
    writes holds the lcp_segside kernel's device spans, printed beside the
    wrapper's launch count of the same run (one an object). Run before the
    large profiled sessions, after which the profiler can drop spans."""
    from physimglobalpose_tpu_torch.ops import lcp
    from physimglobalpose_tpu_torch.pipeline import api
    from physimglobalpose_tpu_torch.utils import tracing

    run = lambda: api.estimate_pose(  # noqa: E731
        "<memory>", setup["db"], seed=0, scene=setup["scene"], write_result=False, device=device)
    run()
    torch.cuda.synchronize()
    log_dir = os.path.join(workdir, "device_trace")
    lcp.lcp_segside.launches, lcp.lcp_segside.tier_launches = 0, [0, 0, 0]
    t0 = time.perf_counter()
    with tracing.device_trace(log_dir):
        run()
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    launches = lcp.lcp_segside.tier_launches[0]
    files = [f for f in os.listdir(log_dir) if f.endswith(".json")]
    if len(files) != 1:
        fail(f"[trace] device_trace wrote {files}, expected one trace file")
    with open(os.path.join(log_dir, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    spans = [e for e in kernels if "lcp_segside" in e.get("name", "")]
    # A launch of the wrapper runs the scan kernel and its finishing kernel.
    by_name: dict[str, list] = {}
    for e in spans:
        short = re.search(r"lcp_segside\w*", e["name"]).group(0)
        by_name.setdefault(short, []).append(round(e["dur"] / 1e3, 4))
    log(f"[trace] {files[0]}: {len(events)} events, {len(kernels)} kernel spans; lcp_segside "
        f"spans {len(spans)} (ms by kernel {json.dumps(by_name)}) beside lcp_segside launches "
        f"{launches}; traced scene {traced_s:.3f} s")
    if launches != len(BOXES):
        fail(f"[trace] lcp_segside launched {launches} times, expected {len(BOXES)}")
    if not spans:
        fail("[trace] the trace file holds no lcp_segside span")
    return {"launches": launches, "spans": len(spans), "kernel_spans": len(kernels),
            "span_ms": by_name, "traced_s": traced_s}


# [debug]: the card's final mesh render against the same render on the CPU.
MIN_DEBUG_RENDER_AGREEMENT = 0.999


def phase_debug(device, workdir: str, setup: dict) -> dict:
    """[debug] estimate_pose in MCTS mode with debug_dir on the three-box
    scene: the JAX package's file list; lcp_segside launched once an object;
    final_assignment_mesh_render (the triangle render of the final poses on
    the card, through the PNG codec) against the same render on the CPU."""
    from physimglobalpose_tpu_torch.config import DEFAULT_CONFIG
    from physimglobalpose_tpu_torch.geometry import depthio
    from physimglobalpose_tpu_torch.models import assets
    from physimglobalpose_tpu_torch.ops import lcp, raster, raster_tri
    from physimglobalpose_tpu_torch.pipeline import api

    cfg, db = DEFAULT_CONFIG, setup["db"]
    debug_dir = os.path.join(workdir, "debug_mcts")
    lcp.lcp_segside.launches, lcp.lcp_segside.tier_launches = 0, [0, 0, 0]
    t0 = time.perf_counter()
    result = api.estimate_pose("<memory>", db, verification_mode="MCTS", cfg=cfg, seed=0,
                               scene=setup["scene"], write_result=False, debug_dir=debug_dir,
                               device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lcp.lcp_segside.tier_launches[0]
    names = [b[0] for b in BOXES]
    want = {"depth_clean.png", "depth_clean_viz.png", "final_assignment_mesh_render.png",
            "final_assignment_mesh_render_viz.png", "final_overlay.png"}
    want |= {f"{n}{suffix}" for n in names for suffix in ("_prob.png", "_hypotheses.npz", ".json")}
    files = set(os.listdir(debug_dir))
    if files != want:
        fail(f"[debug] the dump holds {sorted(files)}, expected {sorted(want)}")
    if launches != len(BOXES):
        fail(f"[debug] lcp_segside launched {launches} times, expected {len(BOXES)}")
    _check_objects("[debug]", result, setup, SEARCH_ADDS_BAR, device)
    cpu = torch.device("cpu")
    intr = torch.as_tensor(INTRINSICS)
    final = torch.zeros(cfg.render.height, cfg.render.width)
    t0 = time.perf_counter()
    for est in result.objects:
        mesh = assets.decimate_to_max_faces(db[est.name].mesh, 3000)
        final = raster.composite_min(final, raster_tri.render_mesh_depth(
            torch.as_tensor(est.pose_cam.astype(np.float32)), torch.as_tensor(mesh.vertices),
            torch.as_tensor(mesh.faces), torch.ones(len(mesh.faces), dtype=torch.bool, device=cpu),
            intr, cfg.render.height, cfg.render.width))
    cpu_s = time.perf_counter() - t0
    final = torch.where(final > cfg.render.max_render_depth, 0.0, final).numpy()
    card = depthio.read_depth_png(os.path.join(debug_dir, "final_assignment_mesh_render.png"),
                                  bit_rotated=False)
    ref = depthio.decode_depth(depthio.encode_depth(final), bit_rotated=False)
    agree = float((card == ref).mean())
    covered = int((card > 0).sum())
    log(f"[debug] MCTS scene with debug_dir: {len(files)} files, the JAX package's list; "
        f"lcp_segside launches {launches}; wall {wall:.3f} s, timings "
        f"{json.dumps({k: v for k, v in result.timings.items() if k != 'result_path'})}; "
        f"final_assignment_mesh_render: {covered} covered pixels, equal to the CPU render at "
        f"{agree:.6f} of pixels (CPU render {cpu_s:.2f} s)")
    if covered < 1000 or agree < MIN_DEBUG_RENDER_AGREEMENT:
        fail(f"[debug] the card's final render agrees with the CPU's at {agree:.6f} of pixels "
             f"({covered} covered)")
    return {"launches": launches, "wall_s": wall, "render_agreement": agree,
            "covered_pixels": covered, "files": len(files)}


# [train-fcn] and [train-detect]: the first step's loss on the card against
# the CPU (bf16 convolutions: cuDNN's are not the CPU's), and the reloaded
# checkpoint's labels, card against CPU, in float32 (the bar of the CPU
# tests) and in the served bf16 (the serving bar of [fcn]).
TOL_TRAIN_FIRST_LOSS = 0.02
MIN_TRAIN_LABEL_AGREEMENT = 0.999
TRAIN_STEPS = 50
TRAIN_SCENES = 12


def _labels(model, images, net: str) -> np.ndarray:
    """Per-pixel argmax classes of the FCN, per-cell argmax classes of the
    detector's centre heatmap, for NHWC float images."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        out = model(torch.as_tensor(images).to(dev).permute(0, 3, 1, 2))
    return torch.argmax(out if net == "fcn" else out[0], dim=1).cpu().numpy()


def phase_train(device, workdir: str, net: str) -> dict:
    """[train-fcn] / [train-detect]: the training scripts' train() on the
    card on synthetic renders of the three boxes (TRAIN_SCENES scenes,
    TRAIN_STEPS Adam steps): first, one step of the same initial net on the
    same batch on the card and on the CPU (losses within 2 %); then the run,
    whose loss must fall (mean of the last 10 steps below the first 10),
    with its steps a second; the checkpoint it saves, reloaded on the card
    and on the CPU, gives the same labels on the held-out scenes."""
    import copy

    from physimglobalpose_tpu_torch.models import assets, detect, fcn
    from physimglobalpose_tpu_torch.scripts import train_detector, train_fcn
    from physimglobalpose_tpu_torch.utils import synthdata

    tag = f"[train-{'fcn' if net == 'fcn' else 'detect'}]"
    meshes, objects = {}, {}
    for name, cls, size, _xy, _yaw in BOXES:
        verts, faces = write_box_ply(os.path.join(workdir, f"train_{name}.ply"), size)
        meshes[name], objects[name] = assets.Mesh(verts, faces), cls
    cpu = torch.device("cpu")
    rng = np.random.default_rng(1)
    if net == "fcn":
        colors, labels, val = train_fcn.render_training_scenes(meshes, objects, rng, 3,
                                                               device=device)
        batch = synthdata.crop_batch(colors, labels, rng, 8, 160)
        model = fcn.build_model("AtrousFCN_Vgg16_16s_small", train_fcn.NUM_CLASSES)
        make_step = fcn.make_train_step
    else:
        colors, heats, sizes, poss, val = train_detector.render_training_scenes(
            meshes, objects, rng, 3, 240, 320, device=device)
        batch = (colors[[0, 1, 2, 0]], heats[[0, 1, 2, 0]], sizes[[0, 1, 2, 0]],
                 poss[[0, 1, 2, 0]])
        model = detect.CenterNetDetector(num_classes=detect.NUM_CLASSES)
        make_step = detect.make_train_step
    fcn.init_like_flax(model, seed=0)
    first = {}
    for where, dev in (("cpu", cpu), ("card", device)):
        m = copy.deepcopy(model).to(dev)
        first[where] = float(make_step(m, torch.optim.Adam(m.parameters(), lr=1e-3))(*batch))
    rel = abs(first["card"] - first["cpu"]) / abs(first["cpu"])
    log(f"{tag} first step's loss: card {first['card']:.6f}, CPU {first['cpu']:.6f} "
        f"(relative difference {rel:.2e})")
    if not rel <= TOL_TRAIN_FIRST_LOSS:
        fail(f"{tag} the first step's loss differs by {rel:.2e} between card and CPU")

    out = os.path.join(workdir, f"train_{net}.npz")
    t0 = time.perf_counter()
    if net == "fcn":
        res = train_fcn.train(meshes, objects, steps=TRAIN_STEPS, scenes=TRAIN_SCENES, out=out,
                              device=device, log=lambda m: log(f"{tag} {m}"))
        score = res["holdout_miou"]
    else:
        res = train_detector.train(meshes, objects, steps=TRAIN_STEPS, scenes=TRAIN_SCENES,
                                   out=out, device=device, log=lambda m: log(f"{tag} {m}"))
        score = res["holdout_box_iou"]
    wall = time.perf_counter() - t0
    losses = res["losses"]
    head, tail = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    if not (np.isfinite(losses).all() and tail < head):
        fail(f"{tag} the loss did not fall: first 10 steps {head:.4f}, last 10 {tail:.4f}")

    flat, meta = fcn.load_params_npz(out)
    images = np.stack([c for c, _ in val]) if net != "fcn" else None
    agree = {}
    for dtype in (torch.float32, torch.bfloat16):
        labels_by_dev = []
        for dev in (device, cpu):
            m = (fcn.build_model(meta["model"], meta["num_classes"], dtype=dtype) if net == "fcn"
                 else detect.CenterNetDetector(meta["num_classes"], meta["width"], dtype=dtype))
            m = fcn.load_flax_params(m, flat).to(dev)
            if net == "fcn":  # the held-out scenes come in two sizes
                labels_by_dev.append(np.concatenate([
                    _labels(m, (c[None].astype(np.float32) / 255.0), net).ravel() for c, _ in val]))
            else:
                labels_by_dev.append(_labels(m, images.astype(np.float32) / 255.0, net).ravel())
        agree[str(dtype).split(".")[-1]] = float((labels_by_dev[0] == labels_by_dev[1]).mean())
    log(f"{tag} {TRAIN_STEPS} steps on {TRAIN_SCENES} scenes in {wall:.2f} s with the renders "
        f"({res['steps_per_s']:.2f} steps/s in the loop); loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(mean of first/last 10: {head:.4f} -> {tail:.4f}); held-out score {score:.3f}; "
        f"checkpoint {os.path.getsize(out) / 1e6:.2f} MB reloaded on card and CPU, labels "
        f"agreeing {json.dumps(agree)}")
    if agree["float32"] < MIN_TRAIN_LABEL_AGREEMENT or agree["bfloat16"] < MIN_FCN_LABEL_AGREEMENT:
        fail(f"{tag} the reloaded checkpoint's labels differ between card and CPU: {agree}")
    return {"first_loss": first, "first_loss_rel": rel, "steps": TRAIN_STEPS,
            "steps_per_s": res["steps_per_s"], "wall_s": wall, "loss_first10": head,
            "loss_last10": tail, "holdout_score": score, "label_agreement": agree}


# [fcn] and [detect]: the card's networks against the same networks on the
# CPU, with the CPU tests' bars (tests/test_torch_fcn.py, test_torch_detect.py).
TOL_FCN_MAPS = 2e-2  # the float16 maps and the background map
MIN_FCN_LABEL_AGREEMENT = 0.99  # share of pixels with the same argmax class
TOL_BOX_PX = 1.0  # the top box of a class whose score is >= MIN_BOX_SCORE
TOL_BOX_SCORE = 1e-2  # each class's top score
MIN_BOX_SCORE = 0.05
# [e2e-neural]: each object's probability image, card against CPU.
MIN_PROB_IMAGE_AGREEMENT = 0.99


def phase_fcn(device, setup: dict) -> dict:
    """[fcn] The shipped "small" predictor at its 640x640 serving canvas on the
    scene's 480x640 colour frame, then "prior" with TTA (0.5, 0.75, 1.0): the
    card (bf16 convolutions on cuDNN, as the Flax modules) against the same
    predictor on the CPU; warm frame time (CUDA events around the whole
    predictor call: upload, forward, readback) and launches a frame."""
    from physimglobalpose_tpu_torch.models import fcn

    img = setup["scene"].color
    ids = [b[1] for b in BOXES]
    out = {}
    for variant, tta in (("small", (1.0,)), ("prior", (0.5, 0.75, 1.0))):
        tag = variant if len(tta) == 1 else f"{variant}+tta"
        pred = fcn.load_shipped_predictor(variant=variant, tta_scales=tta, device=device)
        pred_cpu = fcn.load_shipped_predictor(variant=variant, tta_scales=tta, device="cpu")
        got, want = pred(img, ids), pred_cpu(img, ids)
        keys = ids + [fcn.PREDICTOR_BACKGROUND_KEY]
        map_err = max(float(np.abs(got[k] - want[k]).max()) for k in keys)
        label = got[fcn.PREDICTOR_LABEL_KEY]
        agree = float((label == want[fcn.PREDICTOR_LABEL_KEY]).mean())
        iou = {}
        for _name, cls, *_ in BOXES:
            a, b = label == cls, setup["label"] == cls
            iou[cls] = float((a & b).sum() / max((a | b).sum(), 1))
        ms = cuda_time_ms(lambda: pred(img, ids), reps=10, warmup=2)
        prof = profile_scene(lambda: pred(img, ids), label=f"fcn {tag} frame") or {}
        log(f"[fcn] {tag}: card vs CPU max map error {map_err:.2e}, label agreement "
            f"{agree:.5f}; warm frame {ms:.2f} ms (CUDA events); IoU with the scene's masks "
            f"{json.dumps({k: round(v, 3) for k, v in iou.items()})} (not held: trained on "
            f"other meshes)")
        if not all(np.isfinite(got[k]).all() for k in keys):
            fail(f"[fcn] {tag}: non-finite maps")
        if map_err > TOL_FCN_MAPS or agree < MIN_FCN_LABEL_AGREEMENT:
            fail(f"[fcn] {tag}: the card and the CPU disagree beyond {TOL_FCN_MAPS} / "
                 f"{MIN_FCN_LABEL_AGREEMENT} label agreement")
        out[tag] = {"frame_ms": ms, "map_err": map_err, "label_agreement": agree,
                    "launches": prof.get("launches"), "device_busy_ms": prof.get("busy_ms"),
                    "iou": iou}
    return out


def phase_detect(device, setup: dict) -> dict:
    """[detect] The shipped detection network (CenterNet, input 240x320) on the
    scene's 480x640 colour frame, card against CPU: the same top box per class
    within TOL_BOX_PX wherever the score is at least MIN_BOX_SCORE; warm frame
    time; then the learned detector callable on the card (the "prior" FCN with
    TTA for the classes it misses)."""
    from physimglobalpose_tpu_torch.models import detect
    from physimglobalpose_tpu_torch.pipeline import detector as detector_mod

    img = setup["scene"].color
    bp = detect.load_shipped_box_predictor(device=device)
    boxes, scores = bp(img)
    cboxes, cscores = detect.load_shipped_box_predictor(device="cpu")(img)
    fired = cscores[:, 0] >= MIN_BOX_SCORE
    box_err = float(np.abs(boxes[fired, 0] - cboxes[fired, 0]).max()) if fired.any() else 0.0
    score_err = float(np.abs(scores[:, 0] - cscores[:, 0]).max())  # each class's top score
    ms = cuda_time_ms(lambda: bp(img), reps=10, warmup=2)
    prof = profile_scene(lambda: bp(img), label="detector frame") or {}
    learned = detector_mod.make_learned_detector(device=device)(img, [b[1] for b in BOXES])
    log(f"[detect] classes at score >= {MIN_BOX_SCORE}: {(np.nonzero(fired)[0] + 1).tolist()}; "
        f"card vs CPU top box {box_err:.3f} px, top scores {score_err:.2e}; warm frame {ms:.2f} ms "
        f"(CUDA events); learned detector boxes {json.dumps(learned)}")
    if not fired.any():
        fail("[detect] no class reached the score bar on the CPU: nothing to compare")
    if box_err > TOL_BOX_PX or score_err > TOL_BOX_SCORE:
        fail(f"[detect] the card and the CPU disagree beyond {TOL_BOX_PX} px / {TOL_BOX_SCORE}")
    return {"frame_ms": ms, "box_err_px": box_err, "score_err": score_err,
            "classes_fired": int(fired.sum()), "launches": prof.get("launches"),
            "device_busy_ms": prof.get("busy_ms")}


# [e2e-modes]: the ADD-S bar of each hypothesis mode, from the JAX package on
# the same scene at seed 0 on the CPU (scripts/jax_scene_modes_bar.py): 1 cm
# where JAX puts every object within 1 cm, else JAX's worst ADD-S plus 1 cm.
MODE_ADDS_BAR = {"SUPER4PCS": 0.01, "V4PCS": 0.01, "PPF_VOTING": 0.01}


def phase_modes(device, workdir: str, setup: dict) -> dict:
    """[e2e-modes] estimate_pose on the three-box scene at the default
    configuration with GT segmentation, LCP verification and each of the
    SUPER4PCS, V4PCS (uniform bases, distance pair lists, 10,000 hypotheses an
    object, batched) and PPF_VOTING (256 voted poses an object) generators: a
    warm-up call, then a timed one with lcp_segside's count read around it
    (one launch an object); every object within MODE_ADDS_BAR."""
    from physimglobalpose_tpu_torch.config import DEFAULT_CONFIG
    from physimglobalpose_tpu_torch.ops import lcp
    from physimglobalpose_tpu_torch.pipeline import api

    out = {}
    for mode, bar in MODE_ADDS_BAR.items():
        tag = f"[e2e-modes] {mode}:"
        result_path = os.path.join(workdir, f"result_{mode}.txt")
        run = lambda: api.estimate_pose(  # noqa: E731
            "<memory>", setup["db"], hypothesis_mode=mode, cfg=DEFAULT_CONFIG, seed=0,
            scene=setup["scene"], result_path=result_path, device=device)
        run()
        lcp.lcp_segside.launches, lcp.lcp_segside.tier_launches = 0, [0, 0, 0]
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = lcp.lcp_segside.tier_launches[0]
        timings = {k: v for k, v in result.timings.items() if k != "result_path"}
        timings["wall_s"] = wall
        log(f"{tag} timings {json.dumps(timings)}; lcp_segside launches {launches}")
        if launches != len(BOXES):
            fail(f"{tag} lcp_segside launched {launches} times, expected {len(BOXES)}")
        adds = _check_objects(tag, result, setup, bar, device)
        with open(result_path) as fh:
            if len(fh.read().splitlines()) != len(BOXES):
                fail(f"{tag} result.txt does not have a row per object")
        out[mode] = {"timings": timings, "lcp_segside_launches": launches, "adds_m": adds,
                     "bar_m": bar}
    return out


def phase_neural(device, workdir: str, setup: dict) -> dict:
    """[e2e-neural] estimate_pose on the three-box scene's colour frame in
    FCN, FCNThreshold, RCNN and RCNNThreshold mode with the shipped networks
    (the "small" FCN; the detection network, with the "prior" FCN for classes
    it misses), PCS / LCP at the default configuration, on the card: a
    warm-up call, then a timed one. The probability images the card's call
    builds (caught at segmentation.build_prob_images) are held against the
    same networks' on the CPU: at least MIN_PROB_IMAGE_AGREEMENT of the pixels
    of each object's image. Every object comes back with a finite pose, the
    identity where its image is empty (the JAX package's bail on a degenerate
    segment). The poses are not held to the truth: the shipped networks were
    trained on renders of the reference's meshes, which this repo lacks, not
    on these boxes."""
    from physimglobalpose_tpu_torch.config import DEFAULT_CONFIG
    from physimglobalpose_tpu_torch.models import fcn
    from physimglobalpose_tpu_torch.ops import lcp
    from physimglobalpose_tpu_torch.pipeline import api, detector as detector_mod
    from physimglobalpose_tpu_torch.pipeline import segmentation

    sc = setup["scene"]
    ids = [b[1] for b in BOXES]
    cpu_nets = dict(nn_predictor=fcn.load_shipped_predictor(device="cpu"),
                    detector=detector_mod.make_learned_detector(device="cpu"))
    real = segmentation.build_prob_images
    seen = {}

    def spy(*a, **k):
        seen["card"] = real(*a, **k)
        return seen["card"]

    out = {}
    for mode in ("FCN", "FCNThreshold", "RCNN", "RCNNThreshold"):
        tag = f"[e2e-neural] {mode}:"
        run = lambda: api.estimate_pose(  # noqa: E731
            "<memory>", setup["db"], segmentation_mode=mode, cfg=DEFAULT_CONFIG, seed=0,
            scene=sc, write_result=False, device=device)
        run()
        segmentation.build_prob_images = spy
        try:
            lcp.lcp_segside.launches, lcp.lcp_segside.tier_launches = 0, [0, 0, 0]
            t0 = time.perf_counter()
            result = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            segmentation.build_prob_images = real
        cpu_images = real(mode, ids, color=sc.color, threshold=DEFAULT_CONFIG.preprocess.background_prob,
                          **cpu_nets)
        agree = {c: float((seen["card"][c] == cpu_images[c]).mean()) for c in ids}
        pixels = {c: int((seen["card"][c] > 0).sum()) for c in ids}
        timings = {k: v for k, v in result.timings.items() if k != "result_path"}
        timings["wall_s"] = wall
        log(f"{tag} timings {json.dumps(timings)}; mask pixels {json.dumps(pixels)}; card vs CPU "
            f"image agreement {json.dumps({c: round(a, 5) for c, a in agree.items()})}; "
            f"lcp_segside launches {lcp.lcp_segside.tier_launches[0]}")
        if min(agree.values()) < MIN_PROB_IMAGE_AGREEMENT:
            fail(f"{tag} the card's probability images differ from the CPU's")
        adds = _check_objects(tag, result, setup, None, device)
        for (_name, cls, *_), est in zip(BOXES, result.objects):
            if pixels[cls] == 0 and not (np.allclose(est.pose_cam, np.eye(4)) and est.score == 0):
                fail(f"{tag} class {cls}: an empty mask must give the identity pose")
        out[mode] = {"timings": timings, "mask_pixels": pixels, "image_agreement": agree,
                     "adds_m_not_held": adds, "lcp_segside_launches": lcp.lcp_segside.tier_launches[0]}
    return out


# [sweep]: on one card each scene of the sweep equals serial estimate_pose bit
# for bit: the voxel sums are a segmented reduction in sorted order
# (ops/voxel.py), so a seed gives one result. Across cards the jobs run on
# other devices, and the sweep is held to the JAX package's sweep test bars
# (tests/test_scene_sweep.py); [serve] keeps those bars too.
SWEEP_TOL_SCORE = 3e-3
SWEEP_TOL_POSE = 5e-4


def _adds_m(setup, name, pose_cam, gt_world, device) -> float:
    from physimglobalpose_tpu_torch.geometry import metrics

    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    gt_cam = np.linalg.inv(setup["cam_pose"]) @ gt_world
    return float(metrics.adds_error(as_t(pose_cam), as_t(gt_cam),
                                    as_t(setup["objects"][name].validation_pts)))


def _check_against(tag, got, want, gt, setup, device, bar=SEARCH_ADDS_BAR, pose_tol=SWEEP_TOL_POSE,
                   score_tol=SWEEP_TOL_SCORE) -> dict:
    """One scene's objects against a reference result (same names, scores
    within score_tol, pose_cam within pose_tol) and within `bar` ADD-S of the
    truth. Returns the worst differences and the ADD-S by name."""
    if [o.name for o in got] != [o.name for o in want] or [o.name for o in got] != list(gt):
        fail(f"{tag} another object list")
    score_err = max(abs(a.score - b.score) for a, b in zip(got, want))
    pose_err = max(float(np.abs(a.pose_cam - b.pose_cam).max()) for a, b in zip(got, want))
    adds = {o.name: _adds_m(setup, o.name, o.pose_cam, gt[o.name], device) for o in got}
    if not all(np.isfinite(o.pose_cam).all() for o in got):
        fail(f"{tag} a non-finite pose")
    if score_err > score_tol or pose_err > pose_tol:
        fail(f"{tag} score differs by {score_err:.2e} (bar {score_tol}), pose_cam by "
             f"{pose_err:.2e} (bar {pose_tol}); ADD-S mm "
             f"{ {k: round(v * 1000, 2) for k, v in adds.items()} } against "
             f"{ {o.name: round(_adds_m(setup, o.name, o.pose_cam, gt[o.name], device) * 1000, 2) for o in want} }")
    if bar is not None and max(adds.values()) >= bar:
        fail(f"{tag} ADD-S {max(adds.values()) * 1000:.2f} mm >= {bar * 1000:.1f} mm")
    return {"score_err": score_err, "pose_err": pose_err, "adds_m": adds}


def phase_sweep(device, workdir: str, setup: dict) -> dict:
    """[sweep] scene_sweep.sweep_scenes over four scene directories of the
    three boxes (moved and turned per scene, SWEEP_MOVES; ray-cast, written
    in the reference layout) at the default configuration, its job axis over
    every card make_mesh() finds: each scene against serial estimate_pose
    on the card (bit for bit on one card) and within ADD-S 1 cm of the
    truth, unchunked and with pipeline_chunks=2; lcp_segside launched once a
    job; _dispatch_jobs queues its batch with no host synchronisation;
    scenes a second, the
    host's preprocessing time, the device's busy and idle share. With more
    than one card, the sharded run against a one-card run."""
    from physimglobalpose_tpu_torch.config import DEFAULT_CONFIG
    from physimglobalpose_tpu_torch.ops import lcp
    from physimglobalpose_tpu_torch.parallel import mesh as mesh_mod, scene_sweep
    from physimglobalpose_tpu_torch.pipeline import api

    cfg, db = DEFAULT_CONFIG, setup["db"]
    dirs, gts = [], []
    for i, move in enumerate(SWEEP_MOVES):
        dirs.append(os.path.join(workdir, f"sweep_scene_{i}"))
        gts.append(write_scene_dir(dirs[-1], setup["cam_pose"], moved_boxes(move)))
    mesh = mesh_mod.make_mesh()
    cards = mesh.size
    jobs = len(dirs) * len(BOXES)
    log(f"[sweep] {len(dirs)} scenes x {len(BOXES)} objects ({jobs} jobs) over {cards} card(s) "
        f"{[str(d) for d in mesh.device_list]}; more than one card exercised: {cards > 1}")
    serial = [api.estimate_pose(d, db, cfg=cfg, seed=0, write_result=False, device=device)
              for d in dirs]
    # A seed gives one result on the card: the segments' voxel sums are a
    # segmented reduction in a fixed order (ops/voxel.py), not float atomics.
    again = api.estimate_pose(dirs[0], db, cfg=cfg, seed=0, write_result=False, device=device)
    for a, b in zip(again.objects, serial[0].objects):
        if a.score != b.score or not np.array_equal(a.pose_cam, b.pose_cam):
            fail(f"[sweep] serial estimate_pose gave {a.name} another result on a second run")
    log("[sweep] serial estimate_pose twice on scene 0: the same bits")
    sweep = lambda m=mesh, **kw: scene_sweep.sweep_scenes(m, dirs, db, cfg=cfg, seed=0, **kw)  # noqa: E731
    sweep()  # warm-up
    # Queueing a batch must not wait for the card.
    prepared = scene_sweep.prepare_scenes(dirs, db, cfg=cfg, seed=0, device=device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = scene_sweep._dispatch_jobs(mesh, prepared, db, cfg, "stocs", 25, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    scene_sweep._finalize_jobs(state)
    log("[sweep] _dispatch_jobs queued a job batch with no host synchronisation")

    lcp.lcp_segside.launches, lcp.lcp_segside.tier_launches = 0, [0, 0, 0]
    t0 = time.perf_counter()
    swept = sweep()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lcp.lcp_segside.tier_launches[0]
    want = mesh_mod.padded_length(jobs, mesh)
    log(f"[sweep] lcp_segside launches {launches} for {jobs} jobs (padded to {want})")
    if launches != want:
        fail(f"[sweep] lcp_segside launched {launches} times, expected {want}")
    piped = sweep(pipeline_chunks=2)
    tols = dict(score_tol=0.0, pose_tol=0.0) if cards == 1 else {}
    checks = {}
    for i, d in enumerate(dirs):
        checks[f"scene_{i}"] = _check_against(f"[sweep] scene {i}:", swept[d].objects,
                                              serial[i].objects, gts[i], setup, device, **tols)
        checks[f"scene_{i}_pipelined"] = _check_against(
            f"[sweep] scene {i} pipelined:", piped[d].objects, serial[i].objects, gts[i], setup,
            device, **tols)
        log(f"[sweep] scene {i}: against serial score {checks[f'scene_{i}']['score_err']:.1e}, "
            f"pose {checks[f'scene_{i}']['pose_err']:.1e}; ADD-S mm "
            f"{json.dumps({k: round(v * 1000, 2) for k, v in checks[f'scene_{i}']['adds_m'].items()})}")
    t_sw, t_pi = swept[dirs[0]].timings, piped[dirs[0]].timings
    log(f"[sweep] unchunked {json.dumps(t_sw)} (wall {wall:.3f} s); pipeline_chunks=2 "
        f"{json.dumps(t_pi)}; serial total_s per scene "
        f"{json.dumps([round(r.timings['total_s'], 4) for r in serial])}")
    prof = profile_scene(sweep, label=f"sweep of {len(dirs)} scenes") or {}
    out = {"dirs": dirs, "gts": gts, "cards": cards, "jobs": jobs, "lcp_segside_launches": launches,
           "wall_s": wall, "timings": t_sw, "timings_pipelined": t_pi,
           "serial_total_s": [r.timings["total_s"] for r in serial],
           "device_busy_ms": prof.get("busy_ms"), "launches_profiled": prof.get("launches"),
           "checks": checks}
    if cards > 1:
        one = sweep(mesh_mod.make_mesh(1))
        for i, d in enumerate(dirs):
            _check_against(f"[sweep] scene {i} {cards} cards vs one:", swept[d].objects,
                           one[d].objects, gts[i], setup, device)
        log(f"[sweep] the {cards}-card sweep equals the one-card sweep")
    return out


def _same_estimates(a, b) -> bool:
    return all(x.name == y.name and x.score == y.score and np.array_equal(x.pose_world, y.pose_world)
               for x, y in zip(a, b)) and len(a) == len(b)


def phase_sweep_mcts(device, setup: dict, sweep_info: dict, leaf_stats: dict) -> dict:
    """[sweep-mcts] the search over three of [sweep]'s scenes at once, fed
    what the serial MCTS path gives mcts_select (its LCP-stage estimates, the
    world-frame table box refined from the raw depth, the cleaned depth, the
    segments; caught there):
    - one shared batch (512 rows, each scene's 128 random placements and
      padding) against each scene's own evaluator: the same costs and
      settled poses, to the bit;
    - mcts_select_multi at the default MCTS configuration: 1,200 of 1,200
      expansions a scene and every object within ADD-S 1 cm, beside one
      mcts_select a scene (tree s seeded with s, as in the shared search;
      also within ADD-S 1 cm). The shared search splits its batch over the
      live trees (512 // 3 rows a tree against 128), so a tree's virtual-loss
      batches and its path can differ: the scenes with the same result are
      counted, not required;
    - with branching 4 (a tree of 85 nodes, enumerated in one batch),
      mcts_select_multi equal to one mcts_select a scene, to the bit;
    - one shared batch's launches a leaf against [leaf]'s;
    - sweep_scenes(verification_mode="MCTS") once, its poses logged beside the
      JAX sweep's table-pose finding (not held: that sweep hands the search
      remove_table's camera-frame table pose)."""
    from physimglobalpose_tpu_torch.config import DEFAULT_CONFIG
    from physimglobalpose_tpu_torch.parallel import mesh as mesh_mod, scene_sweep
    from physimglobalpose_tpu_torch.pipeline import api, mcts

    cfg, db = DEFAULT_CONFIG, setup["db"]
    dirs, gts = sweep_info["dirs"][:3], sweep_info["gts"][:3]
    mesh = mesh_mod.make_mesh()
    real, rows = mcts.mcts_select, []

    def catch(estimates, sc, db_, table_pose, depth_clean, cfg_, seed=0, segs=None, **kw):
        rows.append((estimates, sc, table_pose, depth_clean, segs))
        return estimates

    mcts.mcts_select = catch
    try:
        for d in dirs:
            api.estimate_pose(d, db, verification_mode="MCTS", cfg=cfg, seed=0, write_result=False,
                              device=device)
    finally:
        mcts.mcts_select = real

    # One shared batch against each scene's own evaluator.
    evs = []
    for est, sc, tp, dc, _segs in rows:
        hw, _hs, hulls = mcts._scene_search_inputs(est, sc, db, cfg)
        evs.append(mcts.BatchedLeafEvaluator(hulls, hw, dc, sc.intrinsics, sc.cam_pose, tp, cfg,
                                             device=device))
    msev = mcts.MultiSceneLeafEvaluator(evs, mesh=mesh)
    b, k = max(cfg.mcts.leaf_batch, cfg.mcts.leaf_batch_multi), msev.k_max
    rng = np.random.default_rng(0)
    per = min(cfg.mcts.leaf_batch, b // len(evs))
    choices = rng.integers(0, evs[0].num_hyp, (b, k))
    choices[np.arange(k)[None, :] >= rng.integers(1, k + 1, b)[:, None]] = -1
    scene_idx = np.minimum(np.arange(b) // per, len(evs) - 1)
    costs, settled = msev.evaluate(scene_idx, choices, choices >= 0)
    for si, ev in enumerate(evs):
        sel = slice(si * per, (si + 1) * per)
        c1, s1 = ev.evaluate(choices[sel], choices[sel] >= 0)
        if not (np.array_equal(costs[sel], c1) and np.array_equal(settled[sel], s1)):
            fail(f"[sweep-mcts] scene {si}: the shared batch's rows differ from the scene's own "
                 f"evaluator (costs {np.abs(costs[sel] - c1).max()}, poses "
                 f"{np.abs(settled[sel] - s1).max():.2e})")
    log(f"[sweep-mcts] a shared batch of {b} rows: each scene's {per} rows equal its own "
        f"evaluator's, costs and settled poses to the bit")

    def searches(cfg_):
        singles = [mcts.mcts_select(est, sc, db, tp, dc, cfg_, seed=si, segs=segs, device=device)
                   for si, (est, sc, tp, dc, segs) in enumerate(rows)]
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        multi = mcts.mcts_select_multi([r[:4] for r in rows], db, cfg_, seed=0, mesh=mesh,
                                       segs_list=[r[4] for r in rows], device=device, stats=stats)
        torch.cuda.synchronize()
        return singles, multi, stats, time.perf_counter() - t0

    t0 = time.perf_counter()
    singles, multi, stats, search_s = searches(cfg)
    single_s = time.perf_counter() - t0 - search_s
    log(f"[sweep-mcts] {len(rows)} scenes: search_s {search_s:.3f} (one mcts_select a scene: "
        f"{single_s:.3f} s in all); expansions {stats['search_expansions']} of "
        f"{stats['search_budget']}; {stats['shared_batches']} shared batches, "
        f"{stats['leaves']} leaves")
    if stats["search_expansions"] != stats["search_budget"] or min(stats["search_budget"]) < 1200:
        fail(f"[sweep-mcts] expansions {stats['search_expansions']} short of the budget")
    adds, same = {}, 0
    for si in range(len(rows)):
        for tag, result in (("shared", multi[si]), ("single", singles[si])):
            adds[f"scene_{si}_{tag}"] = a = {o.name: _adds_m(setup, o.name, o.pose_cam,
                                                             gts[si][o.name], device)
                                             for o in result}
            if max(a.values()) >= SEARCH_ADDS_BAR:
                fail(f"[sweep-mcts] scene {si} ({tag} search): ADD-S "
                     f"{max(a.values()) * 1000:.2f} mm >= {SEARCH_ADDS_BAR * 1000:.1f} mm")
        same += _same_estimates(multi[si], singles[si])
    log(f"[sweep-mcts] ADD-S mm {json.dumps({k: {n: round(v * 1000, 2) for n, v in a.items()} for k, a in adds.items()})}; "
        f"the shared search gave the single search's result in {same} of {len(rows)} scenes")

    small = dataclasses.replace(cfg, mcts=dataclasses.replace(cfg.mcts, branching=4))
    s_singles, s_multi, s_stats, _ = searches(small)
    for si in range(len(rows)):
        if not _same_estimates(s_multi[si], s_singles[si]):
            fail(f"[sweep-mcts] branching 4, scene {si}: mcts_select_multi differs from mcts_select")
    log(f"[sweep-mcts] branching 4 (trees of {s_stats['search_budget']} nodes, expansions "
        f"{s_stats['search_expansions']}): mcts_select_multi equals one mcts_select a scene, to "
        f"the bit")

    # Launches a leaf: one shared batch of the search's width, profiled.
    batch_ms = cuda_time_ms(lambda: msev.evaluate_async(scene_idx, choices, choices >= 0), reps=3,
                            warmup=1)
    prof = profile_scene(lambda: msev.evaluate(scene_idx, choices, choices >= 0),
                         label=f"shared batch of {b} over {len(evs)} scenes") or {}
    per_leaf = prof["launches"] / b if prof.get("launches") else None
    single_per_leaf = (leaf_stats["launches"] / cfg.mcts.leaf_batch
                       if leaf_stats.get("launches") else None)
    log(f"[sweep-mcts] shared batch of {b}: {batch_ms:.2f} ms warm (CUDA events), launches "
        f"{prof.get('launches')}, {per_leaf} a leaf against [leaf]'s {leaf_stats.get('launches')} "
        f"/ {cfg.mcts.leaf_batch} = {single_per_leaf} a leaf")

    # The sweep's own MCTS mode (the JAX sweep's table pose), poses not held.
    t0 = time.perf_counter()
    swept = scene_sweep.sweep_scenes(mesh, dirs, db, cfg=cfg, seed=0, verification_mode="MCTS")
    torch.cuda.synchronize()
    sweep_mcts_s = time.perf_counter() - t0
    sweep_adds = {f"scene_{i}": {o.name: round(_adds_m(setup, o.name, o.pose_cam, gts[i][o.name],
                                                       device) * 1000, 2)
                                 for o in swept[d].objects}
                  for i, d in enumerate(dirs)}
    log(f"[sweep-mcts] sweep_scenes(MCTS), remove_table's camera-frame table pose as in the JAX "
        f"sweep: {sweep_mcts_s:.3f} s, ADD-S mm (not held) {json.dumps(sweep_adds)}")
    return {"search_s": search_s, "single_s": single_s, "stats": stats, "adds_m": adds,
            "same_as_single": same, "shared_batch": b, "shared_batch_ms": batch_ms,
            "shared_batch_launches": prof.get("launches"), "launches_per_leaf": per_leaf,
            "leaf_launches_per_leaf": single_per_leaf, "sweep_mcts_s": sweep_mcts_s,
            "sweep_mcts_adds_mm": sweep_adds}


def phase_serve(device, setup: dict, sweep_info: dict) -> dict:
    """[serve] the /pose_estimation service in a thread on a free local port,
    booted warm: boot, warm-up and first-pass-minus-second seconds; three
    sequential requests on [sweep]'s scenes, their latencies, their poses
    against a direct estimate_pose (the [sweep] bars); then with max_queue=0,
    a request in flight (an MCTS one) and a second beside it: one 200 and
    one 503 with Retry-After."""
    import threading
    import urllib.error
    import urllib.request

    from physimglobalpose_tpu_torch.config import DEFAULT_CONFIG
    from physimglobalpose_tpu_torch.pipeline import api, server

    cfg, db = DEFAULT_CONFIG, setup["db"]

    def post(url, payload):
        req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, dict(r.headers), json.loads(r.read())

    def start(srv):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return f"http://127.0.0.1:{srv.server_address[1]}"

    t0 = time.perf_counter()
    srv = server.serve(db, cfg, port=0, warm=True, device=device)
    boot_s = time.perf_counter() - t0
    url = start(srv)
    latencies, checks = [], {}
    try:
        for i, d in enumerate(sweep_info["dirs"][:3]):
            t0 = time.perf_counter()
            status, _headers, body = post(url + "/pose_estimation", {"scene_dir": d})
            latencies.append(time.perf_counter() - t0)
            if status != 200:
                fail(f"[serve] request {i} answered {status}")
            direct = api.estimate_pose(d, db, cfg=cfg, seed=0, write_result=False, device=device)
            got = [api.ObjectPoseEstimate(name=o["name"], pose_cam=np.asarray(o["pose_cam"]),
                                          pose_world=np.asarray(o["pose_world"]), score=o["score"])
                   for o in body["objects"]]
            checks[f"request_{i}"] = _check_against(f"[serve] request {i}:", got, direct.objects,
                                                    sweep_info["gts"][i], setup, device)
    finally:
        srv.shutdown()
        srv.server_close()
    log(f"[serve] boot {boot_s:.3f} s (warm-up {srv.warmup_s:.3f} s: first pass minus second "
        f"{srv.warmup_compile_s:.3f} s, second {srv.warmup_run_s:.3f} s); request latencies s "
        f"{json.dumps([round(x, 4) for x in latencies])}")

    srv = server.serve(db, cfg, port=0, max_queue=0, device=device)
    url = start(srv)
    first = {}

    def in_flight():
        first["reply"] = post(url + "/pose_estimation",
                              {"scene_dir": sweep_info["dirs"][0], "verification_mode": "MCTS"})

    thread = threading.Thread(target=in_flight)
    try:
        thread.start()
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
                if json.loads(r.read())["queue_depth"] == 1:
                    break
            time.sleep(0.005)
        else:
            fail("[serve] the first request never became in flight")
        try:
            post(url + "/pose_estimation", {"scene_dir": sweep_info["dirs"][1]})
            fail("[serve] the second request was admitted beside one in flight with max_queue=0")
        except urllib.error.HTTPError as e:
            retry = e.headers.get("Retry-After")
            if e.code != 503 or not retry or int(retry) < 1:
                fail(f"[serve] the second request got {e.code}, Retry-After {retry}")
        thread.join(timeout=300)
    finally:
        srv.shutdown()
        srv.server_close()
    if first.get("reply", (None,))[0] != 200:
        fail("[serve] the request in flight did not answer 200")
    log(f"[serve] max_queue=0: the request in flight answered 200, the one beside it 503 with "
        f"Retry-After {retry} s")
    return {"boot_s": boot_s, "warmup_s": srv.warmup_s, "first_minus_second_s": srv.warmup_compile_s,
            "warm_run_s": srv.warmup_run_s, "latencies_s": latencies, "checks": checks,
            "retry_after_s": int(retry)}



# --------------------------------------------------- the evaluation tools


SYNTH_PLAIN_SCENES = 4
SYNTH_HARD_SCENES = 2
SYNTH_ADDS_BAR = 0.01  # every plain scene's objects, LCP and MCTS mode


def write_obj_config(workdir, boxes=BOXES) -> str:
    """obj_config.yml of `boxes` (their PLYs in workdir, as scene_setup
    writes them); returns its path."""
    path = os.path.join(workdir, "obj_config.yml")
    with open(path, "w") as fh:
        fh.write(f"objects:\n  num_objects: {len(boxes)}\n  modelDiscretization: 0.01\n")
        for i, (name, cls, *_rest) in enumerate(boxes):
            fh.write(f"  object_{i + 1}:\n    name: {name}\n    classId: {cls}\n"
                     "    symmetry: [180, 180, 180]\n")
    return path


def _reset_launches() -> None:
    from physimglobalpose_tpu_torch.ops import icp, lcp

    for fn in (lcp.lcp_segside, lcp.lcp_segside_hb, lcp.lcp_stream):
        fn.launches, fn.tier_launches = 0, [0, 0, 0]
    icp.icp_corr_segside.launches = 0


def _launches(tiers: bool = False) -> dict:
    """The scoring path's kernels' launches since _reset_launches; with
    `tiers`, the lcp_segside and lcp_stream tiers' counts too."""
    from physimglobalpose_tpu_torch.ops import icp, lcp

    seg, stream = lcp.lcp_segside, lcp.lcp_stream
    out = {"lcp_segside": seg.launches}
    if tiers:
        out.update({"lcp_segside/default": seg.tier_launches[1],
                    "lcp_segside/high3": seg.tier_launches[2]})
    out.update({"lcp_segside_hb": lcp.lcp_segside_hb.launches,
                "icp_corr_segside": icp.icp_corr_segside.launches, "lcp_stream": stream.launches})
    if tiers:
        out["lcp_stream/fp32"] = stream.tier_launches[0]
    return out


def _stdout_of(fn, *args):
    """(fn(*args), what it printed), the printed text logged as it is."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    sys.stdout.write(buf.getvalue())
    sys.stdout.flush()
    return result, buf.getvalue()


def phase_synth_eval(device, workdir: str, setup: dict) -> dict:
    """[synth-eval] the port's scene generator (scripts/make_synthetic_scenes)
    writes SYNTH_PLAIN_SCENES plain and SYNTH_HARD_SCENES --hard scenes of
    BOXES at 640x480, rendered on the card; pipeline/evaluate grades them at
    the default configuration: the plain and the hard scenes in LCP mode, two
    plain scenes in MCTS mode and one with the exact EMD. Every object of a
    plain scene must come back within ADD-S 1 cm in LCP and MCTS mode; the
    hard scenes' figures are reported. Per run: ADD-S within 2 cm, mean,
    median, max, and the kernels' launches."""
    from physimglobalpose_tpu_torch.pipeline import evaluate
    from physimglobalpose_tpu_torch.scripts import make_synthetic_scenes

    obj_cfg = write_obj_config(workdir)
    base = ["--objects", ",".join(b[0] for b in BOXES), "--model-dir", workdir,
            "--obj-config", obj_cfg, "--seed", "0"]
    root = os.path.join(workdir, "synth")
    t0 = time.perf_counter()
    make_synthetic_scenes.main(["--out", os.path.join(root, "plain"), "--n",
                                str(SYNTH_PLAIN_SCENES)] + base)
    make_synthetic_scenes.main(["--out", os.path.join(root, "hard"), "--n",
                                str(SYNTH_HARD_SCENES), "--hard"] + base)
    gen_s = time.perf_counter() - t0
    plain = [os.path.join(root, "plain", f"scene_{k:04d}") for k in range(SYNTH_PLAIN_SCENES)]
    hard = [os.path.join(root, "hard", f"scene_{k:04d}") for k in range(SYNTH_HARD_SCENES)]
    log(f"[synth-eval] generated {len(plain)} plain and {len(hard)} hard scenes in {gen_s:.2f} s")

    out = {"generate_s": gen_s}
    for tag, dirs, kw in (("LCP", plain, {}), ("LCP-hard", hard, {}),
                          ("MCTS", plain[:2], {"verification_mode": "MCTS"}),
                          ("LCP-emd", plain[:1], {"emd_exact": True})):
        log_path = os.path.join(root, f"eval_{tag}.jsonl")
        _reset_launches()
        t0 = time.perf_counter()
        agg = evaluate.evaluate_scenes(dirs, setup["db"], log_path, device=device, **kw)
        wall = time.perf_counter() - t0
        launches = _launches()
        with open(log_path) as fh:
            rows = [json.loads(line) for line in fh]
        adds = {f"{os.path.basename(r['scene'])}/{name}": e["adds_m"]
                for r in rows for name, e in r["objects"].items()}
        vals = np.asarray(list(adds.values()))
        if len(vals) != len(dirs) * len(BOXES) or not np.isfinite(vals).all():
            fail(f"[synth-eval] {tag}: {len(vals)} graded objects, or a non-finite ADD-S")
        st = {"scenes": len(dirs), "wall_s": wall, "seconds": [r["seconds"] for r in rows],
              "adds_within_2cm": agg["adds_within_2cm"], "mean_adds_m": float(vals.mean()),
              "median_adds_m": float(np.median(vals)), "max_adds_m": float(vals.max()),
              "adds_m": adds, "launches": launches}
        if kw.get("emd_exact"):
            st["emd_bins"] = {f"{os.path.basename(r['scene'])}/{name}": e["emd_bins"]
                              for r in rows for name, e in r["objects"].items()}
            if not all(np.isfinite(v) and v >= 0 for v in st["emd_bins"].values()):
                fail(f"[synth-eval] {tag}: an exact EMD is not finite")
        log(f"[synth-eval] {tag}: {len(dirs)} scenes in {wall:.2f} s, ADD-S within 2 cm "
            f"{agg['adds_within_2cm']:.3f}, mean {st['mean_adds_m'] * 1000:.2f} mm, median "
            f"{st['median_adds_m'] * 1000:.2f} mm, max {st['max_adds_m'] * 1000:.2f} mm; "
            f"launches {json.dumps(launches)}"
            + (f"; exact EMD (bins) {json.dumps(st['emd_bins'])}" if "emd_bins" in st else ""))
        mm = {k: round(v * 1000, 2) for k, v in adds.items()}
        log(f"[synth-eval] {tag}: ADD-S mm {json.dumps(mm)}")
        if launches["lcp_segside"] < len(dirs) * len(BOXES):
            fail(f"[synth-eval] {tag}: lcp_segside launched {launches['lcp_segside']} times")
        if tag in ("LCP", "MCTS") and not st["max_adds_m"] < SYNTH_ADDS_BAR:
            fail(f"[synth-eval] {tag}: an object of a plain scene at ADD-S "
                 f"{st['max_adds_m'] * 1000:.2f} mm >= {SYNTH_ADDS_BAR * 1000:.0f} mm")
        out[tag] = st
    out["dirs"] = plain
    out["obj_config"] = obj_cfg
    return out


def phase_bench_tool(device) -> dict:
    """[bench-tool] scripts/bench_scoring, the port of bench.py, easy and
    clutter at H 16,384: the fidelity gates pass before its one line is
    printed (a failed gate raises), and the line's keys and hyp/s."""
    from physimglobalpose_tpu_torch.scripts import bench_scoring

    out = {}
    for variant in ("easy", "clutter"):
        _reset_launches()
        t0 = time.perf_counter()
        rc, printed = _stdout_of(bench_scoring.main, ["--variant", variant])
        wall = time.perf_counter() - t0
        launches = _launches()
        line = json.loads(printed.strip().splitlines()[-1])
        keys = ["metric", "value", "unit", "vs_baseline"]
        if rc != 0 or list(line) != keys or not line["value"] > 0:
            fail(f"[bench-tool] {variant}: exit {rc}, line {line}")
        if min(launches[k] for k in ("lcp_segside", "lcp_segside_hb", "icp_corr_segside")) < 1:
            fail(f"[bench-tool] {variant}: a kernel of the scoring path was not launched")
        log(f"[bench-tool] {variant}: {line['value']:.1f} hyp/s ({line['vs_baseline']}x the C++ "
            f"baseline) after the gates; the tool's run {wall:.2f} s, launches "
            f"{json.dumps(launches)}")
        out[variant] = {"line": line, "wall_s": wall, "launches": launches}
    return out


def _grade_world(tag, scene_dir: str, poses: dict, setup: dict, device) -> dict:
    """ADD-S (m) by name of world poses against the scene's gt_info.yml; fails
    unless every object of the scene is there within SYNTH_ADDS_BAR."""
    from physimglobalpose_tpu_torch.geometry import metrics
    from physimglobalpose_tpu_torch.pipeline import scene as scene_mod

    gt = scene_mod.load_scene(scene_dir, load_color=False).gt_poses
    if sorted(poses) != sorted(gt):
        fail(f"{tag} objects {sorted(poses)}, the scene has {sorted(gt)}")
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    adds = {n: float(metrics.adds_error(as_t(p), as_t(gt[n]),
                                        as_t(setup["objects"][n].validation_pts)))
            for n, p in poses.items()}
    if not max(adds.values()) < SYNTH_ADDS_BAR:
        fail(f"{tag} ADD-S mm {json.dumps({n: round(v * 1000, 2) for n, v in adds.items()})}: "
             f"an object at or past {SYNTH_ADDS_BAR * 1000:.0f} mm")
    return adds


def phase_whole_scene(device, workdir: str, synth: dict, setup: dict) -> dict:
    """[whole-scene] scripts/whole_scene_bench on the first plain scene of
    [synth-eval] (the tool's configuration, the small preset): repeat 2, 4
    sweep copies, the "small" FCN row; the MCTS rows are left to
    [synth-eval]'s MCTS grading. The GT-segmentation LCP row's poses must be
    within ADD-S SYNTH_ADDS_BAR of the scene's truth. The FCN row's poses
    are reported beside the LCP row's, not held: the shipped networks were
    trained on renders of the reference's meshes, not on these boxes
    ([e2e-neural] holds the networks' images on the card to the CPU's)."""
    from physimglobalpose_tpu_torch.scripts import whole_scene_bench

    out_path = os.path.join(workdir, "whole_scene_bench.json")
    _reset_launches()
    t0 = time.perf_counter()
    got, _ = _stdout_of(whole_scene_bench.main, [
        "--scene", synth["dirs"][0], "--model-dir", workdir, "--obj-config", synth["obj_config"],
        "--repeat", "2", "--sweep-scenes", "4", "--skip-mcts", "--fcn-variants", "small",
        "--out", out_path])
    wall = time.perf_counter() - t0
    launches = _launches()
    keys = ("lcp_seconds_per_scene_warm", "lcp_sweep_scenes_per_sec",
            "lcp_sweep_pipelined2_scenes_per_sec", "lcp_sweep_pipelined4_scenes_per_sec",
            "fcn_small_lcp_seconds_per_scene_warm", "fcn_small_predictor_seconds_per_scene")
    if any(not got.get(k, 0) > 0 for k in keys) or launches["lcp_segside"] < 1:
        fail(f"[whole-scene] a row is missing or not positive, or no lcp_segside launch: "
             f"{json.dumps(got)}")
    adds = _grade_world("[whole-scene] serial LCP:", synth["dirs"][0], got["lcp_pose_world"],
                        setup, device)
    log(f"[whole-scene] {json.dumps({k: got[k] for k in keys})}; the tool's run {wall:.2f} s, "
        f"launches {json.dumps(launches)}; serial LCP ADD-S mm "
        f"{json.dumps({n: round(v * 1000, 2) for n, v in adds.items()})}; FCN row against it "
        f"(not held) {json.dumps(got['fcn_small_vs_golden_pose'])}")
    return {**{k: got[k] for k in keys}, "wall_s": wall, "launches": launches,
            "lcp_adds_m": adds, "fcn_small_vs_golden_pose": got["fcn_small_vs_golden_pose"]}


def phase_loadtest(device, workdir: str, synth: dict, setup: dict) -> dict:
    """[loadtest] scripts/server_loadtest on the first plain scene of
    [synth-eval]: 4 clients, 12 requests, max_queue 1 (req/s, latency
    percentiles, queue depth on arrival, 503s and Retry-After), then one
    warm boot measured in a fresh process. The last answer under load must
    put every object within ADD-S SYNTH_ADDS_BAR of the scene's truth."""
    from physimglobalpose_tpu_torch.scripts import server_loadtest

    out_path = os.path.join(workdir, "server_loadtest.json")
    flags = ["--scene", synth["dirs"][0], "--model-dir", workdir, "--obj-config",
             synth["obj_config"], "--out", out_path]
    _reset_launches()
    rc, _ = _stdout_of(server_loadtest.main, ["--clients", "4", "--requests", "12",
                                              "--max-queue", "1"] + flags)
    launches = _launches()
    rc_boot, _ = _stdout_of(server_loadtest.main, ["--phase", "measure-boots"] + flags)
    with open(out_path) as fh:
        report = json.load(fh)["cuda"]
    if (rc != 0 or rc_boot != 0 or report["errors"] or report["completed"] < 12
            or launches["lcp_segside"] < 1):
        fail(f"[loadtest] exit {rc} / {rc_boot}: {json.dumps(report)}")
    adds = _grade_world("[loadtest] the last answer:", synth["dirs"][0],
                        report["response_pose_world"], setup, device)
    keys = ("requests_per_sec", "latency_s", "queue_depth_on_arrival", "shed_503",
            "warm_compile_s")
    log(f"[loadtest] {json.dumps({k: report[k] for k in keys})}; warm boot "
        f"{json.dumps(report['warm_boots']['boot1'])}; launches {json.dumps(launches)}; the "
        f"last answer's ADD-S mm {json.dumps({n: round(v * 1000, 2) for n, v in adds.items()})}")
    return {**{k: report[k] for k in keys}, "warm_boot": report["warm_boots"]["boot1"],
            "launches": launches, "answer_adds_m": adds}


def phase_fcn_eval(device, workdir: str, synth: dict) -> dict:
    """[fcn-eval] scripts/eval_fcn_checkpoints on held-out renders of BOXES:
    every checkpoint the JAX script evaluates that ships, plain and
    domain-randomized, at both serving scales."""
    from physimglobalpose_tpu_torch.scripts import eval_fcn_checkpoints

    t0 = time.perf_counter()
    results, _ = _stdout_of(eval_fcn_checkpoints.main, [
        "--model-dir", workdir, "--obj-config", synth["obj_config"], "--objects",
        ",".join(b[0] for b in BOXES)])
    wall = time.perf_counter() - t0
    vals = [v for r in results.values() for sc in r["miou"].values() for v in sc.values()]
    if not results or not all(0.0 <= v <= 1.0 for v in vals):
        fail(f"[fcn-eval] {json.dumps(results)}")
    log(f"[fcn-eval] {json.dumps(results)} in {wall:.2f} s")
    return {"checkpoints": results, "wall_s": wall}



# ------------------------------------------- the accuracy families ([hard-eval])


HARD_SCENES = 8  # r4_hard_eval's default
FAMILY_SCENES = 2
# [hard-eval] six: BOXES and three objects of other shapes and sizes (no two
# equal boxes with coincident faces: the PBD contact's blind spot).
SIX_EXTRA = (("ellipsoid", 4), ("cylinder", 5), ("slab", 6))
# [hard-eval] ycb: BOXES' sizes under the hard_ycb family's names and their
# class ids in the reference's obj_config_ycb.yml.
YCB_BOXES = (("003_cracker_box", 2), ("005_tomato_soup_can", 4), ("006_mustard_bottle", 5))
SECTION_KEYS = {"generator", "scenes", "instances", "backend", "timestamp"}
FAMILY_KEYS = {"hard": {"occlusion_frac", "corruption"},
               "hard_six": {"segmentation", "occlusion_frac"},
               "hard_ycb": {"segmentation", "occlusion_frac"},
               "rcnn": {"segmentation", "detection"}}
MODE_KEYS = {"adds_within_2cm", "mean_adds_m", "max_adds_m", "per_object_mean_adds_m", "wall_s",
             "worst3"}
MISS_KEYS = {"eval_adds_m", "segment_points", "lcp_pose_folded", "branch_set_adds_m",
             "final3_from_chosen", "final3_from_gt", "verdict_hint"}


def _graded_adds(log_path: str) -> dict:
    with open(log_path) as fh:
        rows = [json.loads(line) for line in fh]
    return {f"{os.path.basename(r['scene'])}/{name}": e.get("adds_m", float("nan"))
            for r in rows for name, e in r["objects"].items()}


def phase_hard_eval(device, workdir: str) -> dict:
    """[hard-eval] the accuracy tools (scripts/r4_hard_eval, r5_eval,
    r5_hard_miss_analysis) through main(argv), one mode a call, at the small
    preset and 640x480, on procedural meshes: the hard family (HARD_SCENES
    --hard scenes of BOXES) in LCP, MCTS and GREEDY mode; hard_six
    (FAMILY_SCENES --hard scenes of BOXES and SIX_EXTRA) and hard_ycb (BOXES
    as YCB_BOXES, plain-mm depth) in LCP and MCTS mode; rcnn (FAMILY_SCENES
    plain scenes, the shipped detector) in LCP mode; then the miss analysis
    of the hard family's MCTS log, over 2 cm or, where nothing misses by 2 cm,
    just below the worst ADD-S. Fails where an object is not graded or its
    ADD-S is not finite, lcp_segside launched fewer times than scenes x
    objects, lcp_stream launched, a section lacks a key of the JAX section, or
    the miss analysis's joint-substitution costs on the card and on the CPU
    differ by more than TOL_LEAF_COST. The figures are reported, not held."""
    from physimglobalpose_tpu_torch.config import PRESETS
    from physimglobalpose_tpu_torch.scripts import r4_hard_eval, r5_eval
    from physimglobalpose_tpu_torch.scripts import r5_hard_miss_analysis as miss

    root = os.path.join(workdir, "hard_eval")
    out_path = os.path.join(root, "synth_eval.json")
    six_dir, ycb_dir = os.path.join(root, "six_meshes"), os.path.join(root, "ycb_meshes")
    os.makedirs(six_dir)
    os.makedirs(ycb_dir)
    for name, _cls, size, *_rest in BOXES:
        write_box_ply(os.path.join(six_dir, f"{name}.ply"), size)
    write_mesh_ply(os.path.join(six_dir, "ellipsoid.ply"), *ellipsoid_mesh((0.05, 0.035, 0.03)))
    write_mesh_ply(os.path.join(six_dir, "cylinder.ply"), *cylinder_mesh(0.03, 0.11))
    write_box_ply(os.path.join(six_dir, "slab.ply"), (0.14, 0.09, 0.02))
    six = [b[:2] for b in BOXES] + list(SIX_EXTRA)
    for (name, _cls), box in zip(YCB_BOXES, BOXES):
        write_box_ply(os.path.join(ycb_dir, f"{name}.ply"), box[2])
    box_cfg = write_obj_config(workdir)  # BOXES' PLYs, written by scene_setup
    boxes = ",".join(b[0] for b in BOXES)
    hard_dir = os.path.join(root, "hard")

    def flags(family, meshes, obj_cfg, objects, n):
        return ((["--family", family] if family != "hard" else [])
                + ["--dir", os.path.join(root, family), "--scenes", str(n), "--model-dir", meshes,
                   "--obj-config", obj_cfg, "--out", out_path]
                + (["--objects", objects] if objects else []))

    families = (  # (section, tool, argv, scenes, objects, modes, log name)
        ("hard", r4_hard_eval.main, flags("hard", workdir, box_cfg, boxes, HARD_SCENES),
         HARD_SCENES, len(BOXES), ("LCP", "MCTS", "GREEDY"), "hard_eval_{}_0.jsonl"),
        ("hard_six", r5_eval.main,
         flags("hard_six", six_dir, write_obj_config(six_dir, six), ",".join(n for n, _ in six),
               FAMILY_SCENES), FAMILY_SCENES, len(six), ("LCP", "MCTS"),
         "r5_eval_hard_six_{}_0.jsonl"),
        ("hard_ycb", r5_eval.main,  # the family's own object names
         flags("hard_ycb", ycb_dir, write_obj_config(ycb_dir, YCB_BOXES), None, FAMILY_SCENES),
         FAMILY_SCENES, len(YCB_BOXES), ("LCP", "MCTS"), "r5_eval_hard_ycb_{}_0.jsonl"),
        ("rcnn", r5_eval.main, flags("rcnn", workdir, box_cfg, boxes, FAMILY_SCENES),
         FAMILY_SCENES, len(BOXES), ("LCP",), "r5_eval_rcnn_{}_0.jsonl"),
    )
    out = {}
    for family, tool, argv, n_scenes, n_obj, modes, log_name in families:
        for mode in modes:
            _reset_launches()
            t0 = time.perf_counter()
            rc, _ = _stdout_of(tool, argv + ["--modes", mode])
            wall = time.perf_counter() - t0
            launches = _launches()
            adds = _graded_adds(os.path.join(root, family, log_name.format(mode)))
            vals = np.asarray(list(adds.values()))
            with open(out_path) as fh:
                st = json.load(fh)[family][mode]
            tag = f"[hard-eval] {family} {mode}"
            if rc != 0 or len(vals) != n_scenes * n_obj or not np.isfinite(vals).all():
                fail(f"{tag}: exit {rc}, {len(vals)} graded objects of {n_scenes * n_obj}, or a "
                     f"non-finite ADD-S: {json.dumps(adds)}")
            if launches["lcp_segside"] < n_scenes * n_obj or launches["lcp_stream"] != 0:
                fail(f"{tag}: launches {json.dumps(launches)}")
            log(f"{tag}: {n_scenes} scenes in {wall:.2f} s (the section's wall_s {st['wall_s']}), "
                f"ADD-S within 2 cm {st['adds_within_2cm']:.3f}, mean "
                f"{st['mean_adds_m'] * 1000:.2f} mm, max {st['max_adds_m'] * 1000:.2f} mm; "
                f"launches {json.dumps(launches)}")
            log(f"{tag}: ADD-S mm {json.dumps({k: round(v * 1000, 2) for k, v in adds.items()})}")
            out[f"{family}/{mode}"] = {"scenes": n_scenes, "objects": n_obj, "wall_s": wall,
                                       **{k: st[k] for k in MODE_KEYS}, "launches": launches}
        with open(out_path) as fh:
            section = json.load(fh)[family]
        want = SECTION_KEYS | FAMILY_KEYS[family] | set(modes)
        if not want <= set(section) or any(not MODE_KEYS <= set(section[m]) for m in modes):
            fail(f"[hard-eval] {family}: the section lacks a key of the JAX section: "
                 f"{sorted(want - set(section))}")
        out[family] = {k: section[k] for k in ("occlusion_frac", "detection", "backend")
                       if k in section}
        log(f"[hard-eval] {family}: {json.dumps(out[family])}")
    det = out["rcnn"]["detection"]
    if not {"instances", "mean_box_iou", "recall_at_0.5", "missed"} <= set(det):
        fail(f"[hard-eval] rcnn: detection {det}")
    log(f"[hard-eval] rcnn: the shipped detector (trained on renders of the reference's meshes, "
        f"not on these boxes): {json.dumps(det)}")

    # The miss analysis on the hard family's MCTS log; its joint-substitution
    # costs once more on the CPU, from the same poses.
    mcts_log = os.path.join(hard_dir, "hard_eval_MCTS_0.jsonl")
    worst = max(_graded_adds(mcts_log).values())
    threshold = 0.02 if worst > 0.02 else float(np.nextafter(worst, 0.0))
    miss_out = os.path.join(root, "hard_miss_analysis.json")
    recorded = []
    substitution_costs = miss.substitution_costs

    def recording(inputs, cfg, device=None):
        costs = substitution_costs(inputs, cfg, device)
        recorded.append((inputs, costs))
        return costs

    miss.substitution_costs = recording
    _reset_launches()
    t0 = time.perf_counter()
    try:
        rc, _ = _stdout_of(miss.main, ["--dir", hard_dir, "--log", mcts_log, "--threshold",
                                       repr(threshold), "--model-dir", workdir, "--obj-config",
                                       box_cfg, "--objects", boxes, "--out", miss_out])
    finally:
        miss.substitution_costs = substitution_costs
    wall = time.perf_counter() - t0
    launches = _launches()
    with open(miss_out) as fh:
        report = json.load(fh)
    analysed = {k: v for k, v in report.items()
                if k != "meta" and not k.endswith("/joint_cost_substitution")}
    scenes = {k.split("/")[0] for k in analysed}
    subs = {k: v for k, v in report.items() if k.endswith("/joint_cost_substitution")}
    if (rc != 0 or not analysed or any(not MISS_KEYS <= set(v) for v in analysed.values())
            or len(subs) != len(scenes) or len(recorded) != len(scenes)):
        fail(f"[hard-eval] miss: exit {rc}, {len(analysed)} analysed, {len(subs)} substitutions "
             f"({len(recorded)} recorded) for {len(scenes)} scenes")
    if launches["lcp_segside"] < (len(analysed) + len(scenes)) * len(BOXES) or launches[
            "lcp_stream"] != 0:
        fail(f"[hard-eval] miss: launches {json.dumps(launches)}")
    cfg = PRESETS["small"]
    cpu_err = 0.0
    for inputs, card in recorded:
        cpu = substitution_costs(inputs, cfg, "cpu")
        for scale, costs in card.items():
            for label, cost in costs.items():
                cpu_err = max(cpu_err, abs(cost - cpu[scale][label]))
    if cpu_err > TOL_LEAF_COST:
        fail(f"[hard-eval] miss: joint-substitution costs on the card and the CPU differ by "
             f"{cpu_err} px > {TOL_LEAF_COST}")
    log(f"[hard-eval] miss: threshold {threshold * 1000:.3f} mm, {len(analysed)} analysed in "
        f"{wall:.2f} s, verdicts {json.dumps({k: v['verdict_hint'] for k, v in analysed.items()})}; "
        f"joint substitution {json.dumps(subs)}; card against CPU max {cpu_err} px; launches "
        f"{json.dumps(launches)}")
    out["miss"] = {"threshold_m": threshold, "wall_s": wall, "analysed": analysed,
                   "joint_cost_substitution": subs, "cpu_max_abs_err_px": cpu_err,
                   "launches": launches}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (fp32 setup)

    device = torch.device("cuda")
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    empty_ms = phase_empty_launch(device)
    lcp_stats = phase_lcp(device)
    tier_stats = phase_lcp_tiers(device)
    hb_stats = phase_lcp_hb(device)
    icp_stats = phase_icp(device)
    stream_stats = phase_lcp_stream(device)
    wide_stats, wide_launches = phase_lcp_wide(device)
    icp_stream_stats, icp_stream_launches = phase_icp_stream(device)
    with tempfile.TemporaryDirectory() as workdir:
        from physimglobalpose_tpu_torch import runtime

        runtime_stats = phase_runtime(workdir)
        runtime.load_mesh_native.calls = runtime.build_ppf_native.calls = 0
        setup = scene_setup(device, workdir)
        native = {"load_mesh": runtime.load_mesh_native.calls,
                  "build_ppf": runtime.build_ppf_native.calls}
        log(f"[runtime] the scene's asset preparation went through the native runtime: {native}")
        if min(native.values()) < len(BOXES):
            fail(f"[runtime] the assets of {len(BOXES)} objects made native calls {native}")
        runtime_stats["scene_native_calls"] = native
        trace_stats = phase_trace(device, workdir, setup)
        _timings, launches = phase_e2e(device, workdir, setup)
        _timings, large_launches = phase_e2e(device, workdir, setup, large=True)
        leaf_stats = phase_leaf(device, setup)
        mcts_stats = phase_search(device, workdir, setup, "MCTS")
        greedy_stats = phase_search(device, workdir, setup, "GREEDY")
        debug_stats = phase_debug(device, workdir, setup)
        fcn_stats = phase_fcn(device, setup)
        detect_stats = phase_detect(device, setup)
        modes_stats = phase_modes(device, workdir, setup)
        neural_stats = phase_neural(device, workdir, setup)
        sweep_stats = phase_sweep(device, workdir, setup)
        sweep_mcts_stats = phase_sweep_mcts(device, setup, sweep_stats, leaf_stats)
        serve_stats = phase_serve(device, setup, sweep_stats)
        train_stats = {"fcn": phase_train(device, workdir, "fcn"),
                       "detect": phase_train(device, workdir, "detect")}
        _scoring_stats, scoring_launches = phase_scoring(device)
        _scoring_stats, scoring_large_launches = phase_scoring(device, large=True)
        # The tools last: [scoring]'s profiled spans come before their launches
        # (the profiler loses device spans in a process that has made many).
        phase_times = {}

        def timed(key, phase, *args):
            t0 = time.perf_counter()
            result = phase(*args)
            phase_times[key] = time.perf_counter() - t0
            return result

        synth_stats = timed("synth", phase_synth_eval, device, workdir, setup)
        bench_tool_stats = timed("bench", phase_bench_tool, device)
        whole_scene_stats = timed("whole", phase_whole_scene, device, workdir, synth_stats, setup)
        loadtest_stats = timed("loadtest", phase_loadtest, device, workdir, synth_stats, setup)
        fcn_eval_stats = timed("fcn_eval", phase_fcn_eval, device, workdir, synth_stats)
        hard_eval_stats = timed("hard_eval", phase_hard_eval, device, workdir)

    lcp_src = "physimglobalpose_tpu_torch/csrc/lcp_segside.cu"
    stream_src = "physimglobalpose_tpu_torch/csrc/lcp_stream.cu"

    def entry(name, source, replaces, tpu_kernel, n_launches, st, library_ms=None, **extra):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "tpu_kernel": tpu_kernel, "launches": n_launches,
            "max_abs_err": st["max_abs_err"], "ms": st["ms"], "kernel_ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"], "bound_by": "operations",
            "share_of_bound": st["bound_ms"] / st["ms"], "library_ms": library_ms,
            # A bound of a few microseconds is no attainable target: the share
            # against the larger of the bound and an empty launch.
            "empty_launch_ms": empty_ms,
            "share_of_bound_or_launch": max(st["bound_ms"], empty_ms) / st["ms"],
            # The same work on the CUDA cores alone (equal to bound_ms for fp32).
            "cuda_core_bound_ms": st.get("cuda_core_bound_ms", st["bound_ms"]),
            **extra,
        }

    kernels = [
        entry("lcp_segside", lcp_src, "physimglobalpose_tpu/ops/lcp.py:420",
              "ops/lcp.py::_lcp_kernel_segside (fp32 tier)", launches["lcp_segside"], lcp_stats,
              unweighted_ms=lcp_stats["unweighted_ms"],
              # ms is the kernel alone; the same call through lcp_scores, with
              # the centring and the packing:
              lcp_scores_ms=lcp_stats["lcp_scores_ms"],
              # The LCP stage ahead of the searches launches it too.
              launches_mcts=mcts_stats["lcp_segside_launches"],
              launches_greedy=greedy_stats["lcp_segside_launches"],
              # The other hypothesis modes' LCP stage, one launch an object.
              launches_modes={m: st["lcp_segside_launches"] for m, st in modes_stats.items()},
              # The multi-scene sweep's job batch, one launch a job.
              launches_sweep=sweep_stats["lcp_segside_launches"],
              # The scene under device_trace, and the MCTS scene with debug_dir.
              launches_trace=trace_stats["launches"], launches_debug=debug_stats["launches"],
              # The evaluation tools: the generator's scenes graded (LCP,
              # hard, MCTS, EMD), the whole-scene bench, the load test.
              launches_synth_eval={t: synth_stats[t]["launches"]["lcp_segside"]
                                   for t in ("LCP", "LCP-hard", "MCTS", "LCP-emd")},
              launches_whole_scene=whole_scene_stats["launches"]["lcp_segside"],
              launches_loadtest=loadtest_stats["launches"]["lcp_segside"]),
        entry("lcp_segside/default", lcp_src, "physimglobalpose_tpu/ops/lcp.py:420",
              "ops/lcp.py::_lcp_kernel_segside (default tier)",
              scoring_launches["lcp_segside/default"], tier_stats["default"],
              launches_large=scoring_large_launches["lcp_segside/default"],
              unweighted_ms=tier_stats["default"]["unweighted_ms"],
              coarse_ns1024=hb_stats["coarse_ns1024"]),
        entry("lcp_segside/high3", lcp_src, "physimglobalpose_tpu/ops/lcp.py:420",
              "ops/lcp.py::_lcp_kernel_segside (high3 tier)",
              scoring_launches["lcp_segside/high3"], tier_stats["high3"],
              unweighted_ms=tier_stats["high3"]["unweighted_ms"]),
        entry("lcp_segside_hb", lcp_src, "physimglobalpose_tpu/ops/lcp.py:543",
              "ops/lcp.py::_lcp_kernel_segside_hb", scoring_launches["lcp_segside_hb"], hb_stats,
              library_ms=hb_stats["library_ms"],
              launches_bench_tool={v: st["launches"]["lcp_segside_hb"]
                                   for v, st in bench_tool_stats.items()},
              **{k: hb_stats[k] for k in (
                  "shape", "weighted_ms", "device_ms", "band_share", "cuda_cores_ms",
                  "cuda_cores_device_ms", "lcp_segside_tensor_cores_ms", "fp32_ms",
                  "registers")}),
        # ms: H 256 x Nm 512 x Ns 512 ([scoring]); ns2048: the pass [scoring-large]
        # launches icp_iters times a call.
        entry("icp_corr_segside", "physimglobalpose_tpu_torch/csrc/icp_corr_segside.cu",
              "physimglobalpose_tpu/ops/icp.py:273", "ops/icp.py::_icp_corr_kernel_segside",
              scoring_launches["icp_corr_segside"], icp_stats,
              launches_bench_tool={v: st["launches"]["icp_corr_segside"]
                                   for v, st in bench_tool_stats.items()},
              shape=icp_stats["shape"], device_ms=icp_stats["device_ms"],
              fp32_ms=icp_stats["fp32_ms"],
              ns2048={**icp_stats["ns2048"],
                      "launches": scoring_large_launches["icp_corr_segside"]}),
        # Launches: one call of the scoring path on 4,096-point segments (its
        # exact tier); the large-segment scene adds one per object.
        entry("lcp_stream", stream_src, "physimglobalpose_tpu/ops/lcp.py:99",
              "ops/lcp.py::_lcp_kernel", scoring_large_launches["lcp_stream/fp32"], stream_stats,
              launches_scene=large_launches["lcp_stream"],
              **{k: stream_stats[k] for k in (
                  "shape", "scene_shape", "scene_ms", "scene_bound_ms", "cdist_yardstick_ms",
                  "unweighted_ms", "default_ms", "scene_unweighted_ms", "scene_default_ms")}),
        entry("icp_corr_stream", "physimglobalpose_tpu_torch/csrc/icp_corr_stream.cu",
              "physimglobalpose_tpu/ops/icp.py:569", "ops/icp.py::_icp_corr_kernel",
              icp_stream_launches, icp_stream_stats,
              **{k: icp_stream_stats[k] for k in (
                  "shape", "device_ms", "pass_device_ms", "cdist_yardstick_ms", "registers")}),
        entry("lcp_stream_wide", stream_src, "scripts/lcp_wide_kernel_experiment.py:42",
              "scripts/lcp_wide_kernel_experiment.py::_lcp_kernel_wide", wide_launches,
              wide_stats, **{k: wide_stats[k] for k in (
                  "shape", "cdist_yardstick_ms", "device_ms", "default_ms", "unweighted_ms",
                  "registers")}),
    ]
    for k in kernels:
        if k["launches"] <= 0:
            fail(f"kernel {k['name']} was not launched on its main path")
    log("[search] " + json.dumps({"leaf": leaf_stats, "mcts": mcts_stats, "greedy": greedy_stats}))
    log("[modes] " + json.dumps({"fcn": fcn_stats, "detect": detect_stats, "e2e_modes": modes_stats,
                                 "e2e_neural": neural_stats}))
    log("[sweeps] " + json.dumps({"sweep": {k: v for k, v in sweep_stats.items()
                                            if k not in ("dirs", "gts")},
                                  "sweep_mcts": sweep_mcts_stats, "serve": serve_stats}))
    log("[port-finish] " + json.dumps({"runtime": runtime_stats, "trace": trace_stats,
                                       "debug": debug_stats, "train": train_stats}))
    log("[tools] " + json.dumps({"synth_eval": {k: v for k, v in synth_stats.items()
                                                if k not in ("dirs", "obj_config")},
                                 "bench_tool": bench_tool_stats, "whole_scene": whole_scene_stats,
                                 "loadtest": loadtest_stats, "fcn_eval": fcn_eval_stats}))
    log("[hard-eval] " + json.dumps(hard_eval_stats))
    log(f"[phase-times] {json.dumps(phase_times)}")
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
