"""Time the LCP and ICP kernels of this tree against another revision's on
one card.

    git archive <revision> physimglobalpose_tpu_torch/csrc | tar -x -C build/other
    python3 tools/compare_lcp_kernels.py \
        --other-csrc build/other/physimglobalpose_tpu_torch/csrc [--out FILE.json] \
        [--sections lcp hb wide icp icp-stream units]

Builds lcp_segside.cu, lcp_stream.cu, icp_corr_segside.cu and
icp_corr_stream.cu of both trees with the package's nvcc flags and calls
their C launchers on the same
tensors, at the shapes of PERF.md's kernel table, timing each pair in turns
(other, this, this, other; CUDA events, median; the kernels' device time from
torch.profiler beside it). Sections:
  lcp    lcp_segside and lcp_stream, scores within 2 / Nv of the other tree's;
  hb     lcp_segside_hb at the coarse shape of a scoring call and others, and
         on kernel_inputs.band_inputs with delta^2 on a row's nearest d2 and
         one float32 step to either side, weighted and unweighted, both tiers:
         unweighted scores bit for bit the other tree's (the terms are 0 or 1,
         so no sum order moves them), weighted within 1e-6;
  wide   lcp_stream_wide at the coarse shape of the yardstick pipeline on
         4,096-point segments (H 16,384, Nv 512) and two ragged shapes, both
         tiers: the same rule as hb;
  icp    icp_corr_segside at the ICP shapes of both scoring calls, both tiers:
         (A, b) within 1e-6 of the other tree's, relative to the largest entry;
  icp-stream  icp_corr_stream at H 256 and 32 x Nm 1,024 x Ns 4,096 (tile
         256) and on kernel_inputs.icp_tie_inputs (tiles 37, 100, 256; tile
         512 on lattices of 1,000 and 4,096 points): the same rule as icp (the
         matches must agree; the order of the sums over segment points may
         differ); device times of the scan kernel and of the pass (the scan's
         mean span plus the finishing kernel's, chip_smoke.kernel_means_ms);
         at the first two shapes also this tree's streamed variant against
         its staged one;
  units  this tree's unweighted lcp_segside on its two units, the CUDA cores
         and the tensor-core filter, over a grid of lowered-tier shapes: what
         the launcher's routing rule rests on.
The inputs are physimglobalpose_tpu_torch/kernel_inputs.py's, the timers
chip_smoke.py's; a device time is null where the profiler dropped spans
(chip_smoke.device_ms), but for icp-stream's (the mean of each kernel's kept
spans).
Prints one line per case and a JSON summary; exits non-zero when a check
above fails. Two revisions are compared inside one run only: two runs may
land on cards with other power limits.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # the repository root

import chip_smoke  # noqa: E402  (the timers)
from physimglobalpose_tpu_torch import _build, kernel_inputs  # noqa: E402
from physimglobalpose_tpu_torch.ops import icp, lcp  # noqa: E402

_COMMON = [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
_STREAM_COMMON = [ctypes.c_int] * 4 + _COMMON[3:]


def build_other(csrc: Path, name: str) -> ctypes.CDLL:
    src = csrc / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = _build.BUILD_DIR / f"libother_{name}_{digest}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                       check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


class Kernels:
    """The LCP and ICP launchers of one tree behind one calling convention."""

    def __init__(self, segside: ctypes.CDLL, stream: ctypes.CDLL, icp_lib: ctypes.CDLL,
                 icp_stream: ctypes.CDLL):
        self.segside, self.stream, self.icp, self.icp_stream = segside, stream, icp_lib, icp_stream
        # A tree whose lcp_segside sums model tiles takes a workspace before `out`.
        self.tiled = hasattr(segside, "lcp_segside_workspace_tiles")
        segside.lcp_segside_launch.argtypes = [ctypes.c_void_p] * (6 if self.tiled else 5) + _COMMON
        segside.lcp_segside_hb_launch.argtypes = [ctypes.c_void_p] * 5 + _COMMON
        for fn in (stream.lcp_stream_launch, stream.lcp_stream_wide_launch):
            fn.argtypes = [ctypes.c_void_p] * 6 + _STREAM_COMMON
        icp_lib.icp_corr_segside_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        for name in ("icp_corr_stream_launch", "icp_corr_stream_launch_streamed"):
            if hasattr(icp_stream, name):
                getattr(icp_stream, name).argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
                    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]

    def run_icp_stream(self, tr12, seg4, mpts, mnrm, nm_tile: int, max_corr: float = 0.02,
                       streamed: bool = False):
        """streamed: the kernel's streamed variant at any size (this tree only)."""
        h, ns, nm = tr12.shape[0], seg4.shape[0], mpts.shape[0]
        out = torch.empty((h, 42), dtype=torch.float32, device=tr12.device)
        # A row of 27 sums per 128 segment points covers either tree's workspace.
        partial = torch.empty((h, -(-ns // 128), 27), dtype=torch.float32, device=tr12.device)
        launch = (self.icp_stream.icp_corr_stream_launch_streamed if streamed
                  else self.icp_stream.icp_corr_stream_launch)
        rc = launch(
            tr12.data_ptr(), seg4.data_ptr(), mpts.data_ptr(), mnrm.data_ptr(),
            partial.data_ptr(), out.data_ptr(), h, ns, nm, min(nm_tile, nm), max_corr * max_corr,
            2.0 * (max_corr * 0.5) ** 2, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"icp_corr_stream launch failed with CUDA error {rc}")
        return out

    def run_icp(self, tr12, seg4, mpts, mnrm, tier: int, max_corr: float = 0.02):
        h, ns, nm = tr12.shape[0], seg4.shape[0], mpts.shape[0]
        out = torch.empty((h, 42), dtype=torch.float32, device=tr12.device)
        rc = self.icp.icp_corr_segside_launch(
            tr12.data_ptr(), seg4.data_ptr(), mpts.data_ptr(), mnrm.data_ptr(), out.data_ptr(),
            h, ns, nm, max_corr * max_corr, 2.0 * (max_corr * 0.5) ** 2, tier,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"icp_corr_segside launch failed with CUDA error {rc}")
        return out

    def run(self, kernel: str, packed, weighted: bool, tier: int, ns_tile: int = 0):
        tr12, mpts, mnrm, segcat, delta2, cos_gate = packed
        h, nv, ns = tr12.shape[0], mpts.shape[0], segcat.shape[0]
        out = torch.empty(h, dtype=torch.float32, device=tr12.device)
        ptrs = [t.data_ptr() for t in (tr12, mpts, mnrm, segcat)]
        stream = torch.cuda.current_stream().cuda_stream
        tail = (delta2, cos_gate, int(weighted), tier, stream)
        if kernel in ("lcp_stream", "lcp_stream_wide"):
            # The smallest model tile either tree's kernel takes sizes the workspace.
            tile = 1024 if kernel == "lcp_stream" else 256
            partial = torch.empty((h, -(-nv // tile)), dtype=torch.float32, device=out.device)
            rc = getattr(self.stream, kernel + "_launch")(
                *ptrs, partial.data_ptr(), out.data_ptr(), h, nv, ns, ns_tile, *tail)
        elif kernel == "lcp_segside" and self.tiled:
            tiles = self.segside.lcp_segside_workspace_tiles(nv)
            partial = torch.empty((h, tiles), dtype=torch.float32, device=out.device)
            rc = self.segside.lcp_segside_launch(
                *ptrs, partial.data_ptr(), out.data_ptr(), h, nv, ns, *tail)
        else:
            rc = getattr(self.segside, kernel + "_launch")(*ptrs, out.data_ptr(), h, nv, ns, *tail)
        if rc != 0:
            raise RuntimeError(f"{kernel} launch failed with CUDA error {rc}")
        return out


# (kernel, label, H, Nv, Ns, weighted, tier, ns_tile, repetitions)
TIMED = (
    ("lcp_segside", "scene", 10_000, 4096, 1024, True, None, 0, 5),
    ("lcp_segside", "scene", 10_000, 4096, 1024, False, None, 0, 5),
    ("lcp_segside", "bulk_fine", 256, 4096, 256, True, "default", 0, 20),
    ("lcp_segside", "bulk_fine", 256, 4096, 256, True, None, 0, 20),
    ("lcp_segside", "bulk_fine", 256, 4096, 256, True, "high3", 0, 20),
    ("lcp_segside", "exact", 32, 4096, 1024, True, "high3", 0, 20),
    ("lcp_segside", "exact", 32, 4096, 1024, True, None, 0, 20),
    ("lcp_segside", "exact", 32, 4096, 1024, True, "default", 0, 20),
    ("lcp_segside", "coarse_ns1024", 16_384, 256, 1024, False, "default", 0, 5),
    ("lcp_segside", "coarse_ns256", 16_384, 256, 256, False, "default", 0, 10),
    ("lcp_segside", "bulk_fine_ns1024", 256, 4096, 1024, True, "default", 0, 10),
    ("lcp_stream", "exact", 32, 4096, 4096, True, None, 1024, 20),
    ("lcp_stream", "exact", 32, 4096, 4096, True, "default", 1024, 20),
    ("lcp_stream", "exact", 32, 4096, 4096, False, None, 1024, 20),
    ("lcp_stream", "scene", 10_000, 4096, 4096, True, None, 1024, 3),
    ("lcp_stream", "scene", 10_000, 4096, 4096, True, "default", 1024, 3),
    ("lcp_stream", "scene", 10_000, 4096, 4096, False, None, 1024, 3),
    ("lcp_stream", "yardstick_coarse", 16_384, 512, 4096, True, None, 128, 3),
)
# (H, Nv, Ns) of lcp_stream_wide (ns_tile 128): the yardstick's coarse shape first.
WIDE_SHAPES = ((16_384, 512, 4096), (37, 700, 333), (5, 77, 2100))
# (H, Nv, Ns) of the unit grid: the coarse shape at four segment sizes and three
# H, a small and a large model, the bulk-fine and exact shapes of a scoring call.
UNIT_GRID = (
    (16_384, 256, 256), (16_384, 256, 512), (16_384, 256, 1024), (16_384, 256, 2048),
    (4096, 256, 1024), (1024, 256, 1024), (256, 256, 1024), (16_384, 128, 1024),
    (256, 4096, 1024), (2048, 4096, 1024), (256, 4096, 256), (32, 4096, 1024),
)


def time_units(device) -> tuple[bool, list]:
    ok, rows = True, []
    for h, nv, ns in UNIT_GRID:
        packed = kernel_inputs.packed_lcp_args(kernel_inputs.lcp_inputs(92, h, nv, ns, 24, device))
        for tier in ("default", "high3"):
            run = lambda unit: lcp._lcp_segside_on_unit(unit, *packed, False, tier)
            units = (lcp._UNIT_CUDA_CORES, lcp._UNIT_TENSOR_CORES)
            diff = float((run(units[0]) - run(units[1])).abs().max())
            ms = [chip_smoke.cuda_time_ms(lambda: run(unit), reps=3, inner=5) for unit in units]
            rule = lcp._lcp_segside_unit_for(h, nv, ns, False, tier)
            ok &= diff <= 1e-6
            rows.append(dict(shape=[h, nv, ns], tier=tier, weighted=False, cuda_cores_ms=ms[0],
                             tensor_cores_ms=ms[1], max_abs_diff=diff, rule_takes=rule))
            print(f"[units] lcp_segside H={h} Nv={nv} Ns={ns} tier={tier} unweighted: "
                  f"CUDA cores {ms[0]:.4f} ms, tensor-core filter {ms[1]:.4f} ms "
                  f"({ms[0] / ms[1]:.2f}x; the rule takes unit {rule}), max_abs_diff={diff:.3e}")
    return ok, rows


# (H, Nv, Ns) of lcp_segside_hb: the coarse shape of a scoring call first.
HB_SHAPES = ((16_384, 256, 256), (16_384, 256, 1024), (16_384, 256, 512), (16_384, 128, 256),
             (16_384, 512, 256), (4096, 256, 256), (1024, 256, 256), (1003, 300, 200),
             (67, 4096, 256), (4096, 256, 64))
# (H, Nm, Ns) of icp_corr_segside: the ICP tier of the scoring calls at Ns 1,024 and 4,096.
ICP_SHAPES = ((256, 512, 512), (256, 512, 2048))


def timed_pair(run_other, run_this, reps: int, inner: int, kernel: str):
    """(other, this) CUDA-event times in turns (other, this, this, other) and
    the device times of one call of each (one launch of `kernel`)."""
    t = lambda f: chip_smoke.cuda_time_ms(f, reps=reps, warmup=1, inner=inner)
    o1, n1, n2, o2 = t(run_other), t(run_this), t(run_this), t(run_other)
    dev = lambda f: chip_smoke.device_ms(f, kernel)
    return [o1, o2], [n1, n2], dev(run_other), dev(run_this)


def compare_pair(section, kernel, span, label, packed, weighted, tier, this, other, reps, inner,
                 ns_tile=0) -> tuple[bool, dict]:
    """One case of a section: both trees' scores (unweighted bit for bit,
    weighted within 1e-6) and their times in turns."""
    run = lambda k: k.run(kernel, packed, weighted, tier, ns_tile)
    a, b = run(this), run(other)
    diff = float((a - b).abs().max())
    same = bool(torch.equal(a, b))
    ok = diff <= 1e-6 and (same or weighted)
    o, n, od, nd = timed_pair(lambda: run(other), lambda: run(this), reps, inner, span)
    h, nv, ns = packed[0].shape[0], packed[1].shape[0], packed[3].shape[0]
    print(f"[{section}] {label} H={h} Nv={nv} Ns={ns} tier={tier} weighted={weighted}: other "
          f"{o[0]:.4f} / {o[1]:.4f} ms, this {n[0]:.4f} / {n[1]:.4f} ms (device {od} -> {nd}; "
          f"{min(o) / max(n):.2f}x), max_abs_diff={diff:.3e}, bit-identical={same}"
          f"{'' if ok else ' FAILED'}")
    return ok, dict(kernel=kernel, label=label, shape=[h, nv, ns], weighted=weighted, tier=tier,
                    other_ms=o, this_ms=n, other_device_ms=od, this_device_ms=nd,
                    max_abs_diff=diff, bit_identical=same)


def compare_hb(this, other, device) -> tuple[bool, list]:
    ok, rows = True, []
    cases = [(f"{h}x{nv}x{ns}", kernel_inputs.lcp_inputs(93, h, nv, ns, 20, device), 0.005, (1, 0))
             for h, nv, ns in HB_SHAPES]
    band = kernel_inputs.band_inputs(device)
    for tier in ("default", None):
        for side in (0, 1, -1):
            cases.append((f"band side={side}", band, kernel_inputs.band_delta(band, tier, side),
                          (lcp.TIERS[tier],)))
    for label, inputs, delta, tiers in cases:
        packed = kernel_inputs.packed_lcp_args(inputs, delta=delta)
        for tier in tiers:
            for weighted in (False, True):
                case_ok, row = compare_pair("hb", "lcp_segside_hb", "lcp_segside_hb", label, packed,
                                            weighted, tier, this, other, 5, 10)
                ok &= case_ok
                rows.append(row)
    return ok, rows


def compare_wide(this, other, device) -> tuple[bool, list]:
    ok, rows = True, []
    for h, nv, ns in WIDE_SHAPES:
        packed = kernel_inputs.stream_lcp_args(kernel_inputs.lcp_inputs(90, h, nv, ns, 20, device))
        reps, inner = (3, 1) if h >= 10_000 else (5, 10)
        for tier in (0, 1):
            for weighted in (True, False):
                case_ok, row = compare_pair("wide", "lcp_stream_wide", "lcp_stream_wide_kernel",
                                            f"{h}x{nv}x{ns}", packed, weighted, tier, this, other,
                                            reps, inner, ns_tile=lcp.STREAM_WIDE_NS_TILE)
                ok &= case_ok
                rows.append(row)
    return ok, rows


def compare_icp(this, other, device) -> tuple[bool, list]:
    ok, rows = True, []
    for h, nm, ns in ICP_SHAPES:
        tfs, mpts, mnrm, spts, smask = kernel_inputs.icp_inputs(94, h, nm, ns, 20, 8, device)
        tr12, seg4, _ = kernel_inputs.icp_pass_args(tfs, mpts, mnrm, spts, smask)
        for tier in (1, 0):
            run = lambda k: k.run_icp(tr12, seg4, mpts, mnrm, tier)
            a, b = run(this), run(other)
            rel = float((a - b).abs().max() / b.abs().max())
            ok &= rel <= 1e-6
            o, n, od, nd = timed_pair(lambda: run(other), lambda: run(this), 5, 20,
                                      "icp_corr_segside_kernel")
            rows.append(dict(kernel="icp_corr_segside", shape=[h, nm, ns], tier=tier, other_ms=o,
                             this_ms=n, other_device_ms=od, this_device_ms=nd, rel_diff=rel))
            print(f"[icp] H={h} Nm={nm} Ns={ns} tier={tier}: other {o[0]:.4f} / {o[1]:.4f} ms, "
                  f"this {n[0]:.4f} / {n[1]:.4f} ms (device {od} -> {nd}; "
                  f"{min(o) / max(n):.2f}x), (A, b) relative difference {rel:.3e} (tol 1e-6)")
    return ok, rows


def compare_icp_stream(this, other, device) -> tuple[bool, list]:
    ok, rows = True, []
    cases = []
    for h in (256, 32):
        tfs, mpts, mnrm, spts, smask = kernel_inputs.icp_inputs(70, h, 1024, 4096, 100, 8, device)
        cases.append((f"{h}x1024x4096", tfs, mpts, mnrm, spts, smask, (icp.STREAM_NM_TILE,)))
    cases.append(("ties", *kernel_inputs.icp_tie_inputs(device), (37, 100, 256)))
    # More chunks a tile than the match word has bits, the model staged (1,000
    # points) and streamed (4,096).
    for side in (10, 16):
        cases.append((f"ties side {side}", *kernel_inputs.icp_tie_inputs(device, side=side),
                      (512,)))
    for label, tfs, mpts, mnrm, spts, smask, tiles in cases:
        tr12 = tfs[:, :3, :].reshape(-1, 12).contiguous()
        seg4 = icp.pack_icp_stream_segment(spts, smask)
        for tile in tiles:
            run = lambda k, streamed=False: k.run_icp_stream(tr12, seg4, mpts, mnrm, tile,
                                                             streamed=streamed)
            a, b = run(this), run(other)
            rel = float((a - b).abs().max() / b.abs().max())
            ok &= rel <= 1e-6
            t = lambda f: chip_smoke.cuda_time_ms(f, reps=5, warmup=1, inner=10)
            o1, n1, n2, o2 = (t(lambda: run(k)) for k in (other, this, this, other))
            (od, od2), (nd, nd2) = (chip_smoke.icp_stream_device_ms(lambda: run(k))
                                    for k in (other, this))
            row = dict(kernel="icp_corr_stream", label=label, nm_tile=tile,
                       shape=list(tr12.shape[:1]) + [mpts.shape[0], seg4.shape[0]],
                       other_ms=[o1, o2], this_ms=[n1, n2], other_device_ms=od,
                       this_device_ms=nd, other_pass_device_ms=od2, this_pass_device_ms=nd2,
                       rel_diff=rel)
            line = (f"[icp-stream] {label} nm_tile={tile}: other {o1:.4f} / {o2:.4f} ms, this "
                    f"{n1:.4f} / {n2:.4f} ms (scan kernel device {od} -> {nd}; with the "
                    f"finishing kernel {od2} -> {nd2}; {min(o1, o2) / max(n1, n2):.2f}x), "
                    f"(A, b) relative difference {rel:.3e} (tol 1e-6)")
            if label.endswith("x4096"):
                # This tree's streamed variant on the same call, in turns with
                # the staged one: the gain that keeps the staged variant.
                a_s = run(this, True)
                rel_s = float((a_s - a).abs().max() / a.abs().max())
                ok &= rel_s <= 1e-6
                s1, g1, g2, s2 = (t(lambda: run(this, v)) for v in (True, False, False, True))
                sd, sd2 = chip_smoke.icp_stream_device_ms(lambda: run(this, True))
                gd, gd2 = chip_smoke.icp_stream_device_ms(lambda: run(this))
                row.update(streamed_ms=[s1, s2], staged_ms=[g1, g2], streamed_device_ms=sd,
                           staged_device_ms=gd, streamed_pass_device_ms=sd2,
                           staged_pass_device_ms=gd2, streamed_rel_diff=rel_s)
                line += (f"; streamed variant {s1:.4f} / {s2:.4f} ms against staged {g1:.4f} / "
                         f"{g2:.4f} ms (scan kernel device {sd} against {gd}), (A, b) relative "
                         f"difference {rel_s:.3e}")
            rows.append(row)
            print(line)
    return ok, rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other-csrc", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    sections = ["lcp", "hb", "wide", "icp", "icp-stream", "units"]
    ap.add_argument("--sections", nargs="+", default=sections, choices=sections)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_lcp_kernels: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    smi = chip_smoke.phase_device()
    names = ("lcp_segside", "lcp_stream", "icp_corr_segside", "icp_corr_stream")
    _build.build(names)  # this tree's, one nvcc per source, all started together
    this = Kernels(*(_build.load(name) for name in names))
    other = Kernels(*(build_other(args.other_csrc, name) for name in names))
    ok, rows, summary = True, [], dict(card=smi)

    if "lcp" in args.sections:
        for kernel, label, h, nv, ns, weighted, tier, tile, reps in TIMED:
            inputs = kernel_inputs.lcp_inputs(91, h, nv, ns, 24, device)
            stream = kernel == "lcp_stream"
            pack = kernel_inputs.stream_lcp_args if stream else kernel_inputs.packed_lcp_args
            packed = pack(inputs)
            t = lcp.TIERS[tier]
            diff = float((this.run(kernel, packed, weighted, t, tile)
                          - other.run(kernel, packed, weighted, t, tile)).abs().max())
            inner = 1 if h >= 10_000 else 10
            time = lambda k: chip_smoke.cuda_time_ms(
                lambda: k.run(kernel, packed, weighted, t, tile), reps=reps, warmup=1, inner=inner)
            o1, n1, n2, o2 = time(other), time(this), time(this), time(other)
            row = dict(kernel=kernel, label=label, shape=[h, nv, ns], weighted=weighted, tier=tier,
                       other_ms=[o1, o2], this_ms=[n1, n2], max_abs_diff=diff)
            rows.append(row)
            ok &= diff <= 2.0 / nv
            print(f"[timed] {kernel} {label} H={h} Nv={nv} Ns={ns} weighted={weighted} tier={tier}: "
                  f"other {o1:.4f} / {o2:.4f} ms, this {n1:.4f} / {n2:.4f} ms "
                  f"({min(o1, o2) / max(n1, n2):.2f}x), max_abs_diff={diff:.3e}")
        summary["timed"] = rows
    if "hb" in args.sections:
        hb_ok, summary["hb"] = compare_hb(this, other, device)
        ok &= hb_ok
    if "wide" in args.sections:
        wide_ok, summary["wide"] = compare_wide(this, other, device)
        ok &= wide_ok
    if "icp" in args.sections:
        icp_ok, summary["icp"] = compare_icp(this, other, device)
        ok &= icp_ok
    if "icp-stream" in args.sections:
        stream_ok, summary["icp_stream"] = compare_icp_stream(this, other, device)
        ok &= stream_ok
    if "units" in args.sections:
        units_ok, summary["units"] = time_units(device)
        ok &= units_ok
    summary["ok"] = ok
    print(json.dumps(summary))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(summary, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
