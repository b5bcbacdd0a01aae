"""How often a short torch.profiler session loses device spans, with and
without chip_smoke.profiled's pause between the profiler's start and the first
launch, before and after large sessions in the same process.

Each block (after the first) profiles one session of 37,000 small launches
(CPU and CUDA activities, as [leaf] does), then profiles one scoring call
(`score_refine_pipeline` at the benchmark shape, CUDA activity, as [scoring]'s
coarse-span check does) `--rounds` times each way, in turns. Each session's
kernel launches are counted twice: the host's launch calls, which CUPTI
records on the host side, and the kernels' device spans; a span lost is a
launch without its span. A session also counts as missing the coarse call
when it has no lcp_segside_hb span. Needs the card; prints one JSON line.

  python3 tools/profile_drop_probe.py [--blocks 7 --rounds 20]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def spans(prof) -> tuple[int, int, int]:
    """(launch calls, kernel spans, lcp_segside_hb spans) of a finished profile."""
    evs = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    ks = [e for e in evs if e.device_type == cuda and not e.name.startswith(("Memcpy", "Memset"))]
    calls = sum(1 for e in evs if e.device_type != cuda and e.name in chip_smoke.LAUNCH_CALLS)
    return calls, len(ks), sum("lcp_segside_hb" in e.name for e in ks)


def session(run, pause: bool) -> tuple[int, int, int]:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    if pause:
        with chip_smoke.profiled(ProfilerActivity.CUDA) as prof:
            run()
            torch.cuda.synchronize()
    else:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    return spans(prof)


def large_session(launches: int = 37000) -> int:
    from torch.profiler import ProfilerActivity

    x = torch.zeros(16, device="cuda")
    torch.cuda.synchronize()
    with chip_smoke.profiled(ProfilerActivity.CPU, ProfilerActivity.CUDA) as prof:
        for _ in range(launches):
            x.add_(1.0)
        torch.cuda.synchronize()
    calls, kept, _ = spans(prof)
    return calls - kept


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--blocks", type=int, default=7, help="the first without a large session")
    p.add_argument("--rounds", type=int, default=20, help="sessions each way per block")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("this probe needs an NVIDIA card")
    from physimglobalpose_tpu_torch import bench_inputs
    from physimglobalpose_tpu_torch.ops import scoring

    chip_smoke.phase_build()
    inputs = bench_inputs.to_tensors(bench_inputs.make_inputs(seed=0, clutter=True),
                                     torch.device("cuda"))
    flags = bench_inputs.prod_flags()
    run = lambda: scoring.score_refine_pipeline(*inputs, **flags)
    run()
    rows = {"no_pause": [], "pause": []}  # (block, launch calls, kernel spans, hb spans)
    for block in range(args.blocks):
        lost = large_session() if block else None
        for _ in range(args.rounds):
            for way in rows:
                rows[way].append((block, *session(run, way == "pause")))
        chip_smoke.log(f"[probe] block {block}: the large session lost {lost} spans; spans lost "
                       "a session " + json.dumps({way: [c - k for b, c, k, _ in r if b == block]
                                                  for way, r in rows.items()}))
    out = {"pause_s": chip_smoke.PROFILE_PAUSE_S}
    for way, r in rows.items():
        for tag, sel in (("before", [x for x in r if x[0] == 0]),
                         ("after", [x for x in r if x[0] > 0])):
            lost = [c - k for _, c, k, _ in sel]
            out[f"{way}_{tag}"] = {"sessions": len(sel), "launches": sel[0][1],
                                   "sessions_losing_spans": sum(x > 0 for x in lost),
                                   "median_lost": statistics.median(lost), "max_lost": max(lost),
                                   "hb_missing": sum(h == 0 for *_, h in sel)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
