"""The readers of the program's own spans (spans.py, metrics/service_self_ms.serve,
prepare_ms.sweep, jobs_ms.sweep) on small synthetic runs, and the device
trace's summary with the program's "pose::" ranges in it."""

import types

import pytest

from gpubench import spec, trace
from physimglobalpose_tpu_torch.utils import tracing


def _timed(span, start_us, end_us):
    span.start_ns, span.end_ns = start_us * 1000, end_us * 1000


def _serve_record(total_us, estimate_us):
    with tracing.span("serve.request") as req:
        with tracing.span("serve.parse"):
            pass
        with tracing.span("estimate") as est:
            pass
    _timed(req, 0, total_us)
    _timed(est, 100, 100 + estimate_us)
    return req.request_id


def _sweep_record(prepare_us, jobs_us):
    with tracing.span("sweep") as sweep:
        t = 0
        for p, j in zip(prepare_us, jobs_us):
            with tracing.span("sweep.prepare") as sp:
                pass
            with tracing.span("sweep.jobs") as sj:
                pass
            _timed(sp, t, t + p)
            _timed(sj, t + p, t + p + j)
            t += p + j
    _timed(sweep, 0, t)
    return sweep.request_id


def _run(request_ids):
    return {"answered": [{"timings": {} if rid is None else {"request_id": rid}}
                         for rid in request_ids]}


def test_service_self_time_is_the_request_less_its_estimate():
    ids = [_serve_record(10_000, 7_000), _serve_record(20_000, 17_500),
           _serve_record(9_000, 4_000)]
    read = spec.metric_reader("service_self_ms.serve")
    assert read(_run(ids + [None])) == pytest.approx(3.0)  # median of 3, 2.5 and 5 ms
    assert read(_run([None])) is None


def test_sweep_stages_are_summed_a_call_and_a_call_counted_once():
    one = _sweep_record([4_000], [10_000])
    two = _sweep_record([3_000, 3_000], [5_000, 6_000])  # pipelined: a pair a chunk
    three = _sweep_record([8_000], [30_000])
    run = _run([one] * 4 + [two] * 4 + [three] * 4)
    assert spec.metric_reader("prepare_ms.sweep")(run) == pytest.approx(6.0)
    assert spec.metric_reader("jobs_ms.sweep")(run) == pytest.approx(11.0)


def test_a_program_without_request_records_reads_nothing(monkeypatch):
    ids = [_serve_record(10_000, 7_000), _sweep_record([4_000], [10_000])]
    monkeypatch.delattr(tracing, "record")
    for name in ("service_self_ms.serve", "prepare_ms.sweep", "jobs_ms.sweep"):
        assert spec.metric_reader(name)(_run(ids)) is None


def _event(name, start, end, eid=0):
    return types.SimpleNamespace(name=name, id=eid,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def test_program_ranges_leave_the_benchmarks_ranges_as_they_were():
    cpu = [_event("gpubench::sweep", 0, 300), _event("gpubench::lcp", 5, 100),
           _event("cudaLaunchKernel", 10, 12, 1), _event("cudaMemcpyAsync", 50, 52, 2),
           _event("cudaLaunchKernel", 200, 202, 3)]
    device = [_event("lcp_segside_kernel", 20, 30, 1), _event("Memcpy HtoD", 60, 70, 2),
              _event("icp_kernel", 210, 260, 3)]
    want = trace._ranges(cpu, device)
    assert want["lcp"] == {"count": 1, "kernels": 1, "device_s": pytest.approx(20e-6)}
    assert want["sweep"] == {"count": 1, "kernels": 2, "device_s": pytest.approx(70e-6)}
    pose = [_event("pose::sweep", 1, 299), _event("pose::sweep.jobs", 4, 290),
            _event("pose::icp_refine", 100, 280)]
    got = trace._ranges(cpu + pose, device)
    assert got["lcp"] == want["lcp"] and got["sweep"] == want["sweep"]
    # An idle gap while only the program's Python runs is put down to its
    # innermost range.
    busy = [[20, 30], [60, 70], [210, 260]]
    gaps = dict(trace._idle_gaps(busy, cpu + pose))
    assert gaps["pose::icp_refine"] == pytest.approx(140e-6)  # 70 .. 210, middle 140
    assert gaps["pose::sweep.jobs"] == pytest.approx(30e-6)  # 30 .. 60
    assert "no host operation" in dict(trace._idle_gaps(busy, cpu))
