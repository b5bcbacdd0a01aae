"""The service's own time inside its handler a request: the program's
serve.request span minus its estimate child (the request line, headers and
body parsed, the wait for the device, the JSON reply written), median ms
over the window's answers. The accept, the handler thread's start and the
client lie outside it (serve_overhead_ms.serve counts them)."""

from gpubench import spans


def read(run):
    vals = []
    for rec in spans.records(run):
        req = rec.find("serve.request")
        est = req.find("estimate") if req is not None else None
        if est is not None:
            vals.append(req.duration - est.duration)
    return spans.median_ms(vals)
