"""Kernels launched a job ((scene, object)) by the sweep: the kernels inside
the traced sweep calls over those calls' jobs."""


def read(run):
    tr = run["trace"]
    sweep = tr["ranges"].get("sweep") if tr else None
    if not sweep or not sweep["kernels"]:
        return None
    jobs = len(run["conf"]["objects"]) * run["mix"]["batch_scenes"] * sweep["count"]
    return sweep["kernels"] / jobs
