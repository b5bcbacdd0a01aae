"""What decides `correct`, and the accuracy that the run reports.

Every request sent inside the window is due. Its answer is judged by the
plain reference (reference.py) against the benchmark's own truth, never
against anything the program made. The numbers compared, each against its
limit from limits/<cell>.json:

- unanswered: the share of due requests with no answer (an error, or none
  within a minute of the window's close); a request that the service's
  admission turned away (503, "busy") is an answer, counted as shed;
- adds_p50_mm: the median ADD-S, in mm, of the objects of a sample of the
  requests not shed, drawn from the seed (a missing answer's objects count
  as infinite);
- adds_obj_p50_max_mm: over the same answers, per object name the median
  ADD-S of that object, and the largest of these medians: one object wrong
  in every answer moves it, where the median over all objects stays;
- fit_gap_p50: over the same objects, the median of (the share of the
  object's observed points within delta of its box at the truth) minus (the
  same at the answered pose): the paper's LCP score, recomputed.

A number that limits/<cell>.json does not list is reported beside the
others and decides nothing. adds_2cm_rate, the end-to-end accuracy, is over
every due request: each answered object within 2 cm ADD-S counts, each
object of a failed or unanswered request is a miss.
"""

from __future__ import annotations

import numpy as np

from gpubench import reference, scenes


class Judge:
    """The reference's readings of a run's answers, cached per scene."""

    def __init__(self, conf: dict, pool: list):
        self.conf = conf
        self.pool = pool
        self.k = scenes.intrinsics(conf)
        self.sizes = {o["name"]: tuple(o["size_m"]) for o in conf["objects"]}
        self.cls = {o["name"]: o["class_id"] for o in conf["objects"]}
        self.surface = {n: reference.box_surface_points(s) for n, s in self.sizes.items()}
        self.chk = conf["check"]
        self._obs = {}

    def adds_mm(self, rec: dict) -> dict:
        """Per object of the scene: ADD-S in mm (inf where not answered)."""
        truth = self.pool[rec["scene"]].poses
        out = {}
        for name, gt in truth.items():
            pose = rec["poses"].get(name) if rec["ok"] else None
            out[name] = (float("inf") if pose is None else
                         1000.0 * reference.adds_m(np.asarray(pose), gt, self.sizes[name],
                                                   self.surface[name]))
        return out

    def pose_errors(self, rec: dict, name: str) -> tuple:
        pose = rec["poses"].get(name) if rec["ok"] else None
        if pose is None:
            return float("inf"), float("inf")
        t, r = reference.pose_errors(np.asarray(pose), self.pool[rec["scene"]].poses[name])
        return 1000.0 * t, r

    def fit_gaps(self, rec: dict) -> list:
        sc = self.pool[rec["scene"]]
        gaps = []
        for name, gt in sc.poses.items():
            key = (rec["scene"], name)
            if key not in self._obs:
                pts = reference.observed_points(sc, self.cls[name], self.k)
                self._obs[key] = (pts, reference.lcp_fit(pts, gt, self.sizes[name],
                                                         self.chk["delta_m"]))
            pts, at_truth = self._obs[key]
            pose = rec["poses"].get(name) if rec["ok"] else None
            at_answer = 0.0 if pose is None else reference.lcp_fit(
                pts, np.asarray(pose), self.sizes[name], self.chk["delta_m"])
            gaps.append(at_truth - at_answer)
        return gaps


def judge(conf: dict, mix: dict, pool: list, due: list, rng: np.random.Generator,
          limits: dict) -> tuple:
    """(correct, checks {name: {"value", "limit"}}, readings, adds_2cm_rate)."""
    j = Judge(conf, pool)
    bar_mm = 1000.0 * conf["check"]["adds_bar_m"]
    adds = [j.adds_mm(r) for r in due]
    objects = [v for a in adds for v in a.values()]
    rate = float(np.mean([v <= bar_mm for v in objects])) if objects else 0.0
    misses = [[r["scene"], name, v] for r, a in zip(due, adds) for name, v in a.items()
              if v > bar_mm]
    served = [i for i, r in enumerate(due) if not r["shed"]]
    n = min(mix["check_sample"], len(served))
    sample = sorted(rng.choice(served, size=n, replace=False)) if n else []
    per_object = {name: float(np.median([adds[i][name] for i in sample]))
                  for name in (adds[sample[0]] if n else {})}
    readings = {
        "unanswered": float(np.mean([not r["ok"] and not r["shed"] for r in due]))
        if due else 1.0,
        "shed": float(np.mean([r["shed"] for r in due])) if due else 0.0,
        "adds_p50_mm": float(np.median([v for i in sample for v in adds[i].values()]))
        if n else float("inf"),
        "adds_obj_p50_max_mm": max(per_object.values()) if n else float("inf"),
        "fit_gap_p50": float(np.median([g for i in sample for g in j.fit_gaps(due[i])]))
        if n else 1.0,
    }
    readings["adds_obj_p50_mm"] = per_object
    readings["misses"] = misses[:20]  # (pool scene, object, ADD-S mm) beyond the bar
    errs = [[due[i]["scene"], name, adds[i][name],
             *j.pose_errors(due[i], name)] for i in sample for name in adds[i]]
    readings["t_err_p50_mm"] = float(np.median([e[3] for e in errs])) if errs else float("inf")
    readings["rot_err_p50_deg"] = float(np.median([e[4] for e in errs])) if errs else float("inf")
    readings["objects"] = errs[:40]  # (pool scene, object, ADD-S mm, t mm, rotation deg)
    checks = {name: {"value": readings[name], "limit": lim} for name, lim in limits.items()}
    correct = bool(due) and all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks, readings, rate
