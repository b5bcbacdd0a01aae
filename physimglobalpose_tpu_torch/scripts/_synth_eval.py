"""The accuracy sections that r4_hard_eval and r5_eval write.

Shared by the ports of the JAX package's scripts/r4_hard_eval.py and
scripts/r5_eval.py: the generated scenes, the occlusion statistics of the
--hard family, the grading of each mode through pipeline/evaluate, and the
merge of a section into the output JSON, with the JAX scripts' keys and
rounding.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np

TMP_ROOT = os.path.join(tempfile.gettempdir(), "physimglobalpose_tpu_torch")
# The JAX scripts merge into the repository's SYNTH_EVAL.json, whose figures
# are the TPU's on the reference's meshes: the port writes its own file.
DEFAULT_OUT = os.path.join(TMP_ROOT, "synth_eval.json")


def ensure_scenes(root: str, n: int, objects, seed: int, model_dir: str, obj_config: str,
                  device, dataset: str = "APC", hard: bool = True) -> list:
    """The scene directories root/scene_0000.. of n scenes, generated with the
    port's make_synthetic_scenes unless the last one exists (the JAX scripts'
    rule)."""
    if not os.path.isdir(os.path.join(root, f"scene_{n - 1:04d}")):
        from physimglobalpose_tpu_torch.scripts import make_synthetic_scenes

        make_synthetic_scenes.main(
            ["--out", root, "--n", str(n), "--objects", ",".join(objects), "--seed", str(seed),
             "--dataset", dataset, "--model-dir", model_dir, "--obj-config", obj_config,
             "--device", device.type] + (["--hard"] if hard else []))
    return [os.path.join(root, f"scene_{i:04d}") for i in range(n)]


def occlusion_frac(scene_dirs) -> dict:
    """The --hard scenes' occlusion fractions (hard_stats.json): mean, max and
    the count over one half."""
    occ = []
    for sd in scene_dirs:
        with open(os.path.join(sd, "hard_stats.json")) as fh:
            occ.extend(json.load(fh)["occlusion_frac"].values())
    return {
        "mean": round(float(np.mean(occ)), 3),
        "max": round(float(np.max(occ)), 3),
        "over_50pct": int(sum(o > 0.5 for o in occ)),
    }


def grade_modes(section: dict, scene_dirs, db, modes, log_of, cfg, seed: int, device,
                dataset: str = "APC", segmentation: str = "GT") -> None:
    """Grade the scenes in each of `modes`, one after another, through
    pipeline/evaluate.evaluate_scenes with a fresh JSONL log a mode
    (log_of(mode)); section[mode] receives the share within ADD-S 2 cm, the
    mean and max ADD-S, the per-object means, the wall time and the worst
    three."""
    from physimglobalpose_tpu_torch.pipeline import evaluate

    for mode in modes:
        log = log_of(mode)
        if os.path.exists(log):
            os.remove(log)
        t0 = time.perf_counter()
        agg = evaluate.evaluate_scenes(
            scene_dirs, db, log, dataset=dataset, segmentation_mode=segmentation,
            verification_mode=mode, cfg=cfg, seed=seed, device=device,
        )
        per_obj, worst = {}, []
        with open(log) as fh:
            for line in fh:
                row = json.loads(line)
                for name, entry in row["objects"].items():
                    if "adds_m" in entry:
                        per_obj.setdefault(name, []).append(entry["adds_m"])
                        worst.append((entry["adds_m"], row["scene"], name))
        section[mode] = {
            "adds_within_2cm": agg.get("adds_within_2cm"),
            "mean_adds_m": round(agg.get("mean_adds_m", 0.0), 5),
            "max_adds_m": round(max(max(v) for v in per_obj.values()), 4),
            "per_object_mean_adds_m": {
                k: round(float(np.mean(v)), 5) for k, v in per_obj.items()
            },
            "wall_s": round(time.perf_counter() - t0, 1),
        }
        worst.sort(reverse=True)
        section[mode]["worst3"] = [
            {"adds_m": round(a, 4), "scene": os.path.basename(s), "obj": n}
            for a, s, n in worst[:3]
        ]
        print(mode, json.dumps(section[mode]), flush=True)


def merge_section(out_path: str, name: str, section: dict) -> None:
    """Stamp the section and merge it into out_path's section `name` key by
    key, so that a re-run of some modes keeps the others; out_path is
    created when missing."""
    section["timestamp"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    synth = {}
    if os.path.exists(out_path):
        with open(out_path) as fh:
            synth = json.load(fh)
    merged = synth.get(name, {})
    merged.update(section)
    synth[name] = merged
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(synth, fh, indent=1)
    print(f"merged '{name}' section into {out_path}")
