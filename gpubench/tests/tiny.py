"""A cut of the program's sizes for CPU runs of the harness (the repository's
tests/test_torch_hard_eval.py TINY): 64 hypotheses an object, 256 model
points. Scenes keep the cells' 640x480."""


def tiny_config():
    from physimglobalpose_tpu_torch import config as tconfig

    return tconfig.PipelineConfig(
        preprocess=tconfig.PreprocessConfig(max_segment_points=128),
        stocs=tconfig.StoCSConfig(num_bases=8, max_quads_per_base=8, max_pairs_per_ppf=32),
        max_model_points=128, max_validation_points=256,
    )


def tiny_cell(name: str, **limits) -> dict:
    """spec.cell(name) with a pool of 3 scenes, one warm-up and `limits`."""
    from gpubench import spec

    cell = spec.cell(name)
    cell["traffic"] = dict(cell["traffic"], pool_scenes=3, warmup=1, check_sample=4)
    if limits:
        cell["limits"] = limits
    return cell
