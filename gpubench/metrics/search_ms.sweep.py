"""The physics-aware search a sweep call: the program's sweep.search span
(parallel/scene_sweep.sweep_scenes in MCTS mode around
pipeline/mcts.mcts_select_multi: the table boxes, the scenes' searches in
shared leaf batches and their final passes), median ms over the window's
sweep calls."""

from gpubench import spans


def read(run):
    return spans.median_total_ms(run, "sweep.search")
