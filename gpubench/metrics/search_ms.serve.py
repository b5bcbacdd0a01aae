"""The physics-aware search a request: the program's `search` span
(pipeline/api.estimate_pose around pipeline/mcts.mcts_select: the search's
inputs, its rounds and its final pass), median ms over the window's answers."""

from gpubench import spans


def read(run):
    return spans.median_total_ms(run, "search")
