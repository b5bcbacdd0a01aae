"""The search's final pass a request: the program's search.final span
(pipeline/mcts.mcts_select: the chosen assignment settled with the full
hulls, refined by TrICP, and installed), median ms over the window's
answers. A program without the span reads nothing."""

from gpubench import spans


def read(run):
    return spans.median_total_ms(run, "search.final")
