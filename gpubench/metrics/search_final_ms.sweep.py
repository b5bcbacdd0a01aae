"""The final passes of a sweep call's searches: the program's search.final
span (pipeline/mcts.mcts_select_multi: every scene's chosen assignment
settled with the full hulls, refined by TrICP, and installed, one scene
after another), median ms over the window's sweep calls. A program without
the span reads nothing."""

from gpubench import spans


def read(run):
    return spans.median_total_ms(run, "search.final")
