"""How full the sweep's shared leaf batches are: the leaves over the
leaf_rows counted on each call's sweep.search span (pipeline/mcts.
_search_rounds: the rows queued, the padding to the batch size included),
summed over the window's sweep calls. 1 when every row is a real leaf; it
falls as trees finish and the batch is padded. A program without the
leaf_rows counter reads nothing."""

from gpubench import spans


def read(run):
    leaves = rows = 0
    for rec in spans.records(run):
        search = rec.find("sweep.search")
        counts = (search.counts or {}) if search is not None else {}
        if counts.get("leaf_rows"):
            leaves += counts.get("leaves", 0)
            rows += counts["leaf_rows"]
    return leaves / rows if rows else None
