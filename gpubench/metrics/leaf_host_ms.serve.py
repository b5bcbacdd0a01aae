"""The host's time a leaf batch of the search: a request's search.collect,
search.leaf_eval and search.backup spans (the rounds of
pipeline/mcts.uct_search: the batch's leaves chosen, its settle, render and
cost enqueued, the wait for its costs and their backup), summed, over the
leaf_batches count on its `search` span; median ms over the window's
answers."""

from gpubench import spans

ROUNDS = ("search.collect", "search.leaf_eval", "search.backup")


def read(run):
    vals = []
    for rec in spans.records(run):
        search = rec.find("search")
        batches = (search.counts or {}).get("leaf_batches") if search is not None else None
        if not batches:
            continue
        vals.append(sum(s.duration for name in ROUNDS for s in search.find_all(name)) / batches)
    return spans.median_ms(vals)
