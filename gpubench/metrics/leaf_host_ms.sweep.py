"""The host's time a shared leaf batch of the sweep's search: a call's
search.collect, search.leaf_eval and search.backup spans (the rounds of
pipeline/mcts.uct_search_multi: every tree's leaves chosen, the shared
batch's settle, render and cost enqueued, the wait for its costs and their
backup into each tree), summed, over the leaf_batches count on its
sweep.search span; median ms over the window's sweep calls."""

from gpubench import spans

ROUNDS = ("search.collect", "search.leaf_eval", "search.backup")


def read(run):
    vals = []
    for rec in spans.records(run):
        search = rec.find("sweep.search")
        batches = (search.counts or {}).get("leaf_batches") if search is not None else None
        if not batches:
            continue
        vals.append(sum(s.duration for name in ROUNDS for s in search.find_all(name)) / batches)
    return spans.median_ms(vals)
