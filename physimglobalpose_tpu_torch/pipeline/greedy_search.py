"""Greedy best-first search over object placement orders.

Reference: hypothesis_verification/greedy_bfs/{Search,State}.cpp - the
predecessor of the MCTS: a priority queue over partial scenes ordered by
heuristic value, expanding the best node (maxSearchIters=300). As in the JAX
package it shares the batched leaf evaluator: a node's children are scored
as one device batch.
"""

from __future__ import annotations

import heapq
import itertools
from typing import List, Tuple

import numpy as np

from physimglobalpose_tpu_torch.config import PipelineConfig, DEFAULT_CONFIG
from physimglobalpose_tpu_torch.pipeline.mcts import BatchedLeafEvaluator


def greedy_bfs_search(
    evaluator: BatchedLeafEvaluator,
    hyp_scores: np.ndarray,  # [K, C]
    cfg: PipelineConfig = DEFAULT_CONFIG,
    max_iters: int = 300,
    beam: int = 8,
) -> Tuple[np.ndarray, float]:
    """Best-first search: expand the lowest-cost partial assignment.

    A node is a prefix assignment (choices for the first d objects). Children
    (all C choices for object d) are evaluated as one batch. Returns (best
    complete assignment [K], its cost).
    """
    k = evaluator.k
    c = min(hyp_scores.shape[1], evaluator.num_hyp)
    counter = itertools.count()  # tie-break for heapq

    # Node: (cost, tiebreak, depth, choices tuple)
    frontier: List[tuple] = [(0.0, next(counter), 0, ())]
    best_complete: Tuple[np.ndarray, float] | None = None
    iters = 0

    while frontier and iters < max_iters:
        cost, _, depth, prefix = heapq.heappop(frontier)
        # Prefix costs are no lower bounds (placing an object can explain
        # observed pixels and lower the cost), so the first complete pop need
        # not be optimal: search until the frontier minimum (this pop)
        # reaches the best complete cost.
        if best_complete is not None and cost >= best_complete[1]:
            break
        if depth == k:
            if best_complete is None or cost < best_complete[1]:
                best_complete = (np.asarray(prefix, np.int64), float(cost))
            continue
        child_choices = np.full((c, k), -1, np.int64)
        for j in range(c):
            child_choices[j, :depth] = prefix
            child_choices[j, depth] = j
        costs, _ = evaluator.evaluate(child_choices, child_choices >= 0)
        iters += 1
        for j in np.argsort(costs)[:beam]:  # keep the best few children
            heapq.heappush(frontier, (float(costs[j]), next(counter), depth + 1, prefix + (int(j),)))

    if best_complete is None:
        # Fallback: greedy by LCP heuristic.
        return np.argmax(hyp_scores[:, :c], axis=1), float("inf")
    return best_complete
