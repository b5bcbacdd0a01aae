"""Refinements in lockstep (ops/icp: lockstep, refine_icp_each, and
plane.refine_table_poses on top of them): several independent ICPs whose
point-to-point iterations share one torch.linalg.svd call, so that they wait
for the card once a round, not once each. Every refinement must get the
answer it gets alone, bit for bit: on the CPU here, and on the card in the
tests marked `card`, which skip without one:

    python -m pytest tests/test_torch_icp_lockstep.py -q -m card --noconftest

(--noconftest: the suite's conftest sets JAX up, which the card's machine
need not have; this file imports no JAX.)
"""

import numpy as np
import pytest
import torch

from physimglobalpose_tpu_torch.ops import icp, plane

CPU = torch.device("cpu")


def _grid_job(seed, device, n_hyp=1):
    """A 144-point table-top grid against a noisy copy of it turned by a few
    degrees and moved a few millimetres, with a fifth of the copy masked
    out: the refinement of a scene's table box."""
    rng = np.random.default_rng(seed)
    g = np.linspace(-0.2, 0.2, 12)
    model = np.stack([*np.meshgrid(g, g, indexing="ij"), np.zeros((12, 12))], -1).reshape(-1, 3)
    turn = np.radians(rng.uniform(-4, 4))
    rot = np.array([[np.cos(turn), -np.sin(turn), 0], [np.sin(turn), np.cos(turn), 0], [0, 0, 1]])
    seg = model @ rot.T + rng.uniform(-0.004, 0.004, 3) + rng.normal(0, 1e-3, model.shape)
    normals = np.tile([0.0, 0.0, 1.0], (144, 1))
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    tfs = torch.eye(4, device=device).repeat(n_hyp, 1, 1)
    tfs[:, :3, 3] = f(rng.normal(0, 2e-3, (n_hyp, 3)))
    return (tfs, f(model), f(normals), f(seg), torch.as_tensor(rng.random(144) > 0.2,
                                                               device=device))


def _assert_each_as_alone(device, point_to_plane):
    jobs = [_grid_job(seed, device, n_hyp=1 + seed % 3) for seed in range(5)]
    kw = dict(iters=50, trim_fraction=0.8, max_corr_dist=0.01, point_to_plane=point_to_plane)
    together = icp.refine_icp_each(jobs, **kw)
    for job, got in zip(jobs, together):
        assert torch.equal(got, icp.refine_icp(*job, **kw))
    assert not torch.equal(together[0][0], together[1][0])


@pytest.mark.parametrize("point_to_plane", [False, True])
def test_refinements_in_lockstep_get_their_own_answers(point_to_plane):
    _assert_each_as_alone(CPU, point_to_plane)


def test_generators_of_different_lengths_step_together():
    """lockstep drives refinements of 3, 7 and 0 iterations, one of them
    with exact trimming: each ends with _icp_chunk's answer."""
    args = [(_grid_job(s, CPU), it, trim) for s, it, trim in ((0, 3, False), (1, 7, True),
                                                              (2, 0, False))]
    steps = [icp.icp_steps(*job, it, 0.8, 0.01, False, trim, 1) for job, it, trim in args]
    for got, (job, it, trim) in zip(icp.lockstep(steps), args):
        assert torch.equal(got, icp._icp_chunk(*job, it, 0.8, 0.01, False, trim, 1))


def test_tables_in_lockstep_get_their_own_answers():
    tables = []
    for seed in range(3):
        tfs, model, _n, seg, mask = _grid_job(seed, CPU)
        plane4 = torch.tensor([0.0, 0.0, 1.0, 0.0])
        tables.append((tfs[0], seg, mask, plane4))
    together = plane.refine_table_poses(tables, (0.2, 0.2, 0.2))
    for table, got in zip(tables, together):
        assert torch.equal(got, plane.refine_table_pose(*table, (0.2, 0.2, 0.2)))


# ------------------------------------------------------------------ on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("point_to_plane", [False, True])
def test_card_refinements_in_lockstep_get_their_own_answers(card, point_to_plane):
    _assert_each_as_alone(card, point_to_plane)
