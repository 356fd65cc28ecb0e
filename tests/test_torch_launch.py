"""``repro_torch.dist.run_ranks``'s start-up and teardown: back-to-back
2-rank launches all succeed, a rank that dies leaving the group after every
result is written leaves the launch good (and is counted), and the
launcher's verdict on each combination of exit codes and markers."""

from __future__ import annotations

import os

import pytest

from repro_torch.dist import launch
from repro_torch.dist import run_ranks

BACK_TO_BACK = 20


def _rank_sum(i):
    import torch
    import torch.distributed as dist

    t = torch.ones(4) * (dist.get_rank() + 1 + i)
    dist.all_reduce(t)
    return float(t[0])


def _rank_abort_leaving():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        dist.destroy_process_group = lambda *a, **k: os.abort()
    return dist.get_rank()


def test_back_to_back_launches_all_succeed():
    for i in range(BACK_TO_BACK):
        res = run_ranks(_rank_sum, 2, device="cpu", timeout=120, args=(i,))
        assert list(res) == [3.0 + 2 * i] * 2
        assert res.retries == 0 and res.teardown_aborts == 0


def test_an_abort_after_every_result_leaves_the_launch_good():
    res = run_ranks(_rank_abort_leaving, 2, device="cpu", timeout=120)
    assert list(res) == [0, 1]
    assert res.teardown_aborts == 1 and res.retries == 0


@pytest.mark.parametrize("rcs, joined, results, outcome", [
    ([None, None], [], [], "running"),
    ([None, None], [0, 1], [0], "running"),
    ([0, None], [0, 1], [0, 1], "running"),
    ([0, 0], [0, 1], [0, 1], "done"),
    ([0, -6], [0, 1], [0, 1], "done"),
    ([None, -6], [0, 1], [0, 1], "done"),
    ([None, -6], [0], [], "restart"),
    ([-6, -6], [], [], "restart"),
    ([None, -6], [0, 1], [], "failed"),
    ([1, None], [0, 1], [1], "failed"),
    ([-6, -6], [1], [], "failed"),
])
def test_launch_outcome(tmp_path, rcs, joined, results, outcome):
    for r in joined:
        (tmp_path / f"joined{r}").touch()
    for r in results:
        (tmp_path / f"result{r}.pkl").write_bytes(b"")
    assert launch.launch_outcome(rcs, tmp_path) == outcome
