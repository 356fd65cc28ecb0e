"""The comparison that decides ``correct`` fails what it must.

* The control: the plain reference put in the program's place and computed
  in bfloat16, one precision below the configurations' float32, fails every
  cell's limit.
* The faults: a run of each cell driven with the timed path broken
  underneath comes out not correct: a step that returns its state
  unchanged, half of the batch left out (every other row's frontier
  dropped, so those rows retire unfinished), the exchange between
  partitions left out, and an answer altered where it is produced.  (No cell spans chips, so the exchange is
  the superstep's remote relaxation.)
"""

from __future__ import annotations

import pytest
import torch

from bench_tiny import OPEN_LOOP, ROOT, WORKLOADS, run_tiny, tiny_cell


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_in_bfloat16_fails_the_limit(workload):
    from bench import control, spec

    cell = tiny_cell(workload)
    limits = spec.load_cell(ROOT, workload).limits
    for seed in (1, 2, 3):
        r = control.readings(cell, seed, "cpu")
        number = r["control"]
        name = next(k for k in number if k != "dtype")
        assert number[name] > limits[name], (seed, number, limits)
        assert r["reference_float32"][name] <= limits[name]


def _unchanged_state(monkeypatch):
    # the engine first: the kernel's ops imported on their own meet an
    # import cycle in the program
    from repro_torch.graph import traversal  # noqa: F401
    from repro_torch.kernels.bfs_relax import ops

    monkeypatch.setattr(ops, "relax_blockmap_call", lambda row_ptr, dst, cand, base, **kw: base)


def _half_batch(monkeypatch):
    from repro_torch.graph.traversal import TraversalEngine

    window = TraversalEngine._window_impl

    def half(self, dist, frontier, *a, **kw):
        # every other row is left out of the window: its frontier dropped
        frontier = frontier.clone()
        frontier[1::2] = False
        return window(self, dist, frontier, *a, **kw)

    monkeypatch.setattr(TraversalEngine, "_window_impl", half)


def _no_exchange(monkeypatch):
    from repro_torch.graph.traversal import TraversalEngine

    build = TraversalEngine.__init__

    def without_remote(self, *a, **kw):
        build(self, *a, **kw)
        self._relax_r = lambda cand, base: base

    monkeypatch.setattr(TraversalEngine, "__init__", without_remote)


def _altered_answer(monkeypatch):
    from repro_torch.graph.traversal import TraversalEngine

    window = TraversalEngine._window_impl

    def altered(self, *a, **kw):
        res, pact, done = window(self, *a, **kw)
        dist = res.dist.clone()
        dist[done, self.n // 2] += 0.01
        return res._replace(dist=dist), pact, done

    monkeypatch.setattr(TraversalEngine, "_window_impl", altered)


FAULTS = {
    "unchanged_state": _unchanged_state,
    "half_batch": _half_batch,
    "no_exchange": _no_exchange,
    "altered_answer": _altered_answer,
}


@pytest.mark.parametrize("workload", WORKLOADS + [OPEN_LOOP])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_in_the_timed_path_is_not_correct(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, _ = run_tiny(workload, seed=2**31 + 101)
    assert result["correct"] is False, result["checks"]


def test_sound_run_reads_under_a_tenth_of_the_limit():
    from bench import spec

    result, _ = run_tiny("livj-8p.sssp16", seed=77)
    limits = spec.load_cell(ROOT, "livj-8p.sssp16").limits
    assert result["checks"]["dist_rel_gap"]["value"] < limits["dist_rel_gap"] / 10
    assert torch.get_default_dtype() == torch.float32
