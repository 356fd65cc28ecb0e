"""Every workload of BENCHMARK.json, and the open loop no cell drives yet,
cut to a tiny size, end to end on the CPU through the program's plain
backend and held against the reference."""

from __future__ import annotations

import json

import pytest

from bench_tiny import OPEN_LOOP, ROOT, WORKLOADS, run_tiny, tiny_cell

@pytest.mark.parametrize("workload", WORKLOADS + [OPEN_LOOP])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_is_correct_and_well_formed(workload, trace):
    result, record = run_tiny(workload, trace=trace)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert record["checked"] > 0
    cell = tiny_cell(workload)
    if trace:
        # readers of the card's trace and roofline find nothing on the CPU
        # and leave their metric out; the rest are there
        on_cpu = {"partition_s", "layout_s", "host_syncs_per_batch.batch"}
        want = {m["name"] for m in cell.per_layer} & on_cpu
        assert want <= set(result["metrics"])
        assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
        for m in cell.end_to_end:
            assert result["metrics"][m["name"]]["value"] > 0
            assert result["metrics"][m["name"]]["unit"] == m["unit"]
    json.dumps(result, allow_nan=False)


def test_window_counters_cover_the_engine_and_the_kernel():
    _, record = run_tiny("livj-8p.sssp16")
    counters = record["counters"]
    assert counters["engine.host_syncs"] > 0
    assert {"relax.launches", "engine.bulk_pulls"} <= set(counters)
    assert all(isinstance(v, int) for v in counters.values())


def test_open_loop_counts_the_calls_that_backfill():
    _, record = run_tiny(OPEN_LOOP)
    loop = record["loop"]
    assert 0 <= loop["calls_over_batch"] <= loop["calls"]
    assert loop["windows"] > 0


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc: the relax kernel runs only there")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS + [OPEN_LOOP])
def test_tiny_cell_on_the_card(card, workload):
    from bench import run
    from bench_tiny import SECONDS, tiny_cell

    result, _ = run.run_cell(ROOT, workload, 2**31 + 17, SECONDS, True, device=card,
                             backend="cuda", cell=tiny_cell(workload))
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    roofline = result["metrics"].get("relax_roofline.batch")
    if roofline is not None:
        assert 0 < roofline["value"] <= 105
