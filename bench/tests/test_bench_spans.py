"""The span table (``bench/spans.py``) against a timeline reckoned by hand,
the same table from a real profile of a tiny cell on the CPU, and the
reader of ``scan_elems_per_batch.batch``."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from bench_tiny import ROOT, run_tiny, tiny_cell
from bench import spans, spec

# microseconds: a run holding its state's build, a window and the pull; two
# counters scans in the window; one device op launched by the window itself
# and one outside every span
SPANS = [
    ("engine.run", 10.0, 90.0, 0.0),
    ("engine.init", 12.0, 18.0, 0.0),
    ("engine.window", 20.0, 80.0, 5.0),
    ("engine.counters", 30.0, 50.0, 15.0),
    ("engine.counters", 60.0, 70.0, 5.0),
    ("engine.pull", 82.0, 88.0, 0.0),
]
DEVICE = [(25.0, 30.0), (32.0, 47.0), (62.0, 67.0), (92.0, 97.0)]
BOUNDS = (0.0, 100.0)
WINDOW_S = 110e-6
BUSY_S = 30e-6


@pytest.fixture
def rows():
    return spans.table(SPANS, DEVICE, WINDOW_S, BOUNDS)


def test_device_time_inclusive_and_self_by_hand(rows):
    assert rows["engine.counters"]["count"] == 2
    assert rows["engine.counters"]["device_s"] == pytest.approx(20e-6)
    assert rows["engine.counters"]["self_device_s"] == pytest.approx(20e-6)
    assert rows["engine.window"]["device_s"] == pytest.approx(25e-6)
    assert rows["engine.window"]["self_device_s"] == pytest.approx(5e-6)
    assert rows["engine.run"]["device_s"] == pytest.approx(25e-6)
    assert rows["engine.run"]["self_device_s"] == 0.0
    assert rows[spans.NO_SPAN]["self_device_s"] == pytest.approx(5e-6)
    assert rows["engine.window"]["host_s"] == pytest.approx(60e-6)


def test_idle_at_gaps_head_tail_and_outside_spans_by_hand(rows):
    # counters: 20 - 15 and 10 - 5 inside their ranges
    assert rows["engine.counters"]["idle_s"] == pytest.approx(10e-6)
    # the window's own gaps: 20-25, 50-60 and 70-80, outside its scans
    assert rows["engine.window"]["idle_s"] == pytest.approx(25e-6)
    assert rows["engine.window"]["idle_incl_s"] == pytest.approx(35e-6)
    assert rows["engine.init"]["idle_s"] == pytest.approx(6e-6)
    assert rows["engine.pull"]["idle_s"] == pytest.approx(6e-6)
    # the run's own: 10-12, 18-20, 80-82, 88-90
    assert rows["engine.run"]["idle_s"] == pytest.approx(8e-6)
    # head 0-10, tail 90-92 and 97-100
    assert rows[spans.NO_SPAN]["idle_s"] == pytest.approx(15e-6)
    assert rows[spans.REMAINDER]["idle_s"] == pytest.approx(10e-6)


def test_the_table_accounts_for_the_trace(rows):
    acc = spans.accounting(rows, BUSY_S, WINDOW_S)
    assert acc["device_over_busy"] == pytest.approx(1.0)
    assert acc["idle_over_window_idle"] == pytest.approx(1.0)
    assert acc["run_share_of_busy"] == pytest.approx(25 / 30)


def test_per_batch_figures_by_hand(rows):
    got = spans.per_batch(rows, WINDOW_S)
    assert got["counters_ms"] == pytest.approx(0.01)
    assert got["gather_ms"] is None
    assert got["loop_idle_pct"] == pytest.approx(100 * 35 / 110)
    assert got["state_io_ms"] == pytest.approx(0.012)


def test_no_spans_leave_only_the_two_closing_rows():
    rows = spans.table([], DEVICE, WINDOW_S, BOUNDS)
    assert set(rows) == {spans.NO_SPAN, spans.REMAINDER}
    assert rows[spans.NO_SPAN]["self_device_s"] == pytest.approx(BUSY_S)
    assert rows[spans.NO_SPAN]["idle_s"] == pytest.approx(70e-6)
    assert spans.per_batch(rows, WINDOW_S) == {
        "counters_ms": None, "gather_ms": None, "loop_idle_pct": None, "state_io_ms": None,
    }


def _ev(name, a, b, ident=0, parent=None, device=False, user=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b), id=ident,
                           cpu_parent=parent, device_type="cuda" if device else "cpu",
                           is_user_annotation=user)


def test_device_events_reach_their_span_through_the_launching_call():
    run = _ev("engine.run", 0.0, 100.0, ident=1)
    counters = _ev("engine.counters", 10.0, 50.0, ident=2, parent=run)
    cumsum = _ev("aten::cumsum", 12.0, 40.0, ident=7, parent=counters)
    events = [
        run, counters, cumsum,
        _ev("cudaLaunchKernel", 13.0, 14.0, ident=7, parent=cumsum),
        _ev("scan", 20.0, 30.0, ident=7, device=True),
        # an op and an overhead event that share the kernel's number: not its launcher
        _ev("aten::add", 60.0, 70.0, ident=7, parent=run),
        _ev("Activity Buffer Request", 61.0, 62.0, ident=7, parent=run),
        # a device twin of a user annotation: left out
        _ev("engine.counters", 20.0, 30.0, ident=2, device=True, user=True),
        # launched outside every span, and one with no launcher in the trace
        _ev("cudaMemcpyAsync", 101.0, 102.0, ident=9),
        _ev("Memcpy DtoH", 103.0, 105.0, ident=9, device=True),
        _ev("orphan", 106.0, 107.0, ident=11, device=True),
    ]
    rows = spans.from_events(events, 120e-6, "cuda")
    assert rows["engine.counters"]["self_device_s"] == pytest.approx(10e-6)
    assert rows["engine.run"]["device_s"] == pytest.approx(10e-6)
    assert rows["engine.run"]["self_device_s"] == 0.0
    assert rows[spans.NO_SPAN]["self_device_s"] == pytest.approx(3e-6)
    # idle: 0-20 and 30-100 under the spans, 100-103, 105-106 outside
    assert rows["engine.counters"]["idle_s"] == pytest.approx(30e-6)
    assert rows["engine.run"]["idle_s"] == pytest.approx(60e-6)
    assert rows[spans.NO_SPAN]["idle_s"] == pytest.approx(4e-6)
    assert rows[spans.REMAINDER]["idle_s"] == pytest.approx(13e-6)
    acc = spans.accounting(rows, 13e-6, 120e-6)
    assert acc["device_over_busy"] == pytest.approx(1.0)
    assert acc["idle_over_window_idle"] == pytest.approx(1.0)


def test_the_table_of_a_tiny_cell_profiled_on_the_cpu():
    rep = spans.profile_cell(ROOT, tiny_cell("livj-8p.sssp16"), 2**31 + 23, "cpu", "torch")
    rows, calls = rep["spans"], rep["relax_traced"]
    assert calls["batches"] == 1 and rep["busy_s"] == 0.0
    assert rows["engine.run"]["count"] == 1
    assert rows["engine.relax"]["count"] == calls["local_calls"] + calls["remote_calls"]
    assert rows["engine.closure"]["count"] == calls["local_calls"]
    assert rows["engine.exchange"]["count"] == calls["remote_calls"]
    assert rows["engine.host_read"]["count"] == rep["counters"]["engine.host_syncs"] - 1
    assert rep["span_device_ops"] == []
    # nothing ran on a device: every idle second of the window is in a row
    assert rep["accounting"]["idle_over_window_idle"] == pytest.approx(1.0)
    assert rows["engine.run"]["host_s"] <= rep["window_s"]
    assert rep["per_batch"]["counters_ms"] is None
    assert rep["per_batch"]["scan_elems_per_batch"] == rep["counters"]["engine.scan_elems"] > 0


def test_scan_elems_reader_by_hand_and_without_the_counter():
    read = spec.metric_reader(ROOT, "scan_elems_per_batch.batch")
    record = {"counters": {"engine.scan_elems": 900}, "loop": {"batches": 3}}
    assert read(record) == 300
    assert read({"counters": {}, "loop": {"batches": 3}}) is None
    assert read({"counters": {"engine.scan_elems": 900}, "loop": {}}) is None


def test_a_traced_tiny_run_reports_the_scan_per_batch():
    result, record = run_tiny("livj-8p.sssp16", trace=True)
    got = result["metrics"]["scan_elems_per_batch.batch"]
    assert got["unit"] == "elements"
    assert got["value"] == record["counters"]["engine.scan_elems"] / record["loop"]["batches"] > 0
