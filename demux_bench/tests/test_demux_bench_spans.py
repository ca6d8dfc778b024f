"""The program's spans files (``demux_bench/spans.py``) on a hand-made run:
a profiler trace with the ``phq.clock`` annotation and spans files from
two processes and a third (a second render worker). The anchor's offset
moves every span; spans are cut to the window; self time; the five
span readers; the idle gap named by the span over it; and ``trace.load``
still takes the profiler's trace with spans files beside it. Then a
whole traced run of the cut cell on the CPU: the run hands the program's
spans to the five readers, and its breakdown names the gaps by span."""

import json
import os
from types import SimpleNamespace

import pytest

from demux_bench import cells, run as runs, spans, trace
from demux_bench.tests.shapes import small

BASE_NS = 1_700_000_000_000_000_000
BASE_S = BASE_NS / 1e9
#: the profiler's clock runs this far ahead of the wall clock the spans read
OFFSET_S = 0.002
#: (pid, tid, name, start, stop, id, parent) on the profiler's clock, seconds after BASE
SPANS = [
    (100, 100, "phq.setup.compile", 0.1, 0.4, 1, 0),
    (100, 100, "phq.dispatch.ingest_wait", 0.9, 1.1, 2, 0),
    (100, 100, "phq.dispatch.launch", 1.1, 1.2, 3, 0),
    (100, 100, "phq.pull.wait", 1.2, 1.7, 4, 0),
    (100, 100, "phq.finish", 1.7, 2.2, 5, 0),
    (100, 100, "phq.host.rules", 1.8, 1.9, 6, 5),
    (100, 101, "phq.write.batch", 1.3, 1.5, 7, 0),
    (200, 200, "phq.render.batch", 1.2, 1.5, 1, 0),
    (200, 200, "phq.render.wait", 1.5, 1.8, 2, 0),
    (201, 201, "phq.render.batch", 1.9, 2.3, 1, 0),
]
METRICS = {
    "config_compile_s": 0.3,
    "ingest_wait_share": 10.0,  # 1.0-1.1 of the window 1.0-2.0
    "dispatch_busy_share": 40.0,  # the main thread covers it all, less 0.1 + 0.5 of waits
    "render_busy_share": 20.0,  # 0.3 + 0.1 over two workers
    "writer_busy_share": 20.0,
}


def write_run(directory):
    device = [
        {"ph": "X", "cat": "kernel", "name": "phq_pamld_kernel", "ts": 0.9e6, "dur": 0.6e6},
        {"ph": "X", "cat": "kernel", "name": "phq_pamld_kernel", "ts": 1.6e6, "dur": 0.5e6},
        {"ph": "X", "cat": "user_annotation", "name": "phq.clock", "ts": 0.5e6, "dur": 5.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaEventSynchronize", "ts": 1.45e6, "dur": 0.2e6},
    ]
    (directory / "pheniqs_100.trace.json").write_text(
        json.dumps({"baseTimeNanoseconds": BASE_NS, "traceEvents": device}))
    for pid in (100, 200, 201):
        events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": pid, "args": {"name": "MainThread"}}]
        for p, tid, name, start, stop, ident, parent in SPANS:
            if p == pid:
                events.append({"ph": "X", "cat": "phq", "name": name, "pid": pid, "tid": tid,
                               "ts": (start - OFFSET_S) * 1e6, "dur": (stop - start) * 1e6,
                               "args": {"id": ident, "parent": parent, "raw_index": 0}})
        anchor = {"name": "phq.clock", "ns": BASE_NS + int((0.5 - OFFSET_S) * 1e9)} if pid == 100 else None
        (directory / f"pheniqs_{pid}.spans.json").write_text(
            json.dumps({"baseTimeNanoseconds": BASE_NS, "anchor": anchor, "traceEvents": events}))
    # the spans files are the newest, as a worker writes its own last
    os.utime(directory / "pheniqs_100.trace.json", (1, 1))


@pytest.fixture
def run(tmp_path):
    write_run(tmp_path)
    start, stop = BASE_S + 1.0, BASE_S + 2.0
    return SimpleNamespace(spans=spans.load(str(tmp_path), start, stop),
                           trace=trace.load(str(tmp_path), start, stop))


def test_anchor_offset_moves_every_span(run):
    assert run.spans.offset_s == pytest.approx(OFFSET_S, abs=1e-6)
    launch = run.spans.named("phq.dispatch.launch")[0]
    assert launch.start == pytest.approx(BASE_S + 1.1, abs=1e-6)
    assert run.spans.named("phq.render.batch")[1].stop == pytest.approx(BASE_S + 2.3, abs=1e-6)


def test_spans_clipped_to_the_window(run):
    assert run.spans.seconds("phq.dispatch.ingest_wait") == pytest.approx(0.1, abs=1e-6)
    assert run.spans.seconds("phq.finish") == pytest.approx(0.3, abs=1e-6)
    assert run.spans.seconds("phq.setup.compile") == 0.0
    assert run.spans.main_thread() == (100, 100)
    assert run.spans.render_workers() == {200, 201}


def test_self_time_leaves_out_children(run):
    finish = run.spans.named("phq.finish")[0]
    assert [c.name for c in run.spans.children(finish)] == ["phq.host.rules"]
    assert run.spans.self_s(finish) == pytest.approx(0.2, abs=1e-6)
    assert run.spans.self_s(run.spans.named("phq.pull.wait")[0]) == pytest.approx(0.5, abs=1e-6)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_span_readers(run, name):
    read = cells.reader(name)
    assert read(run) == pytest.approx(METRICS[name], abs=1e-4)
    # a run without spans (the profiler's trace alone) reads nothing, raising nothing
    assert read(SimpleNamespace()) is None
    assert read(SimpleNamespace(spans=None)) is None


def test_idle_gap_named_by_the_span_over_it(run):
    gaps = spans.idle_gaps_by_span(run.trace, run.spans)
    assert len(gaps) == 1
    assert gaps[0][0] == "phq.pull.wait" and gaps[0][1] == pytest.approx(0.1, abs=1e-6)
    # the profiler's own naming is left as it is
    assert run.trace.breakdown()["idle_gaps"][0][0] == "cudaEventSynchronize"
    assert spans.idle_gaps_by_span(run.trace, None) is None


def test_trace_load_takes_the_profilers_trace(run, tmp_path):
    assert run.trace is not None and run.trace.covers()
    assert {name for name, *_ in run.trace.device} == {"phq_pamld_kernel"}
    assert spans.load(str(tmp_path / "none"), 0, 1) is None


@pytest.fixture(scope="module")
def traced_cpu_run():
    """A whole traced run of the cut cell on the CPU (the program's plain
    kernels, its profiler and spans on)."""
    outcome, numbers, _ = runs.run_cell(small("tenx-v2-fast"), 20261019, 1.0, traced=True, device="cpu")
    return outcome, numbers


def test_traced_run_loads_the_programs_spans(traced_cpu_run):
    outcome, numbers = traced_cpu_run
    assert outcome.spans is not None and outcome.spans.main_thread() is not None
    assert (outcome.spans.start, outcome.spans.stop) == (outcome.opened_wall, outcome.closed_wall)
    line = runs.result_line(outcome, numbers, True, {})
    assert line["correct"], numbers
    gaps = line["breakdown"]["idle_gaps_by_span"]
    assert gaps and all(name.startswith("phq.") and seconds > 0 for name, seconds in gaps)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_span_readers_read_a_traced_run(traced_cpu_run, name):
    outcome, numbers = traced_cpu_run
    value = cells.reader(name)(outcome)
    assert isinstance(value, float) and value >= 0.0
    assert name in runs.metrics(outcome, True)
