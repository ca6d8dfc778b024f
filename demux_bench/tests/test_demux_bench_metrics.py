"""The metric arithmetic on hand-made inputs: PAMLD's operation count and
roofline, CPU seconds a million reads, and the device's idle share over a
synthetic trace with gaps; the /dev/shm entries a run counts as its own."""

import json
from types import SimpleNamespace

import pytest

from demux_bench import cells, readers, roofline, trace


def test_pamld_operations():
    # the whitelist step: 4 N B (W + 1) over 67 TFLOP/s = 98.08 ms
    ops = roofline.pamld_ops(131072, 737280, 16)
    assert ops == 4 * 131072 * 737280 * 17
    assert roofline.bound_s(ops, roofline.pamld_bytes(131072, 737280, 16)) == pytest.approx(0.09808, rel=1e-3)


def synthetic_trace(tmp_path):
    base_ns = 1_700_000_000_000_000_000
    events = [
        {"ph": "X", "cat": "kernel", "name": "phq_pamld_kernel", "ts": 0.0, "dur": 400_000.0},
        {"ph": "X", "cat": "kernel", "name": "phq_pamld_merge_kernel", "ts": 400_000.0, "dur": 100_000.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 450_000.0, "dur": 100_000.0},
        {"ph": "X", "cat": "kernel", "name": "phq_pack_kernel", "ts": 800_000.0, "dur": 300_000.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 550_000.0, "dur": 250_000.0},
    ]
    (tmp_path / "p.trace.json").write_text(json.dumps({"baseTimeNanoseconds": base_ns, "traceEvents": events}))
    start = base_ns / 1e9
    return trace.load(str(tmp_path), start + 0.1, start + 1.0)


def test_idle_share_over_gaps(tmp_path):
    window = synthetic_trace(tmp_path)
    assert window.covers() and window.window_s == pytest.approx(0.9)
    # busy: 0.1-0.55 and 0.8-1.0 (clipped) = 0.65 of 0.9
    assert window.busy_s() == pytest.approx(0.65)
    assert readers.idle_share(SimpleNamespace(trace=window)) == pytest.approx(100 * 0.25 / 0.9)
    gaps = window.breakdown()["idle_gaps"]
    assert gaps[0][0] == "aten::copy_" and gaps[0][1] == pytest.approx(0.25)
    assert window.breakdown()["device_ops"][0][0] == "phq_pamld_kernel"


def test_pamld_roofline_and_mfu(tmp_path):
    window = synthetic_trace(tmp_path)
    inst = SimpleNamespace(pamld=lambda: [SimpleNamespace(barcodes=737280, width=16)])
    run = SimpleNamespace(trace=window, instrument=inst, window_records=131072, window_s=0.9,
                          cell=SimpleNamespace(traffic={"batch_size": 131072}))
    # K7's 98.08 ms of work over 0.3 + 0.1 s of pamld kernels in the window,
    # and over the 0.65 s in which the card ran anything
    assert readers.pamld_roofline(run) == pytest.approx(100 * 0.09808 / 0.4, rel=1e-3)
    assert readers.step_mfu(run) == pytest.approx(100 * 0.09808 / 0.65, rel=1e-3)
    assert readers.step_mfu(SimpleNamespace(trace=None)) is None


def test_host_cpu_a_million_reads():
    read = cells.reader("host_cpu_s_per_mread")
    run = SimpleNamespace(cpu=[(10.0, {1}), (34.0, {1, 2})], window_records=2_000_000)
    assert read(run) == pytest.approx(12.0)


def test_shm_left_counts_only_the_programs_entries(tmp_path, monkeypatch):
    from demux_bench import proc

    for name in ("pheniqs-101-a", "pheniqs-102-out-b", "pheniqs-1010-c", "pheniqs-7-d", "other-101-e"):
        (tmp_path / name).write_bytes(b"")
    monkeypatch.setattr(proc, "SHM", str(tmp_path))
    # another run's live or dead entries (pids 1010 and 7) are not this run's
    assert proc.shm_left({101, 102}) == ["pheniqs-101-a", "pheniqs-102-out-b"]
    assert proc.shm_left(set()) == []
