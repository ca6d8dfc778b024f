"""A whole run on the CPU at a size a test can hold (the program's plain
kernels, 512-read batches): sound, it comes out correct; with the timed
path broken underneath (tests/faulty_mux.py), or with the bfloat16
control in the program's place, it does not. The look for a card is
skipped; everything else is the run's. Each cell of BENCHMARK.json is
run so, and a two-round combinatorial instrument whose two cellular
decoders the check holds as the program tags them (tests/shapes.py). A
program that stalls before it reads any input ends the run at the
traffic's ``setup_deadline_s``, its whole process group with it."""

import sys
import time
from pathlib import Path

import pytest

from demux_bench import cells, check, run, traffic
from demux_bench.tests.shapes import CELLS, INSTRUMENTS, small

FAULTY = str(Path(__file__).with_name("faulty_mux.py"))


def correct(cell, program=None, seed=20261018):
    outcome, numbers, _ = run.run_cell(cell, seed, 1.0, traced=False, device="cpu", program=program)
    line = run.result_line(outcome, numbers, False, {})
    return line["correct"], numbers


@pytest.mark.parametrize("workload", INSTRUMENTS)
def test_sound_run_is_correct(workload):
    ok, numbers = correct(small(workload))
    assert ok, numbers


@pytest.mark.parametrize("workload", INSTRUMENTS)
@pytest.mark.parametrize("fault, broken", [
    ("unchanged", "decisions_apart"), ("half", "missing"), ("altered", "decisions_apart")])
def test_fault_is_caught(workload, fault, broken):
    ok, numbers = correct(small(workload), program=[sys.executable, FAULTY, fault])
    assert not ok and numbers[broken] > 0, numbers


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_is_caught(workload):
    # 16384 reads; the whitelist's shape at 8064 barcodes, summed as the
    # reference sums the whitelist (a product of one-hot rows)
    cell = cells.load(workload)
    cell.traffic.update(batch_size=4096, pool_batches=4)
    cell.config["decoders"][1]["barcodes"] = 192 * 42
    cell.traffic["vary"]["barcodes"] = 192 * 42
    inst = traffic.instrument(cell.config, 7, cell.traffic)
    numbers, _ = check.control(inst, traffic.pool(inst, cell.traffic, 7), cell.traffic["check"], 10)
    limits = cell.traffic["check"]["limits"]
    assert any(numbers[name] > limits[name] for name in numbers), numbers


def alive(pid):
    """Whether `pid` runs (a zombie has ended)."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as stream:
            text = stream.read()
    except OSError:
        return False
    return text[text.rindex(b")") + 2:][:1] != b"Z"


def test_setup_deadline_ends_a_stalled_program(tmp_path, monkeypatch):
    pids = tmp_path / "pids"
    monkeypatch.setenv("STALL_PIDS", str(pids))
    monkeypatch.setattr(run, "DEADLINE_S", 60.0)  # a run that misses the deadline fails sooner
    cell = small("tenx-v2-fast")
    cell.traffic["setup_deadline_s"] = 5
    began = time.perf_counter()
    with pytest.raises(RuntimeError, match="the window did not open within 5 s of the launch"):
        run.run_cell(cell, 20261019, 1.0, traced=False, device="cpu",
                     program=[sys.executable, FAULTY, "stall"])
    assert time.perf_counter() - began < 5 + 30
    stalled = [int(pid) for pid in pids.read_text().split()]
    assert len(stalled) == 2
    assert not any(alive(pid) for pid in stalled), stalled
