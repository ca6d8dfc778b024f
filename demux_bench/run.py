"""One run of a cell: render the traffic, run the program through pipes,
measure the window, check the answers, print one JSON line.

    python3 -m demux_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Standard output's last line is the result; standard error carries the
per-batch times and what was compared, and ends with each number
compared beside its limit. The run exits non-zero, with no result, where
there is no card (or fewer than the cell asks for), where the program
fails or its window does not open by the traffic's ``setup_deadline_s``
(seconds from the launch, where the mix sets one), and where ``jax``,
``jaxlib``, ``flax`` or ``pheniqs_tpu`` is loaded in this process once
the window has closed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field

from . import cells, check, pipes, proc, report as reports, spans, traffic, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "pheniqs_tpu")
#: the longest a run may wait on the program, compiling included; a
#: traffic mix may also bound the set-up alone (``setup_deadline_s``)
DEADLINE_S = 1100.0


@dataclass
class Run:
    """What one run measured; the metric readers take their numbers from it."""

    cell: cells.Cell
    seconds: float
    launched: float = 0.0
    opened: float | None = None
    closed: float | None = None
    opened_wall: float = 0.0
    closed_wall: float = 0.0
    window_records: int = 0
    cpu: list = field(default_factory=list)
    pids: set = field(default_factory=set)
    memory: list = field(default_factory=list)
    sent_batches: int = 0
    records_out: int = 0
    child_wall_s: float = 0.0
    stderr: str = ""
    report: reports.Report | None = None
    trace: trace.Window | None = None
    spans: spans.Spans | None = None
    instrument: traffic.Instrument | None = None

    @property
    def setup_s(self) -> float:
        return self.opened - self.launched

    @property
    def window_s(self) -> float:
        return self.closed - self.opened


def child_env(root: str, device: str, traced: bool, workdir: str) -> dict:
    """The program's environment: the harness's, less the program's own
    switches (so it runs its default batch transport, whose slots live in
    /dev/shm), plus the device, the fixed kernel cache directory inside
    the checkout and, in a traced run, the program's profiler."""
    env = dict(os.environ)
    for name in ("PHENIQS_PROFILE", "PHENIQS_TRACE", "PHENIQS_STREAM_TRANSPORT"):
        env.pop(name, None)
    env.update(
        PHENIQS_TORCH_DEVICE=device,
        TRITON_CACHE_DIR=os.path.join(root, "demux_bench", ".cache", "triton"),
        PYTHONPATH=os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")])),
    )
    if traced:
        env.update(PHENIQS_PROFILE=os.path.join(workdir, "profile"))
    return env


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
             program: list[str] | None = None):
    """Run the program over the cell's traffic; returns (Run, numbers
    compared, what was compared). Raises RuntimeError where the program
    fails."""
    config, plan = cell.config, cell.traffic
    root, log = str(cells.ROOT), sys.stderr
    began = time.perf_counter()
    inst = traffic.instrument(config, seed, plan)
    batches = traffic.pool(inst, plan, seed)
    n, pool_size, warmup = plan["batch_size"], plan["pool_batches"], plan["warmup_batches"]
    capture_batch = math.ceil(warmup / pool_size) * pool_size
    run = Run(cell, seconds, instrument=inst)
    setup_deadline = plan.get("setup_deadline_s")
    workdir = tempfile.mkdtemp(prefix="demux_bench-")
    try:
        inputs = [os.path.join(workdir, f"in_s{s + 1:02d}.fastq") for s in range(len(inst.segments))]
        output = os.path.join(workdir, "out.sam")
        report = os.path.join(workdir, "report.json")
        for path in inputs + [output]:
            os.mkfifo(path)
        job = os.path.join(workdir, "job.json")
        traffic.write_instruction(job, inst, inputs, output, report)
        feeder = pipes.Feeder(inputs, traffic.Stream(inst, batches))
        feeder.minimum = capture_batch + pool_size
        child = None

        def on_open(now):
            run.opened, run.opened_wall = now, time.time()
            run.cpu.append(proc.tree_cpu(child.pid))

        def on_close(now):
            run.closed, run.closed_wall = now, time.time()
            run.cpu.append(proc.tree_cpu(child.pid))
            feeder.stop()
            sampler.start()

        sampler = threading.Thread(target=lambda: run.memory.append(proc.device_memory_bytes()),
                                   daemon=True)

        drain = pipes.Drain(output, n, warmup, seconds, capture_batch * n, pool_size * n, on_open, on_close)
        built = proc.kernels_built(root)
        command = (program or [sys.executable, "-m", "pheniqs_tpu_torch"]) + [
            "mux", "--config", job, "--fidelity", plan["fidelity"],
            "--threads", str(plan["threads"]), "--batch-size", str(n),
        ]
        errors = os.path.join(workdir, "child.err")
        with open(errors, "wb") as err:
            run.launched = time.perf_counter()
            child = subprocess.Popen(command, cwd=root, env=child_env(root, device, traced, workdir),
                                     stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
                                     stderr=err, start_new_session=True)
        drain.start()
        feeder.start()
        failed = None
        looked = 0.0
        try:
            while child.poll() is None:
                if time.perf_counter() - looked >= proc.LOOK_S:  # the program's processes, for shm_left
                    looked = time.perf_counter()
                    run.pids |= proc.tree_cpu(child.pid)[1]
                waited = time.perf_counter() - run.launched
                if waited > DEADLINE_S:
                    failed = "the program passed the run's deadline"
                    break
                if setup_deadline is not None and run.opened is None and waited > setup_deadline:
                    failed = f"the window did not open within {setup_deadline:g} s of the launch"
                    break
                if feeder.errors or drain.error:
                    failed = "; ".join(feeder.errors + [drain.error or ""])
                    break
                time.sleep(0.05)
        finally:
            if child.poll() is None:
                os.killpg(child.pid, signal.SIGKILL)
                child.wait()
            try:  # render workers the program left behind
                os.killpg(child.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            run.child_wall_s = time.perf_counter() - run.launched
            feeder.abort()
            drain.poke()
            feeder.join(30)
            drain.join(30)
            if sampler.is_alive() or run.closed is not None:
                sampler.join(60)
        run.pids |= set().union(*(pids for _, pids in run.cpu), {child.pid})
        with open(errors, encoding="utf-8", errors="replace") as stream:
            run.stderr = stream.read()
        if failed is None and child.returncode != 0:
            failed = f"the program exited {child.returncode}"
        if failed is None and run.closed is None:
            failed = "the program ended before the window closed"
        if failed is not None:
            raise RuntimeError(f"{failed}\n{run.stderr[-6000:]}")
        run.sent_batches = feeder.stop_at
        run.records_out = drain.records
        run.window_records = drain.window_records
        reading = time.perf_counter()
        run.report = reports.read(report, check.counted(inst))
        report_s = time.perf_counter() - reading
        if traced:
            profile = os.path.join(workdir, "profile")
            run.trace = trace.load(profile, run.opened_wall, run.closed_wall)
            run.spans = spans.load(profile, run.opened_wall, run.closed_wall)
        shm = proc.shm_left(run.pids)
        checking = time.perf_counter()
        for line in run.stderr.splitlines():
            if line.startswith("[pheniqs-tpu]"):
                print(line, file=log)
        print(json.dumps({"batch_s": [round(b - a, 4) for a, b in zip(drain.batch_times, drain.batch_times[1:])],
                          "first_record_s": round(drain.first_record - run.launched, 3),
                          "render_s": round(run.launched - began, 3),
                          "exit_after_close_s": round(run.launched + run.child_wall_s - run.closed, 3),
                          "kernels_built_before": built, "sent_batches": run.sent_batches,
                          "shm_left": shm}), file=log)
        numbers, seen = check.compare(
            inst, batches, plan["check"], b"".join(drain.kept), capture_batch * n, pool_size * n,
            n, run.sent_batches, run.records_out, run.report, device=reference_device(device))
        numbers["shm_left"] = len(shm)
        seen["check_s"] = round(time.perf_counter() - checking, 3)
        seen["report_read_s"] = round(report_s, 3)
        return run, numbers, seen
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def reference_device(device: str) -> str:
    import torch

    return "cuda" if device == "cuda" and torch.cuda.is_available() else "cpu"


def metrics(run: Run, traced: bool) -> dict:
    out = {}
    for metric in run.cell.per_layer if traced else run.cell.end_to_end:
        value = cells.reader(metric["name"])(run)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def result_line(run: Run, numbers: dict, traced: bool, device: dict) -> dict:
    limits = run.cell.traffic["check"]["limits"]
    correct = all(numbers[name] <= limits[name] for name in limits)
    failed = numbers["missing"] + numbers["decisions_apart"]
    line = {
        "correct": correct,
        "attempted": run.sent_batches * run.cell.traffic["batch_size"],
        "failed": failed,
        "metrics": metrics(run, traced),
        "device": device,
    }
    if traced and run.trace is not None:
        line["breakdown"] = run.trace.breakdown()
        by_span = spans.idle_gaps_by_span(run.trace, run.spans)
        if by_span is not None:
            line["breakdown"]["idle_gaps_by_span"] = by_span
    line["limits"] = {name: {"value": numbers[name], "limit": limits[name]} for name in limits}
    return line


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m demux_bench")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = cells.load(args.workload)
    if not (cells.ROOT / "pheniqs_tpu_torch").is_dir():
        print("no pheniqs_tpu_torch beside the benchmark", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"the cell needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 3
    traced = bool(args.trace)
    try:
        run, numbers, seen = run_cell(cell, args.seed % (1 << 64), args.seconds, traced)
    except RuntimeError as error:
        print(f"run failed: {error}", file=sys.stderr)
        return 1
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": cell.chips,
        "memory_peak_bytes": max([m for m in run.memory if m is not None], default=0),
    }
    if traced:
        if run.trace is None or not run.trace.covers():
            print("the trace does not cover the window", file=sys.stderr)
            return 1
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
    line = result_line(run, numbers, traced, device)
    loaded = sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"loaded in the harness: {', '.join(loaded)}", file=sys.stderr)
        return 4
    print(json.dumps({"compared": seen, "power": proc.power_limit(),
                      "window_s": run.window_s, "window_records": run.window_records}), file=sys.stderr)
    for name, entry in line["limits"].items():
        print(f"{name} {entry['value']} (limit {entry['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
