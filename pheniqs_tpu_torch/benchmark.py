"""End-to-end benchmark of the port: FASTQ in, classified + tagged SAM
out, through the port's hybrid engine (device classification + f64
boundary re-resolution + streamed render workers) on the flagship
instrument (device/flagship.py) written out as real FASTQ files.

Port of ``pheniqs_tpu.benchmark``'s ``synthesize_fastq_input`` and
``run_e2e``, with the same stats keys; the device is an explicit argument,
and so is the ontology (the flagship by default; its MDD and whitelist
variants run the port's other decoders on the same read layout).

As a program it runs the paths at a chosen size and prints one JSON line
of stats per run:

    python -m pheniqs_tpu_torch.benchmark flagship:hybrid mdd:hybrid mdd:null --reads 4000000
    python -m pheniqs_tpu_torch.benchmark whitelist:fast --reads 1048576 --profile
    python -m pheniqs_tpu_torch.benchmark mdd:strict mdd:hybrid whitelist:fast --reads 262144 --cli

``--devices N`` caps the cards the device engines cut each batch over
(every local card by default; the ontology's ``"devices"``);
``--profile`` adds the device time of the run's PHENIQS_PROFILE trace
(and PHENIQS_TRACE's stage seconds on standard error);
``--cli`` runs each through ``python -m pheniqs_tpu_torch mux`` instead;
a run after its path's strict run counts the records whose decisions
differ from strict's.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

from .device.flagship import (
    SEGMENT_WIDTHS,
    flagship_ontology,
    mdd_flagship_ontology,
    panel_codes,
    synthetic_batch,
    whitelist_flagship_ontology,
    wide_flagship_ontology,
    wide_mdd_ontology,
)

#: the paths the program runs, by name
ONTOLOGIES = {
    "flagship": flagship_ontology,
    "mdd": mdd_flagship_ontology,
    "whitelist": whitelist_flagship_ontology,
    "wide": wide_flagship_ontology,
    "wide-mdd": wide_mdd_ontology,
}

def synthesize_fastq_input(
    directory: str,
    n_reads: int,
    seed: int = 20260818,
    chunk: int = 1 << 17,
    ontology: dict | None = None,
    panels=None,
) -> list[str]:
    """Write the flagship workload (reads drawn from the panels of
    `ontology`, the flagship's by default; `panels` its panel_codes where
    the caller holds them) as 4 per-segment FASTQ files (R1, I7, I5, R2).
    Returns their paths; a finished set for the same (directory, size,
    seed) is reused."""
    from .native import fastq_format_batch

    directory = f"{directory}_{n_reads}_{seed}"
    os.makedirs(directory, exist_ok=True)
    paths = [
        os.path.join(directory, f"flagship_s{s + 1:02d}.fastq")
        for s in range(len(SEGMENT_WIDTHS))
    ]
    marker = os.path.join(directory, f".complete_{n_reads}_{seed}")
    if os.path.exists(marker) and all(os.path.exists(p) for p in paths):
        return paths

    ontology = ontology if ontology is not None else flagship_ontology()
    panels = panel_codes(ontology) if panels is None else panels
    streams = [open(p, "wb") for p in paths]
    try:
        written = 0
        part = 0
        while written < n_reads:
            n = min(chunk, n_reads - written)
            batch = synthetic_batch(ontology, n, seed=seed + part, panels=panels)
            name_list = [b"r%d" % (written + i) for i in range(n)]
            names = b"".join(name_list)
            offsets = np.zeros(n + 1, dtype=np.int64)
            np.cumsum([len(x) for x in name_list], out=offsets[1:])
            qcfail = np.zeros(n, dtype=np.uint8)
            for s, stream in enumerate(streams):
                code, qual, length = batch["segments"][s]
                rendered = fastq_format_batch(
                    names, offsets, qcfail, 0,
                    np.ascontiguousarray(code.astype(np.uint8)),
                    np.ascontiguousarray(qual.astype(np.uint8)),
                    length, 33, None,
                )
                if rendered is not None:
                    stream.write(rendered[0])
                    continue
                # native library unavailable: render in Python
                from .iupac import BAM_TO_ASCII

                seqs = BAM_TO_ASCII[code.astype(np.uint8) & 0xF]
                phred = (qual.astype(np.uint8) + 33).astype(np.uint8)
                out = bytearray()
                for i in range(n):
                    width = int(length[i])
                    out += b"@" + name_list[i] + b"\n"
                    out += seqs[i, :width].tobytes() + b"\n+\n"
                    out += phred[i, :width].tobytes() + b"\n"
                stream.write(bytes(out))
            written += n
            part += 1
    finally:
        for stream in streams:
            stream.close()
    open(marker, "w").close()
    return paths


def instruction(paths: list[str], output_url: str, base: dict) -> dict:
    """The flagship instruction: reads from `paths`, the decoders of
    `base`, one output."""
    return {
        "input": list(paths),
        "template": {"transform": {"token": ["0::"]}},
        "sample": base["sample"],
        "cellular": base["cellular"],
        "molecular": base["molecular"],
        "output": [output_url],
        "report url": "/dev/null",
    }


def e2e_ontology(paths: list[str], output_url: str, threads: int, base: dict | None = None) -> dict:
    """Compile the flagship instruction (decoders from `base`, the
    flagship's by default) against real input feeds through the port's
    job and config compiler."""
    import tempfile

    from .cli.interface import Interface
    from .job import TranscodeJob

    base = base if base is not None else flagship_ontology()
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as handle:
        # one string: json.dump streams through the pure-Python encoder,
        # 3x slower on a whitelist-sized codec
        handle.write(json.dumps(dict(instruction(paths, output_url, base), threads=threads)))
        config_path = handle.name
    try:
        interface = Interface(
            ["pheniqs-tpu", "mux", "--config", config_path, "--threads", str(threads)]
        )
        job = TranscodeJob(interface.operation())
        job.compiler.assemble()
        return job.compiler.compile()
    finally:
        os.unlink(config_path)


def with_inputs(compiled: dict, paths: list[str]) -> dict:
    """`compiled` (an instruction e2e_ontology compiled) reading `paths`,
    files of the same layout, in place of its own inputs: its input URLs
    and input feeds replaced, every other part shared with it. So a
    whitelist-sized codec, ~80 s of compiling, serves runs over several
    inputs."""
    if len(paths) != len(compiled["input"]):
        raise ValueError(f"with_inputs: {len(paths)} paths for {len(compiled['input'])} inputs")
    urls = {url: os.path.abspath(path) + url[len(url.split("?")[0]):] for url, path in zip(compiled["input"], paths)}
    feeds: dict = {}
    feed = dict(compiled["feed"])
    for key in ("input feed", "input feed by segment"):
        feed[key] = [feeds.setdefault(id(f), dict(f, url=urls[f["url"]])) for f in feed[key]]
    return dict(compiled, input=[urls[url] for url in compiled["input"]], feed=feed)


class _TimedMixin:
    """A wall-clock timestamp and cumulative read count after each batch
    completes its host-side consumption."""

    def _init_timeline(self):
        self.timeline: list[tuple[float, int]] = []
        self._timeline_reads = 0

    def _note_batch(self, batch):
        self._timeline_reads += batch.size
        self.timeline.append((time.perf_counter(), self._timeline_reads))

    def _consume_classified(self, batch, results):
        super()._consume_classified(batch, results)
        self._note_batch(batch)

    def _note_batch_submitted(self, batch):
        self._note_batch(batch)


class _NullDeviceMixin:
    """The card replaced by an instant decision fabricator, so the whole
    streamed host path runs unchanged (parse, input filters, wire pack,
    worker staging, decision apply, render workers, writer): the rate
    measured is the host-pipeline ceiling, the most this host can feed a
    card. Decisions spread reads over the panel so that tag rendering costs
    what it costs in production (the reference package's mixin of the same
    name)."""

    def _dispatch(self, batch, packed=None):
        if packed is None:
            packed = self._pack_batch(batch)  # keep the real wire-pack cost
        self._staging_events.pop(packed[2], None)  # no copy reads the buffer
        return None

    def _classify_batch_on_device(self, batch):
        n = batch.size
        cycle = np.arange(n, dtype=np.int64)
        results = []
        for dec in self.instrument.decoders:
            b = dec.barcode_count
            if dec.algorithm in ("pamld", "mdd") and b:
                decoded = ((cycle % b) + 1).astype(np.int32)
                confidence = np.full(n, 0.99951171875, dtype=np.float64)
            else:
                decoded = np.zeros(n, dtype=np.int32)
                confidence = np.zeros(n, dtype=np.float64)
            results.append(
                {"decoded": decoded, "confidence": confidence, "qcfail": batch.qcfail.copy()}
            )
        self._batch_rows = np.empty(0, dtype=np.int64)
        self._rows_qcfail = np.empty(0, dtype=bool)
        return results


def make_engine(ontology: dict, fidelity: str, threads: int, device, devices=None):
    """The timed engine the e2e run drives for ``fidelity``: strict, fast,
    hybrid, or null (the host-pipeline ceiling: the streamed device engine
    with the card replaced by _NullDeviceMixin); ``devices``, a list, is
    the device engines' reads axis."""
    if fidelity == "null":
        from .engine.device import TorchStreamedDeviceEngine

        class Null(_TimedMixin, _NullDeviceMixin, TorchStreamedDeviceEngine):
            pass

        return Null(ontology, hybrid=False, workers=max(1, threads - 1), device=device, devices=devices)
    if fidelity == "strict":
        if threads > 1:
            from .engine.stream import StreamedStrictEngine

            class Strict(_TimedMixin, StreamedStrictEngine):
                pass

            return Strict(ontology, workers=max(1, threads))
        from .engine.strict import StrictEngine

        class Serial(_TimedMixin, StrictEngine):
            pass

        return Serial(ontology)
    if fidelity not in ("fast", "hybrid"):
        raise ValueError(f"unknown fidelity {fidelity!r}: strict, fast, hybrid or null")
    from .engine.device import TorchDeviceEngine, TorchStreamedDeviceEngine

    hybrid = fidelity == "hybrid"
    if threads > 1:

        class Streamed(_TimedMixin, TorchStreamedDeviceEngine):
            pass

        return Streamed(ontology, hybrid=hybrid, workers=max(1, threads - 1), device=device, devices=devices)

    class Single(_TimedMixin, TorchDeviceEngine):
        pass

    return Single(ontology, hybrid=hybrid, device=device, devices=devices)


def run_e2e(
    paths: list[str],
    output_url: str,
    fidelity: str = "hybrid",
    threads: int = 4,
    batch_size: int = 65536,
    device="cuda",
    ontology: dict | None = None,
    devices=None,
    report_url: str | None = None,
    compiled: dict | None = None,
) -> dict:
    """Run the end-to-end engine over `paths` with the decoders of
    `ontology` (the flagship's by default), returning throughput stats
    (the keys of ``pheniqs_tpu.benchmark.run_e2e``) with the warmup batches
    separated from steady state, plus ``resolved_fraction``: the share of
    reads the hybrid engine re-resolved in f64, and ``devices``: the
    slices a device engine cut each batch into (0 for strict).
    ``devices`` is a count, the ontology's ``"devices"`` cap on the local
    cards, or a list of devices (cards may repeat). ``report_url`` names a
    file to write the run's report to as JSON. ``compiled`` is the
    instruction e2e_ontology compiled for the same decoders, output and
    threads on other inputs of this layout, run on `paths` (with_inputs)
    where it would be compiled again. Under ``PHENIQS_TP`` every
    rank calls it: rank 0 runs the engine; the leader of each other row
    decodes its row's slices (``tp.lead_row``) and every other rank
    follows its row's device steps (``tp.follow``); those return None."""
    from .device.distributed import is_leader, is_row_leader

    if not is_leader():
        from .device.tp import follow, lead_row

        (lead_row if is_row_leader() else follow)(device)
        return None
    base = ontology if ontology is not None else flagship_ontology()
    if compiled is not None:
        ontology = with_inputs(compiled, paths)
    else:
        ontology = e2e_ontology(paths, output_url, threads, base)
    if isinstance(devices, int):
        ontology["devices"] = devices
        devices = None
    engine = make_engine(ontology, fidelity, threads, device, devices)
    engine._init_timeline()
    start = time.perf_counter()
    engine.execute(batch_size=batch_size)
    wall = time.perf_counter() - start
    report = engine.finalize_report()
    if report_url is not None:
        with open(report_url, "w") as stream:
            json.dump(report, stream)

    timeline = engine.timeline
    total_reads = timeline[-1][1] if timeline else 0
    stats = {
        "reads": total_reads,
        "wall_s": round(wall, 3),
        "reads_per_s": round(total_reads / wall, 1) if wall else 0.0,
        "batches": len(timeline),
        "devices": len(getattr(engine, "devices", ())),
    }
    warmup = 3 if len(timeline) > 8 else 1
    if len(timeline) > warmup + 2:
        t0, r0 = timeline[warmup]
        t1, r1 = timeline[-1]
        if t1 > t0:
            stats["steady_reads_per_s"] = round((r1 - r0) / (t1 - t0), 1)
            stats["cold_start_s"] = round(timeline[1][0] - start, 3)
            stats["steady_window_s"] = round(t1 - t0, 3)
            stats["steady_batches"] = len(timeline) - warmup - 1
        rates = []
        windows = []
        for (ta, ra), (tb, rb) in zip(timeline[warmup:-1], timeline[warmup + 1 :]):
            if tb > ta:
                rates.append((rb - ra) / (tb - ta))
                windows.append((rb - ra, tb - ta))
        if rates:
            q = np.percentile(rates, [10, 50, 90])
            stats["batch_rate_p10"] = round(float(q[0]), 1)
            stats["batch_rate_median"] = round(float(q[1]), 1)
            stats["batch_rate_p90"] = round(float(q[2]), 1)
            # trimmed steady: aggregate rate over the windows at or above
            # the median per-batch rate
            med = float(q[1])
            top_reads = sum(r for (r, t), rate in zip(windows, rates) if rate >= med)
            top_time = sum(t for (r, t), rate in zip(windows, rates) if rate >= med)
            if top_time > 0:
                stats["steady_trimmed_reads_per_s"] = round(top_reads / top_time, 1)
    incoming = report.get("incoming", {}).get("count", 0)
    classified = sum(
        entry.get("count", 0) for entry in report.get("sample", {}).get("classified", [])
    )
    if incoming:
        stats["classified_fraction"] = round(classified / incoming, 4)
    resolved = getattr(engine, "_resolved_reads", None)
    if resolved is not None and incoming:
        stats["resolved_fraction"] = round(resolved / incoming, 6)
    return stats


def sam_decisions(path: str) -> list:
    """The SAM records of `path` minus the f32 confidence tags, which the
    device and the f64 engine compute at different precisions
    (tests/test_hybrid.py's comparison)."""
    out = []
    with open(path) as stream:
        for line in stream:
            if line.startswith("@"):
                continue
            fields = line.rstrip("\n").split("\t")
            out.append(tuple(f for f in fields if f[:5] not in ("XB:f:", "XM:f:", "XC:f:")))
    return out


def trace_summary(path: str, top: int = 12) -> dict:
    """Device time in a PHENIQS_PROFILE Chrome trace (a file, or the newest
    one in a directory): ``busy_s``, the union of the card's kernel and
    copy intervals; ``span_s``, from its first device event to its last;
    and ``top``, the `top` largest (events, milliseconds) by kind and
    name."""
    if os.path.isdir(path):
        traces = [os.path.join(path, f) for f in os.listdir(path) if f.endswith(".trace.json")]
        path = max(traces, key=os.path.getmtime)
    with open(path) as stream:
        events = json.load(stream)["traceEvents"]
    device = sorted(
        (e for e in events if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
        key=lambda e: e["ts"],
    )
    busy_us = 0.0
    end = float("-inf")
    by_name: dict[str, list] = {}
    for e in device:
        start, stop = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        entry = by_name.setdefault(f"{e['cat']}: {e['name'][:64]}", [0, 0.0])
        entry[0] += 1
        entry[1] += float(e.get("dur", 0.0)) / 1000.0
    span_us = end - float(device[0]["ts"]) if device else 0.0
    ranked = sorted(by_name.items(), key=lambda item: -item[1][1])[:top]
    return {
        "busy_s": busy_us / 1e6,
        "span_s": span_us / 1e6,
        "top": {name: [count, ms] for name, (count, ms) in ranked},
    }


def run_cli(
    paths: list[str], output_url: str, fidelity: str, threads: int, batch_size: int, base: dict, device,
    devices: int | None = None,
) -> dict:
    """One run of ``python -m pheniqs_tpu_torch mux`` over `paths` with the
    decoders of `base`, on `device` (PHENIQS_TORCH_DEVICE): its exit code,
    wall seconds and the engine's closing lines (PHENIQS_TRACE: its rate
    and the seconds of each pipeline stage)."""
    config = f"{output_url}.json"
    with open(config, "w") as stream:
        json.dump(instruction(paths, output_url, base), stream)
    command = [
        sys.executable, "-m", "pheniqs_tpu_torch", "mux", "--config", config,
        "--fidelity", fidelity, "--threads", str(threads), "--batch-size", str(batch_size),
    ]
    if devices:
        command += ["--devices", str(devices)]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PHENIQS_TORCH_DEVICE=str(device), PHENIQS_TRACE="1")
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
    start = time.perf_counter()
    result = subprocess.run(command, env=env, capture_output=True, text=True)
    stats = {
        "rc": result.returncode,
        "wall_s": round(time.perf_counter() - start, 3),
        "engine": result.stderr.strip().splitlines()[-3:],
    }
    if result.returncode != 0:
        raise RuntimeError(f"mux --fidelity {fidelity} exited {result.returncode}:\n{result.stderr[-4000:]}")
    return stats


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m pheniqs_tpu_torch.benchmark",
        description="End-to-end runs of the port's paths on synthetic flagship reads.",
    )
    parser.add_argument(
        "runs", nargs="+", metavar="PATH:FIDELITY",
        help=f"path {'/'.join(ONTOLOGIES)} and fidelity strict/fast/hybrid/null (null: the host ceiling)",
    )
    parser.add_argument("--reads", type=int, default=4_000_000)
    parser.add_argument("--batch-size", type=int, default=131072)
    parser.add_argument("--threads", type=int, default=min(8, os.cpu_count() or 1))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--devices", type=int, default=None,
                        help="cut each batch over at most N local cards (default: every card)")
    parser.add_argument("--work", default=".benchmark", help="inputs and outputs; removed at the end")
    parser.add_argument("--profile", action="store_true", help="trace each run (PHENIQS_PROFILE)")
    parser.add_argument("--cli", action="store_true", help="run through python -m pheniqs_tpu_torch mux")
    args = parser.parse_args(argv)
    runs = [run.split(":") for run in args.runs]
    for path, fidelity in runs:
        if path not in ONTOLOGIES or fidelity not in ("strict", "fast", "hybrid", "null"):
            parser.error(f"unknown run {path}:{fidelity}")
    ontologies: dict[str, dict] = {}
    strict: dict[str, list] = {}
    os.makedirs(args.work, exist_ok=True)
    try:
        for path, fidelity in runs:
            start = time.perf_counter()
            if path not in ontologies:
                ontologies[path] = ONTOLOGIES[path]()
            inputs = synthesize_fastq_input(os.path.join(args.work, path), args.reads, ontology=ontologies[path])
            line = {"run": f"{path}:{fidelity}", "set_up_s": round(time.perf_counter() - start, 3)}
            out = os.path.join(args.work, f"{path}_{fidelity}.sam")
            if args.cli:
                line.update(run_cli(inputs, out, fidelity, args.threads, args.batch_size,
                                    ontologies[path], args.device, args.devices))
            else:
                profile = os.path.join(args.work, "profile") if args.profile else None
                if profile:
                    shutil.rmtree(profile, ignore_errors=True)
                    os.environ.update(PHENIQS_PROFILE=profile, PHENIQS_TRACE="1")
                try:
                    line.update(run_e2e(inputs, out, fidelity=fidelity, threads=args.threads,
                                        batch_size=args.batch_size, device=args.device,
                                        ontology=ontologies[path], devices=args.devices))
                finally:
                    for name in ("PHENIQS_PROFILE", "PHENIQS_TRACE"):
                        os.environ.pop(name, None)
                if profile and fidelity != "strict":
                    line["trace"] = trace_summary(profile)
            if fidelity == "strict":
                strict[path] = sam_decisions(out)
            elif path in strict:
                records = sam_decisions(out)
                line["records"] = len(records)
                line["mismatches_vs_strict"] = sum(a != b for a, b in zip(strict[path], records)) + abs(
                    len(records) - len(strict[path])
                )
            os.unlink(out)
            print(json.dumps(line), flush=True)
    finally:
        shutil.rmtree(args.work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
