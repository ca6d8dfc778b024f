"""Host-pipeline ceiling measurement (no device work).

Port of ``pheniqs_tpu.tools.host_pipeline``. The engine's scale-out story
needs one number per host: how fast the host path alone — native FASTQ
parse -> input filters -> wire pack -> SHM worker staging -> decision
apply -> tag render -> ordered write — can feed a card. This tool runs a
ladder of real pipeline prefixes over the flagship workload and prints
one JSON line per stage plus the full-pipeline steady state, so the
binding stage is measured, not asserted:

  parse        native FASTQ batch parse only (the ingest ceiling)
  parse+pack   + input filters + H2D wire-blob packing (the ingest
               thread's work in the production engine,
               ``TorchDeviceEngine._prepared_batches``)
  full         the production streamed engine with the card replaced by
               an instant decision fabricator (benchmark.run_e2e
               fidelity="null"): every host stage at production cost,
               decisions spread across the barcode panel

The engines are built for ``--device`` (default ``cuda``, which raises
without a GPU; ``--device cpu`` runs on a machine without one), as
``run_e2e`` builds them; the null engine launches nothing on it. Like the
reference's, these engines are not hybrid, so they pack the lossless
6-bit wire; ``PHENIQS_QUAL_WIRE=j4`` makes them pack the hybrid engine's
joint 4-bit wire instead.

Run:  python -m pheniqs_tpu_torch.tools.host_pipeline --reads 5000000
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def _stage_engine(ontology, device):
    """A non-streamed engine exposing the parse and pack prefixes."""
    from ..benchmark import _NullDeviceMixin
    from ..engine.device import TorchDeviceEngine

    class StageEngine(_NullDeviceMixin, TorchDeviceEngine):
        pass

    return StageEngine(ontology, hybrid=False, device=device)


def _measure_prefix(ontology, batch_size: int, packed: bool, device) -> dict:
    engine = _stage_engine(ontology, device)
    engine._initiate_feeds()
    start = time.perf_counter()
    reads = 0
    count = 0
    batches = engine.read_batches(batch_size)
    if packed:
        for _raw_size, _raw_pf, batch, wire in engine._prepared_batches(batches):
            if wire is not None:
                # no copy reads the staging buffer: it may come round again
                engine._staging_events.pop(wire[2], None)
            reads += batch.size
            count += 1
    else:
        for batch in batches:
            reads += batch.size
            count += 1
    wall = time.perf_counter() - start
    engine._close_feeds()
    return {
        "reads": reads,
        "batches": count,
        "wall_s": round(wall, 3),
        "reads_per_s": round(reads / wall, 1) if wall else 0.0,
    }


def ladder(paths, out: str, threads: int, batch_size: int, device, prefixes: bool = True):
    """Yield one row per stage over the flagship FASTQ `paths` (the
    reference's rows and keys, plus each prefix's ``batches``), the full
    pipeline writing its SAM to `out`."""
    from ..benchmark import e2e_ontology, run_e2e

    if prefixes:
        for name, packed in (("parse", False), ("parse+pack", True)):
            ontology = e2e_ontology(paths, out, 1)
            stats = _measure_prefix(ontology, batch_size, packed, device)
            stats["stage"] = name
            yield stats
    stats = run_e2e(paths, out, fidelity="null", threads=threads, batch_size=batch_size, device=device)
    stats["stage"] = "full"
    stats["threads"] = threads
    yield stats


def ceiling(rows) -> dict:
    """The closing ``host_pipeline_ceiling`` line: the full stage's steady
    rate and every stage's reads/s."""
    full = rows[-1]
    return {
        "metric": "host_pipeline_ceiling",
        "value": full.get("steady_reads_per_s", full["reads_per_s"]),
        "unit": "reads/s",
        "stages": {row["stage"]: row["reads_per_s"] for row in rows},
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--reads", type=int, default=5_000_000)
    parser.add_argument("--threads", type=int, default=(os.cpu_count() or 4) + 1)
    parser.add_argument("--batch", type=int, default=1 << 17)
    parser.add_argument("--device", default="cuda", help="the engines' device: cuda (default) or cpu")
    parser.add_argument(
        "--dir", default=os.path.join(tempfile.gettempdir(), "pheniqs_host_pipeline"),
        help="input cache directory",
    )
    parser.add_argument(
        "--out", default=os.path.join(tempfile.gettempdir(), "pheniqs_host_pipeline_out.sam"),
        help="output SAM path (a real file: write cost is part of the pipeline; /dev/null elides it)",
    )
    parser.add_argument("--skip-prefixes", action="store_true", help="only run the full pipeline stage")
    args = parser.parse_args(argv)

    from ..benchmark import synthesize_fastq_input
    from ..device.instrument import resolve_device

    device = resolve_device(args.device)
    paths = synthesize_fastq_input(args.dir, args.reads)
    rows = []
    for row in ladder(paths, args.out, args.threads, args.batch, device, prefixes=not args.skip_prefixes):
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps(ceiling(rows)), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
