"""Merge per-shard partial statistics into the single-run demux report.

Port of ``pheniqs_tpu.tools.merge`` on the port's own interface, config
compiler and strict engine; the partials come from any of the port's
engines (strict, or the device engines on a card or the CPU).

The multi-host workflow runs one engine per host over a disjoint input
slice (PHENIQS_SHARD=k:H) with PHENIQS_PARTIAL=<path> dumping that host's
raw statistic sums. This tool recombines the H partials under the same
configuration and emits the report (and, optionally, the prior-adjusted
configuration) that a single-process run over the full input would have
produced — the cross-host analog of the reference's thread-local
accumulator collect (reference selector.h:32-92, transcode.cpp:1806-1824).

Every partial field is a plain sum (counts, accumulated distances and
confidences, quality histograms), so the merge is exact for all integer
statistics; float64 confidence sums are reassociated across shards and can
differ from the serial order in the last ulp.

Usage:
    python -m pheniqs_tpu_torch.tools.merge --config job.json \
        [--base-input DIR] [-i URL ...] [--report OUT] [--prior OUT] \
        partial_0.json partial_1.json ...
"""

from __future__ import annotations

import argparse
import json
import sys


def merged_report(
    configuration: str,
    partials: list[str],
    base_input: str | None = None,
    inputs: list[str] | None = None,
    sense_input: bool = False,
    precision: int = 15,
    prior_path: str | None = None,
) -> dict:
    """Compile the configuration, sum the partials into a fresh engine's
    accumulators, and finalize the report exactly as the run itself would."""
    from ..cli.interface import Interface
    from ..config.compiler import InstructionCompiler
    from ..engine.strict import StrictEngine

    argv = [
        "pheniqs-tpu", "mux",
        "--config", configuration,
        "--precision", str(precision),
        "--output", "/dev/null",
    ]
    if sense_input:
        argv.append("--sense-input")
    if base_input:
        argv.extend(["--base-input", base_input])
    for value in inputs or []:
        argv.extend(["--input", value])
    interface = Interface(argv)
    compiler = InstructionCompiler(interface.operation())
    compiler.assemble()
    ontology = compiler.compile()

    engine = StrictEngine(ontology)
    for path in partials:
        with open(path, "rb") as stream:
            engine.merge_partial_state(json.loads(stream.read().decode("utf8")))
    report = engine.finalize_report(None)

    if prior_path is not None:
        from ..config.jsonkit import clean_json_object, sort_json, write_json
        from ..report.prior import apply_prior_adjustment

        adjusted = json.loads(json.dumps(compiler.instruction))
        adjusted = compiler.apply_interactive_ontology(adjusted)
        apply_prior_adjustment(adjusted, engine)
        adjusted = clean_json_object(sort_json(adjusted))
        with open(prior_path, "w") as stream:
            stream.write(write_json(adjusted, precision) + "\n")
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="pheniqs-tpu-merge",
        description="merge PHENIQS_PARTIAL shard statistics into one report",
    )
    parser.add_argument("--config", required=True)
    parser.add_argument("--base-input", dest="base_input")
    parser.add_argument("-i", "--input", action="append")
    parser.add_argument(
        "-s", "--sense-input", dest="sense_input", action="store_true"
    )
    parser.add_argument("--report", help="report path (default stdout)")
    parser.add_argument(
        "--prior", help="also emit the prior-adjusted configuration here"
    )
    parser.add_argument("--precision", type=int, default=15)
    parser.add_argument("partials", nargs="+")
    args = parser.parse_args(argv)

    from ..config.jsonkit import write_json
    from ..errors import PheniqsError

    try:
        report = merged_report(
            args.config,
            args.partials,
            base_input=args.base_input,
            inputs=args.input,
            sense_input=args.sense_input,
            precision=args.precision,
            prior_path=args.prior,
        )
    except PheniqsError as error:
        sys.stderr.write(error.describe() + "\n")
        return error.code
    payload = write_json(report, args.precision) + "\n"
    if args.report:
        with open(args.report, "w") as stream:
            stream.write(payload)
    else:
        sys.stdout.write(payload)
    return 0


if __name__ == "__main__":
    sys.exit(main())
