"""Prior-estimation config adjustment (reference tool/pheniqs-prior-api.py).

Takes a configuration and a demux report (or runs the estimation pass
itself), and emits the configuration with each decoder's ``noise`` replaced
by the report's ``estimated noise`` and each barcode's ``concentration``
replaced by its ``estimated concentration``, matched by concatenated
barcode sequence (reference tool/pheniqs-prior-api.py:39-56, 185-209).

Unlike the reference tool, the static configuration is produced in-process
(no subprocess to the ``pheniqs`` binary).
"""

from __future__ import annotations

import argparse
import copy
import io
import json
import os
import sys


def apply_prior(decoder: dict, report: dict) -> None:
    """noise <- estimated noise; concentration <- estimated concentration
    per barcode (matched on the concatenated barcode string)."""
    if "estimated noise" in report:
        decoder["noise"] = report["estimated noise"]

    if "codec" in decoder and "classified" in report:
        report_by_hash = {}
        for barcode_report in report["classified"]:
            key = "".join(barcode_report["barcode"])
            report_by_hash[key] = barcode_report

        for barcode_model in decoder["codec"].values():
            key = "".join(barcode_model["barcode"])
            if key in report_by_hash:
                barcode_report = report_by_hash[key]
                barcode_model["concentration"] = barcode_report.get(
                    "estimated concentration", 0
                )


def strip_output_directive(instruction: dict) -> None:
    instruction.pop("output", None)
    multiplex = instruction.get("multiplex")
    if isinstance(multiplex, dict):
        undetermined = multiplex.get("undetermined")
        if isinstance(undetermined, dict):
            undetermined.pop("output", None)
        codec = multiplex.get("codec")
        if isinstance(codec, dict):
            for barcode in codec.values():
                barcode.pop("output", None)


def static_instruction(
    configuration: str,
    base_input: str | None = None,
    base_output: str | None = None,
    inputs: list[str] | None = None,
    sense_input: bool = False,
) -> dict:
    """Run `mux --static` in-process and parse the emitted instruction."""
    from ..job import run_job

    argv = ["pheniqs-tpu", "mux", "--static", "--config", configuration]
    if sense_input:
        argv.append("--sense-input")
    if base_input:
        argv.extend(["--base-input", base_input])
    if base_output:
        argv.extend(["--base-output", base_output])
    for value in inputs or []:
        argv.extend(["--input", value])
    stdout = io.StringIO()
    stderr = io.StringIO()
    code = run_job(argv, stdout=stdout, stderr=stderr)
    if code != 0:
        raise RuntimeError(
            f"mux --static returned {code}: {stderr.getvalue()}"
        )
    return json.loads(stdout.getvalue())


def estimating_instruction(static: dict, args) -> dict:
    """The fast first-pass config: no per-channel output, /dev/null sink,
    report to stdout (reference tool/pheniqs-prior-api.py:168-183)."""
    estimating = copy.deepcopy(static)
    strip_output_directive(estimating)
    estimating["output"] = ["/dev/null"]
    estimating["report url"] = "/dev/stdout"
    if args.base_input:
        estimating["base input url"] = args.base_input
    if args.base_output:
        estimating["base output url"] = args.base_output
    if args.input:
        estimating["input"] = list(args.input)
    return estimating


def run_estimation(estimating: dict, prefix: str, cwd: str) -> dict:
    from ..job import run_job

    path = os.path.join(cwd, f"{prefix}_estimation_configurtion.json")
    with open(path, "w") as stream:
        json.dump(estimating, stream, sort_keys=True, ensure_ascii=False, indent=4)
    stdout = io.StringIO()
    stderr = io.StringIO()
    code = run_job(
        ["pheniqs-tpu", "mux", "--config", path], stdout=stdout, stderr=stderr
    )
    if code != 0:
        raise RuntimeError(f"estimation pass returned {code}: {stderr.getvalue()}")
    return json.loads(stdout.getvalue())


def adjusted_instruction(static: dict, report: dict) -> dict:
    adjusted = copy.deepcopy(static)
    for classifier_type in ("sample", "cellular", "molecular"):
        if classifier_type in report and classifier_type in adjusted:
            model = adjusted[classifier_type]
            report_node = report[classifier_type]
            if isinstance(model, dict):
                apply_prior(model, report_node)
            elif isinstance(model, list):
                model_by_index = {}
                for index, item in enumerate(model):
                    item["index"] = index
                    model_by_index[index] = item
                for report_item in report_node:
                    apply_prior(model_by_index[report_item["index"]], report_item)
    return adjusted


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="pheniqs-tpu-torch-prior-api",
        description="estimate decoder priors and emit an adjusted config",
    )
    parser.add_argument("--configuration", required=True)
    parser.add_argument("--report")
    parser.add_argument("--prefix")
    parser.add_argument("--base-input", dest="base_input")
    parser.add_argument("--base-output", dest="base_output")
    parser.add_argument("-i", "--input", action="append")
    parser.add_argument(
        "-s", "--sense-input", dest="sense_input", action="store_true"
    )
    args = parser.parse_args(argv)

    static = static_instruction(
        args.configuration,
        base_input=args.base_input,
        base_output=args.base_output,
        inputs=args.input,
        sense_input=args.sense_input,
    )

    if args.report:
        with open(args.report, "rb") as stream:
            report = json.loads(stream.read().decode("utf8"))
    else:
        prefix = args.prefix or static.get("flowcell id") or "prior"
        estimating = estimating_instruction(static, args)
        report = run_estimation(estimating, prefix, os.getcwd())

    adjusted = adjusted_instruction(static, report)
    print(json.dumps(adjusted, sort_keys=True, ensure_ascii=False, indent=4))
    return 0


if __name__ == "__main__":
    sys.exit(main())
