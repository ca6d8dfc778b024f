"""Illumina run-folder config generation (reference
tool/pheniqs-illumina-api.py).

Parses RunInfo.xml / RunParameters.xml / SampleSheet.csv and emits:
  basecall    — bcl2fastq sample sheet + shell command
  core        — {flowcell}_core.json with per-lane sample decoder repository
  sample      — per-lane PAMLD sample decoding instruction
  estimate    — per-lane fast prior-estimation instruction (index reads only)
  interleave  — per-lane interleaving instruction (no decoding)
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from datetime import date

#: recognized SampleSheet Data columns (reference tool/configuration/command.json)
DATA_COLUMNS = {
    "Description", "I5_index_ID", "I7_Index_ID", "Lane", "Sample_ID",
    "Sample_Name", "Sample_Plate", "Sample_Project", "Sample_Well",
    "index", "index2",
}

SECTIONS = ("Header", "Reads", "Settings", "Data")

#: default sample-sheet-record preset: codec key candidates and RG values
PRESET = {
    "key": [
        "@{Sample_ID}",
        "{flowcell id}:{lane number}:{concatenated barcode}",
        "{flowcell id}:{concatenated barcode}",
    ],
    "value": {
        "DS": "{Description}",
        "LB": ["{Sample_Name}", "{Sample_ID}"],
        "SM": "{Sample_Project}",
    },
}


def to_json(ontology) -> str:
    return json.dumps(ontology, sort_keys=True, ensure_ascii=False, indent=4)


def decode_value_by_preset(record: dict, preset):
    if isinstance(preset, str):
        try:
            return preset.format(**record)
        except KeyError:
            return None
    if isinstance(preset, list):
        for pattern in preset:
            try:
                return pattern.format(**record)
            except KeyError:
                continue
    return None


class IlluminaRun:
    """Parsed state of one Illumina run directory."""

    def __init__(self, run_directory: str):
        self.run_directory = run_directory
        self.illumina: dict = {}
        self.parse_run_info()
        self.parse_run_parameters()
        self.parse_sample_sheet()
        self.compile_platform_model()

    def parse_run_info(self):
        path = os.path.join(self.run_directory, "RunInfo.xml")
        if not os.path.exists(path):
            return
        import xml.etree.ElementTree

        run = xml.etree.ElementTree.parse(path).getroot().find("Run")

        date_text = run.find("Date").text
        if date_text:
            match = re.search(
                r"^(?P<year>[0-9]{2})(?P<month>[0-9]{2})(?P<day>[0-9]{2})$",
                date_text,
            )
            if match:
                parts = {k: int(v) for k, v in match.groupdict().items()}
                parts["year"] += 2000
                self.illumina["DT"] = date(**parts).isoformat()

        self.illumina["flowcell id"] = run.find("Flowcell").text
        layout = run.find("FlowcellLayout")
        self.illumina["lane cardinality"] = int(layout.attrib["LaneCount"])
        self.illumina["instrument id"] = run.find("Instrument").text

        self.illumina["segment"] = []
        index_count = 0
        template_count = 0
        for read in run.find("Reads"):
            element = {"is index": read.attrib["IsIndexedRead"] == "Y"}
            element["cycle cardinality"] = int(read.attrib["NumCycles"])
            element["illumina segment index"] = int(read.attrib["Number"])
            element["index"] = element["illumina segment index"] - 1
            if element["is index"]:
                index_count += 1
                element["illumina segment name"] = f"I{index_count}"
            else:
                template_count += 1
                element["illumina segment name"] = f"R{template_count}"
            self.illumina["segment"].append(element)

        self.illumina["template segment"] = [
            s for s in self.illumina["segment"] if not s["is index"]
        ]
        self.illumina["index segment"] = [
            s for s in self.illumina["segment"] if s["is index"]
        ]

    def parse_run_parameters(self):
        path = os.path.join(self.run_directory, "RunParameters.xml")
        if not os.path.exists(path):
            path = os.path.join(self.run_directory, "runParameters.xml")
            if not os.path.exists(path):
                return
        import xml.etree.ElementTree

        root = xml.etree.ElementTree.parse(path).getroot()
        setup = root.find("Setup")
        if setup is None:
            return
        name = setup.find("ApplicationName")
        if name is not None:
            self.illumina["instrument platform"] = name.text.split()[0]
        version = setup.find("ApplicationVersion")
        if version is not None:
            self.illumina["instrument platform version"] = version.text

    def parse_sample_sheet(self):
        path = os.path.join(self.run_directory, "SampleSheet.csv")
        if not os.path.exists(path):
            return
        with open(path, "rb") as stream:
            content = stream.read().decode("utf8").splitlines()

        section = None
        self.illumina["sample sheet"] = {}
        header_re = re.compile(
            r"^\s*\[\s*(?P<section>{})\s*\]".format("|".join(SECTIONS))
        )
        for line in content:
            match = header_re.search(line)
            if match:
                section = match.group("section")
                if section == "Header":
                    self.illumina["sample sheet"]["header"] = []
                elif section == "Data":
                    self.illumina["sample sheet"]["data"] = {"row": [], "head": []}
            elif section == "Header":
                line = line.strip()
                if line:
                    self.illumina["sample sheet"]["header"].append(line)
            elif section == "Data":
                row = [x.strip() for x in line.split(",")]
                data = self.illumina["sample sheet"]["data"]
                if not data["head"]:
                    data["head"] = [
                        key if key in DATA_COLUMNS else None for key in row
                    ]
                else:
                    head = data["head"]
                    record = {}
                    for index, column in enumerate(row):
                        if index < len(head) and head[index] is not None and column:
                            record[head[index]] = column
                    if "Lane" in record:
                        try:
                            record["lane number"] = int(record["Lane"])
                        except ValueError:
                            pass
                    if record:
                        data["row"].append(record)

        for row in (
            self.illumina.get("sample sheet", {}).get("data", {}).get("row", [])
        ):
            barcode = []
            barcode_length = []
            for column in ("index", "index2"):
                if row.get(column):
                    barcode.append(row[column])
                    barcode_length.append(len(row[column]))
            if barcode:
                row["barcode"] = barcode
                row["barcode length"] = barcode_length
                row["concatenated barcode"] = "".join(barcode)

    def compile_platform_model(self):
        pm = self.illumina.get("instrument platform")
        instrument_id = self.illumina.get("instrument id")
        if instrument_id is not None:
            pm = instrument_id if pm is None else f"{pm} {instrument_id}"
        if pm is not None and "instrument platform version" in self.illumina:
            pm = f"{pm} {self.illumina['instrument platform version']}"
        if pm is not None:
            self.illumina["PM"] = pm

    def compile_lane(self):
        rows = self.illumina.get("sample sheet", {}).get("data", {}).get("row", [])
        if not rows:
            return
        has_lane = [("lane number" in r) for r in rows]
        if all(has_lane):
            lane_by_index: dict[int, dict] = {}
            for record in rows:
                lane = lane_by_index.setdefault(
                    record["lane number"],
                    {"lane number": record["lane number"], "row": []},
                )
                lane["row"].append(record)
            self.illumina["lane"] = [
                lane_by_index[k] for k in sorted(lane_by_index)
            ]
        elif not any(has_lane):
            if "lane cardinality" in self.illumina:
                self.illumina["lane"] = [{"lane number": 0, "row": list(rows)}]
        else:
            raise ValueError(
                "Incoherent sample sheet, some rows define a lane and others dont"
            )

        for lane in self.illumina.get("lane", []):
            name = self.illumina.get("flowcell id", "")
            if lane["lane number"] > 0:
                if name:
                    name += "_"
                name += "l{:02d}".format(lane["lane number"])
            name += "_sample"
            lane["sample decoder name"] = name

            first = lane["row"][0]["barcode length"]
            if all(first == r["barcode length"] for r in lane["row"]):
                lane["barcode length"] = first
                index_segments = self.illumina["index segment"]
                if len(first) <= len(index_segments):
                    if all(
                        segment["cycle cardinality"] >= length
                        for length, segment in zip(first, index_segments)
                    ):
                        lane["sample transform"] = {
                            "token": [
                                "{}::{}".format(segment["index"], length)
                                for length, segment in zip(first, index_segments)
                            ]
                        }


class IlluminaApi:
    def __init__(self, args):
        self.args = args
        self.run = IlluminaRun(args.illumina_run_directory)
        self.run.compile_lane()
        self.illumina = self.run.illumina
        self.core_path = "{}_core.json".format(self.illumina["flowcell id"])

    def make_bcl2fastq_file_name(self, flowcell_id, lane_number, segment_name):
        return "{}_S1_L00{}_{}_001.fastq.gz".format(
            flowcell_id, lane_number, segment_name
        )

    # --- basecall --------------------------------------------------------
    def write_basecall(self):
        sheet_path = "{}_basecall_sample_sheet.csv".format(
            self.illumina["flowcell id"]
        )
        buffer = []
        if "header" in self.illumina.get("sample sheet", {}):
            buffer.append("[Header]")
            buffer.extend(self.illumina["sample sheet"]["header"])
            buffer.append("")
        buffer.append("[Data]")
        buffer.append("FCID,Lane,Sample_ID,Sample_Name")
        for lane_number in range(1, self.illumina["lane cardinality"] + 1):
            buffer.append(
                "{0},{1},{0},".format(self.illumina["flowcell id"], lane_number)
            )
        buffer.append("")
        with open(sheet_path, "wb") as stream:
            stream.write("\n".join(buffer).encode("utf8"))

        script_path = "{}_basecall.sh".format(self.illumina["flowcell id"])
        command = ["bcl2fastq"]
        command.append(
            "--runfolder-dir {}".format(self.args.illumina_run_directory)
        )
        command.append("--sample-sheet {}".format(sheet_path))
        command.append("--create-fastq-for-index-reads")
        command.append("--adapter-stringency 0")
        command.append("--minimum-trimmed-read-length 0")
        command.append("--mask-short-adapter-reads 0")
        for key in (
            "no_bgzf_compression",
            "ignore_missing_bcls",
            "ignore_missing_filter",
            "ignore_missing_positions",
        ):
            if getattr(self.args, key, False):
                command.append("--{}".format(key.replace("_", "-")))
        if getattr(self.args, "output_dir", None):
            command.append("--output-dir {}".format(self.args.output_dir))
        if getattr(self.args, "fastq_compression_level", None) is not None:
            command.append(
                "--fastq-compression-level {}".format(
                    self.args.fastq_compression_level
                )
            )
        with open(script_path, "wb") as stream:
            stream.write(("{}\n".format(" \\\n".join(command))).encode("utf8"))

    # --- core ------------------------------------------------------------
    def make_lane_sample_decoder(self, lane):
        decoder = {"codec": {}}
        if "sample transform" in lane:
            decoder["transform"] = lane["sample transform"]
        for record in lane["row"]:
            if "flowcell id" in self.illumina:
                record["flowcell id"] = self.illumina["flowcell id"]
            key = decode_value_by_preset(record, PRESET["key"])
            if key is not None and record.get("barcode"):
                element = {"barcode": record["barcode"]}
                for name, pattern in PRESET["value"].items():
                    value = decode_value_by_preset(record, pattern)
                    if value is not None:
                        element[name] = value
                decoder["codec"][key] = element
        return decoder

    def write_core(self):
        job = {"PL": "ILLUMINA"}
        for key in ("DT", "PM", "flowcell id"):
            if key in self.illumina:
                job[key] = self.illumina[key]
        for key, name in {
            "base_input": "base input url",
            "base_output": "base output url",
            "no_input_npf": "filter incoming qc fail",
            "no_output_npf": "filter outgoing qc fail",
        }.items():
            if getattr(self.args, key, None):
                job[name] = getattr(self.args, key)
        if "template segment" in self.illumina:
            job["template"] = {
                "transform": {
                    "token": [
                        "{}::".format(segment["index"])
                        for segment in self.illumina["template segment"]
                    ]
                }
            }
        if self.illumina.get("lane"):
            job["decoder"] = {
                lane["sample decoder name"]: self.make_lane_sample_decoder(lane)
                for lane in self.illumina["lane"]
            }
        with open(self.core_path, "wb") as stream:
            stream.write(to_json(job).encode("utf8"))

    # --- per-lane instructions ------------------------------------------
    def write_sample(self):
        for lane in self.illumina.get("lane", []):
            job = {
                "import": [self.core_path],
                "input": [
                    self.make_bcl2fastq_file_name(
                        self.illumina["flowcell id"],
                        lane["lane number"],
                        segment["illumina segment name"],
                    )
                    for segment in self.illumina["segment"]
                ],
                "output": [
                    "{}_l{:02d}.bam".format(
                        self.illumina["flowcell id"], lane["lane number"]
                    )
                ],
                "report url": "{}_l{:02d}_sample_report.json".format(
                    self.illumina["flowcell id"], lane["lane number"]
                ),
                "sample": {
                    "base": lane["sample decoder name"],
                    "algorithm": "pamld",
                    "noise": self.args.noise,
                    "confidence threshold": self.args.confidence,
                },
            }
            path = "{}_l{:02d}_sample.json".format(
                self.illumina["flowcell id"], lane["lane number"]
            )
            with open(path, "wb") as stream:
                stream.write(to_json(job).encode("utf8"))

    def write_estimate(self):
        for lane in self.illumina.get("lane", []):
            job = {
                "import": [self.core_path],
                "input": [],
                "output": ["/dev/null"],
                "report url": "{}_l{:02d}_estimate_report.json".format(
                    self.illumina["flowcell id"], lane["lane number"]
                ),
                "template": {"transform": {"token": []}},
                "sample": {
                    "base": lane["sample decoder name"],
                    "algorithm": "pamld",
                    "noise": self.args.noise,
                    "confidence threshold": self.args.confidence,
                    "transform": {"token": []},
                },
            }
            for segment_index, (segment_length, segment) in enumerate(
                zip(lane["barcode length"], self.illumina["index segment"])
            ):
                job["input"].append(
                    self.make_bcl2fastq_file_name(
                        self.illumina["flowcell id"],
                        lane["lane number"],
                        segment["illumina segment name"],
                    )
                )
                token = "{}::{}".format(segment_index, segment_length)
                job["template"]["transform"]["token"].append(token)
                job["sample"]["transform"]["token"].append(token)
            path = "{}_l{:02d}_estimate.json".format(
                self.illumina["flowcell id"], lane["lane number"]
            )
            with open(path, "wb") as stream:
                stream.write(to_json(job).encode("utf8"))

    def write_interleave(self):
        for lane in self.illumina.get("lane", []):
            job = {"PL": "ILLUMINA", "input": [], "output": []}
            for key in ("DT", "PM", "flowcell id"):
                if key in self.illumina:
                    job[key] = self.illumina[key]
            job["template"] = {"transform": {"token": []}}
            for segment_index, segment in enumerate(self.illumina["segment"]):
                job["input"].append(
                    self.make_bcl2fastq_file_name(
                        self.illumina["flowcell id"],
                        lane["lane number"],
                        segment["illumina segment name"],
                    )
                )
                job["template"]["transform"]["token"].append(
                    "{}::".format(segment_index)
                )
            job["report url"] = "{}_l{:02d}_interleave_report.json".format(
                self.illumina["flowcell id"], lane["lane number"]
            )
            job["output"].append(
                "{}_l{:02d}_interleave.bam".format(
                    self.illumina["flowcell id"], lane["lane number"]
                )
            )
            path = "{}_l{:02d}_interleave.json".format(
                self.illumina["flowcell id"], lane["lane number"]
            )
            with open(path, "wb") as stream:
                stream.write(to_json(job).encode("utf8"))

    def execute(self, action: str):
        if action == "basecall":
            self.write_basecall()
        elif action == "core":
            self.write_core()
        elif action == "sample":
            self.write_sample()
        elif action == "estimate":
            self.write_estimate()
        elif action == "interleave":
            self.write_interleave()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="pheniqs-tpu-torch-illumina-api",
        description="generate configs or a bcl2fastq command from an "
        "illumina run directory",
    )
    sub = parser.add_subparsers(dest="action", metavar="ACTION", required=True)

    basecall = sub.add_parser("basecall")
    basecall.add_argument("illumina_run_directory")
    basecall.add_argument("--output-dir", dest="output_dir")
    basecall.add_argument(
        "--fastq-compression-level", dest="fastq_compression_level",
        type=int, default=3,
    )
    for flag in (
        "no-bgzf-compression", "ignore-missing-bcls", "ignore-missing-filter",
        "ignore-missing-positions",
    ):
        basecall.add_argument(
            f"--{flag}", dest=flag.replace("-", "_"), action="store_true"
        )

    core = sub.add_parser("core")
    core.add_argument("illumina_run_directory")
    core.add_argument("--base-input", dest="base_input")
    core.add_argument("--base-output", dest="base_output")
    core.add_argument("--no-input-npf", dest="no_input_npf", action="store_true")
    core.add_argument("--no-output-npf", dest="no_output_npf", action="store_true")

    for name in ("sample", "estimate"):
        action = sub.add_parser(name)
        action.add_argument("illumina_run_directory")
        action.add_argument("--confidence", type=float, default=0.95)
        action.add_argument("--noise", type=float, default=0.05)

    interleave = sub.add_parser("interleave")
    interleave.add_argument("illumina_run_directory")

    args = parser.parse_args(argv)
    for attr in ("noise", "confidence"):
        if not hasattr(args, attr):
            setattr(args, attr, {"noise": 0.05, "confidence": 0.95}[attr])
    api = IlluminaApi(args)
    api.execute(args.action)
    return 0


if __name__ == "__main__":
    sys.exit(main())
