"""The port's copies of the reference's companion tools
(``pheniqs_tpu_torch/tools/{prior,io,illumina,configuration,transcode,
cram_manifest,json_lint}.py``) against the reference's tools on the same
input, and the port's console scripts.

The reference's golden tests (tests/test_tools.py) read the reference
data set, which is not in the repo, so each port tool is held to the
reference tool directly: the same arguments, in the same working
directory layout, give the same standard output and the same files, byte
for byte (the CRAM manifest apart from its ``generator`` line, which names
the port's module). The configurations and the report are the synthetic
flagship's; the Illumina run folder is made here."""

import importlib
import io
import json
import os
import sys
import tomllib

import pytest

from pheniqs_tpu_torch.device.flagship import flagship_ontology

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(package: str, name: str):
    return importlib.import_module(f"{package}.tools.{name}")


def _both(name: str):
    return _tool("pheniqs_tpu", name), _tool("pheniqs_tpu_torch", name)


def _stdout(capsys, main, argv) -> str:
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def flagship_job(tmp_path_factory):
    """A flagship configuration on 2000 synthetic reads (24 + 48 barcodes)
    and the report of the port's strict run on it."""
    from pheniqs_tpu_torch.benchmark import run_e2e, synthesize_fastq_input

    work = tmp_path_factory.mktemp("flagship_job")
    ontology = flagship_ontology(sample_barcodes=24, cellular_barcodes=48)
    paths = synthesize_fastq_input(str(work / "input"), 2000, ontology=ontology)
    config = {
        "input": list(paths),
        "template": {"transform": {"token": ["1::"]}},
        "sample": ontology["sample"],
        "cellular": ontology["cellular"],
        "molecular": ontology["molecular"],
        "output": [str(work / "out.sam")],
        "flowcell id": "SYNTHETIC",
    }
    config_path = work / "job.json"
    config_path.write_text(json.dumps(config))
    report = work / "report.json"
    run_e2e(paths, str(work / "strict.sam"), fidelity="strict", threads=1, batch_size=1024, device="cpu",
            ontology=ontology, report_url=str(report))
    return work, str(config_path), str(report)


def test_prior_with_a_report(flagship_job, capsys):
    """``prior --configuration C --report R``: the report's estimated noise
    and concentrations folded into the configuration, as the reference
    tool folds them."""
    _, config, report = flagship_job
    reference, port = _both("prior")
    argv = ["--configuration", config, "--report", report]
    theirs, ours = _stdout(capsys, reference.main, argv), _stdout(capsys, port.main, argv)
    assert ours == theirs
    adjusted = json.loads(ours)
    concentrations = {barcode["concentration"] for barcode in adjusted["sample"]["codec"].values()}
    assert len(concentrations) > 1  # no longer uniform


def test_prior_estimation_pass(flagship_job, capsys, monkeypatch):
    """``prior`` without a report runs the estimation pass itself, on the
    port's own job (strict), and writes its estimation configuration into
    the working directory."""
    work, config, _ = flagship_job
    reference, port = _both("prior")
    outputs = {}
    for label, tool in (("reference", reference), ("port", port)):
        cwd = work / f"estimate_{label}"
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        outputs[label] = _stdout(capsys, tool.main, ["--configuration", config, "--prefix", "pass1"])
        outputs[label + " configuration"] = (cwd / "pass1_estimation_configurtion.json").read_text()
    assert outputs["port"] == outputs["reference"]
    assert outputs["port configuration"] == outputs["reference configuration"]


@pytest.mark.parametrize("argv", [["-L", "-S", "--format", "fastq"], ["--format", "bam"],
                                  ["-L", "--format", "fastq", "--compression", "gz", "--prefix", "lane"]])
def test_io(flagship_job, capsys, argv):
    """``io``: the output layout rewritten (split by library and segment,
    format and compression) as the reference tool rewrites it."""
    _, config, _ = flagship_job
    reference, port = _both("io")
    argv = ["--configuration", config, *argv]
    assert _stdout(capsys, port.main, argv) == _stdout(capsys, reference.main, argv)


RUN_INFO = """<?xml version="1.0"?>
<RunInfo Version="5">
  <Run Id="181014_A00534_0024_AH7LT2DSXX" Number="24">
    <Flowcell>H7LT2DSXX</Flowcell>
    <Instrument>A00534</Instrument>
    <Date>181014</Date>
    <Reads>
      <Read Number="1" NumCycles="151" IsIndexedRead="N" />
      <Read Number="2" NumCycles="8" IsIndexedRead="Y" />
      <Read Number="3" NumCycles="8" IsIndexedRead="Y" />
      <Read Number="4" NumCycles="151" IsIndexedRead="N" />
    </Reads>
    <FlowcellLayout LaneCount="2" SurfaceCount="2" SwathCount="4" TileCount="78" />
  </Run>
</RunInfo>
"""

RUN_PARAMETERS = """<?xml version="1.0"?>
<RunParameters>
  <Setup>
    <ApplicationName>NovaSeq Control Software</ApplicationName>
    <ApplicationVersion>1.3.1</ApplicationVersion>
  </Setup>
</RunParameters>
"""

SAMPLE_SHEET = """[Header]
IEMFileVersion,5
Date,10/14/2018
Workflow,GenerateFASTQ

[Reads]
151
151

[Settings]

[Data]
Lane,Sample_ID,Sample_Name,Sample_Plate,Sample_Well,I7_Index_ID,index,I5_Index_ID,index2,Sample_Project,Description
1,S1,alpha,,A01,D701,ATTACTCG,D501,TATAGCCT,P1,first
1,S2,beta,,B01,D702,TCCGGAGA,D502,ATAGAGGC,P1,second
2,S3,gamma,,C01,D703,CGCTCATT,D503,CCTATCCT,P2,third
2,S4,,,D01,D704,GAGATTCC,D504,GGCTCTGA,P2,
"""


@pytest.fixture(scope="module")
def run_folder(tmp_path_factory):
    """A two-lane NovaSeq run folder: RunInfo.xml, RunParameters.xml and a
    dual-index sample sheet."""
    base = tmp_path_factory.mktemp("illumina")
    run = base / "181014_A00534_0024_AH7LT2DSXX"
    run.mkdir()
    (run / "RunInfo.xml").write_text(RUN_INFO)
    (run / "RunParameters.xml").write_text(RUN_PARAMETERS)
    (run / "SampleSheet.csv").write_text(SAMPLE_SHEET)
    return base


@pytest.mark.parametrize("action,extra", [("basecall", ["--output-dir", "out", "--no-bgzf-compression"]),
                                          ("core", ["--base-input", "in", "--no-output-npf"]),
                                          ("sample", ["--noise", "0.02"]), ("estimate", []),
                                          ("interleave", [])])
def test_illumina(run_folder, action, extra, monkeypatch):
    """``illumina ACTION RUN``: the same files, byte for byte."""
    reference, port = _both("illumina")
    written = {}
    for label, tool in (("reference", reference), ("port", port)):
        cwd = run_folder / f"{action}_{label}"
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        assert tool.main([action, "../181014_A00534_0024_AH7LT2DSXX", *extra]) == 0
        written[label] = {name: (cwd / name).read_bytes() for name in sorted(os.listdir(cwd))}
    assert written["port"] and written["port"] == written["reference"]


def test_configuration(capsys):
    """``configuration``: the zsh completion script, default and renamed."""
    reference, port = _both("configuration")
    assert port.generate_zsh() == reference.generate_zsh()
    assert port.generate_zsh("pheniqs-tpu-torch") == reference.generate_zsh("pheniqs-tpu-torch")
    for argv in (["zsh"], ["--application", "pheniqs-tpu-torch", "zsh"]):
        assert _stdout(capsys, port.main, argv) == _stdout(capsys, reference.main, argv)


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    """cram_manifest's fixture set generated by each package."""
    out = {}
    for label in ("reference", "port"):
        directory = tmp_path_factory.mktemp(f"cram_{label}")
        module = _tool("pheniqs_tpu" if label == "reference" else "pheniqs_tpu_torch", "cram_manifest")
        out[label] = (str(directory), module.generate(str(directory)))
    return out


def test_cram_manifest_generate(manifests):
    """``cram_manifest.generate``: every fixture byte-equal, the manifest
    equal but for the generator line."""
    (theirs, their_manifest), (ours, our_manifest) = manifests["reference"], manifests["port"]
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    for name in sorted(os.listdir(ours)):
        if name != "MANIFEST.json":
            assert open(os.path.join(ours, name), "rb").read() == open(os.path.join(theirs, name), "rb").read(), name
    assert our_manifest.pop("generator") == "python -m pheniqs_tpu_torch.tools.cram_manifest <dir>"
    their_manifest.pop("generator")
    assert our_manifest == their_manifest


@pytest.mark.parametrize("name", ["unmapped_demux", "v31_demux", "mapped_mixed", "batch_columnar"])
def test_cram_manifest_render_sam(manifests, name):
    """``render_sam``: the SAM text of each CRAM fixture, and the SAM truth
    the generator wrote beside it."""
    reference, port = _both("cram_manifest")
    directory = manifests["port"][0]
    fasta = os.path.join(directory, "ref.fa") if name == "mapped_mixed" else None
    cram = os.path.join(directory, f"{name}.cram")
    ours = port.render_sam(cram, fasta)
    assert ours == reference.render_sam(cram, fasta)
    assert ours == open(os.path.join(directory, f"{name}.sam")).read()


@pytest.mark.parametrize("name", ["unmapped_demux", "mapped_mixed"])
def test_transcode(manifests, tmp_path, name):
    """``transcode``: CRAM -> BAM and that BAM -> CRAM, the same bytes as
    the reference tool's on the same files."""
    reference, port = _both("transcode")
    directory = manifests["port"][0]
    extra = ["--reference", os.path.join(directory, "ref.fa")] if name == "mapped_mixed" else []
    cram = os.path.join(directory, f"{name}.cram")
    made = {}
    for label, tool in (("reference", reference), ("port", port)):
        bam = str(tmp_path / f"{label}.bam")
        back = str(tmp_path / f"{label}.cram")
        assert tool.main([cram, bam, *extra]) == 0
        assert tool.main([bam, back, *extra]) == 0
        made[label] = (open(bam, "rb").read(), open(back, "rb").read())
    assert made["port"] == made["reference"]


@pytest.mark.parametrize("flags", [[], ["-c"], ["--pretty"]])
def test_json_lint(capsys, monkeypatch, flags):
    """``json_lint``: the same text out for valid JSON, and exit 10 for
    invalid JSON."""
    reference, port = _both("json_lint")
    document = '{"b": [1, 2.5, "\\u00e9"], "a": {"z": null, "y": true}}'
    outputs = []
    for tool in (reference, port):
        monkeypatch.setattr(sys, "stdin", io.StringIO(document))
        outputs.append(_stdout(capsys, tool.main, flags))
    assert outputs[0] == outputs[1]
    for tool in (reference, port):
        monkeypatch.setattr(sys, "stdin", io.StringIO("{broken"))
        assert tool.main(flags) == 10


def _scripts() -> dict:
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as stream:
        return tomllib.load(stream)["project"]["scripts"]


@pytest.mark.parametrize("script", ["pheniqs-tpu-torch", "pheniqs-tpu-torch-illumina-api", "pheniqs-tpu-torch-io-api",
                                    "pheniqs-tpu-torch-prior-api", "pheniqs-tpu-torch-configuration-api"])
def test_console_scripts(script):
    """Each of the port's console scripts names a callable of the port;
    the reference's own entries are still there, on the reference."""
    scripts = _scripts()
    module, _, attribute = scripts[script].partition(":")
    assert module.split(".")[0] == "pheniqs_tpu_torch"
    assert callable(getattr(importlib.import_module(module), attribute))
    reference = scripts[script.replace("-torch", "")]
    assert reference.split(".")[0] == "pheniqs_tpu"


def test_entrypoint_compiles(flagship_job, capsys, monkeypatch):
    """``entrypoint()``, the console-script shim, runs ``mux --compile``
    from sys.argv and writes what the reference's shim writes."""
    from pheniqs_tpu.cli import main as reference
    from pheniqs_tpu_torch.cli import main as port

    _, config, _ = flagship_job
    outputs = []
    for shim in (reference.entrypoint, port.entrypoint):
        monkeypatch.setattr(sys, "argv", ["pheniqs-tpu", "mux", "--config", config, "--compile"])
        capsys.readouterr()
        assert shim() == 0
        outputs.append(capsys.readouterr().out)
    assert outputs[1] == outputs[0] and outputs[1].startswith("{")
