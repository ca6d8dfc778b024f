"""The port's partial-merge tool (pheniqs_tpu_torch/tools/merge.py; mirrors
tests/test_workflows.py::test_partial_merge_matches_single_run and
::test_partial_merge_rejects_mismatched_config). Those use the BDGGG
fixture; these run on the synthetic flagship input, on the port's strict
engine and on its device engine on the CPU (hybrid), with quality control
on so the channel histograms merge too.

Tolerances: the merged report equals the single run's on every integer
statistic, and on every float to 1e-12 relative (the float64 sums are
reassociated across the shards, test_workflows.py's rule)."""

import io
import json
import os
import subprocess
import sys

import pytest

from pheniqs_tpu_torch.device.flagship import flagship_ontology
from pheniqs_tpu_torch.job import run_job
from pheniqs_tpu_torch.tools import merge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOSTS = 3


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """A flagship job over 3000 synthetic reads, quality control on."""
    from pheniqs_tpu_torch.benchmark import instruction, synthesize_fastq_input

    work = tmp_path_factory.mktemp("merge")
    base = flagship_ontology(sample_barcodes=24, cellular_barcodes=48)
    paths = synthesize_fastq_input(str(work / "input"), 3000, ontology=base)
    config = dict(instruction(paths, "/dev/null", base), **{"enable quality control": True})
    config.pop("report url")
    path = work / "job.json"
    path.write_text(json.dumps(config))
    return str(path)


def _mux(config: str, fidelity: str, *args) -> str:
    stdout, stderr = io.StringIO(), io.StringIO()
    code = run_job(["pheniqs-tpu", "mux", "--config", config, "--precision", "15", "--batch-size", "500",
                    "--fidelity", fidelity, "--threads", "2", *args], stdout, stderr)
    assert code == 0, stderr.getvalue()[-3000:]
    return stderr.getvalue()


def _compare(a, b, where=""):
    assert type(a) is type(b), (where, a, b)
    if isinstance(a, dict):
        assert set(a) == set(b), (where, set(a) ^ set(b))
        for key in a:
            _compare(a[key], b[key], f"{where}/{key}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _compare(x, y, f"{where}[{i}]")
    elif isinstance(a, float):
        assert a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b)), (where, a, b)
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("fidelity", ["strict", "hybrid"])
def test_partial_merge_matches_single_run(job, tmp_path, monkeypatch, fidelity):
    """H = 3 shard runs (PHENIQS_SHARD=k:3) dump their raw sums
    (PHENIQS_PARTIAL); merged_report recombines them into the single run's
    report."""
    monkeypatch.setenv("PHENIQS_TORCH_DEVICE", "cpu")
    expected = json.loads(_mux(job, fidelity))
    partials = []
    for k in range(HOSTS):
        partial = tmp_path / f"partial_{k}.json"
        monkeypatch.setenv("PHENIQS_SHARD", f"{k}:{HOSTS}")
        monkeypatch.setenv("PHENIQS_PARTIAL", str(partial))
        _mux(job, fidelity, "--report", "/dev/null")
        partials.append(str(partial))
    monkeypatch.delenv("PHENIQS_SHARD")
    monkeypatch.delenv("PHENIQS_PARTIAL")
    shares = [json.loads(open(p).read())["incoming count"] for p in partials]
    assert sorted(shares) == [1000, 1000, 1000]  # six batches of 500, two a shard
    merged = merge.merged_report(job, partials)
    _compare(merged, expected)
    assert "multiplex" in merged  # quality-control channels survived the merge
    assert merged["incoming"]["count"] == 3000


def test_partial_merge_rejects_mismatched_config(job, tmp_path):
    """A partial from a different decoder layout is refused: exit 3, as
    `python -m pheniqs_tpu_torch.tools.merge` runs it."""
    bogus = tmp_path / "bogus.json"
    bogus.write_text(json.dumps({"pheniqs partial": 1, "decoders": []}))
    result = subprocess.run(
        [sys.executable, "-m", "pheniqs_tpu_torch.tools.merge", "--config", job, str(bogus)],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 3, (result.returncode, result.stderr[-500:])
    assert "partial has 0 decoders" in result.stderr
