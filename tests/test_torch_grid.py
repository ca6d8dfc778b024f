"""The (reads, panel) grid of ``PHENIQS_TP="R:P"`` with R > 1 on the CPU
(mirrors tests/test_tp.py:32, :100 and :169): the grid posterior in
process against JAX's ``tp_posterior`` on (2, 4) and (4, 2) meshes of the
virtual CPU devices, the engine over gloo ranks (2:2, 4:2 and 3:1) against
the unsharded run, the 1:2 run and the strict engine, and the grid's
refusals.

Tolerances, each with its reason:
  * the grid posterior against JAX: best0 exact; best_p and sigma_p
    rtol 5e-4, sigma_best and the runner-up 1e-3 (test_tp.py:81-97:
    matmul blocking differs between the sharded and whole shapes);
  * the grid posterior against the one-row posterior in process: byte-equal
    (a row's posterior does not depend on the other rows of its slice);
  * the engines: fast records equal the unsharded run's, hybrid equals
    strict on every record; the report equals the 1:2 run's (or the
    unsharded run's), integers exact and floats within rtol 1e-6 (the
    rows' counter vectors add in float64 before the accumulators).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pheniqs_tpu.device.tp import tp_mesh
from pheniqs_tpu.device.tp import tp_posterior as jax_tp_posterior
from pheniqs_tpu_torch.device import distributed, tp
from pheniqs_tpu_torch.device.flagship import flagship_ontology
from test_hybrid import decisions
from test_torch_distributed import _report_apart
from test_torch_tp import REPO, _noise, _run_ranks, workload  # noqa: F401  (a fixture)

NAMES = ("best0", "best_p", "sigma_p", "sigma_best", "second_p")


@pytest.mark.parametrize("reads_axis,panel_axis", [(2, 4), (4, 2)])
def test_grid_posterior_matches_jax(workload, reads_axis, panel_axis):
    """R read slices, each merged over P shards, against the JAX
    ``tp_posterior`` on a (R, P) mesh on the same numpy inputs."""
    if len(jax.devices()) < reads_axis * panel_axis:
        pytest.skip("needs the virtual 8-device mesh")
    decoder, features, qpos = workload
    inputs = [x.numpy() for x in (features, qpos, decoder.likelihood_matrix, decoder.concentration)]
    theirs = jax_tp_posterior(tp_mesh(reads_axis, panel_axis), *map(jnp.asarray, inputs), _noise(decoder))
    ours = tp.grid_posterior(*map(torch.from_numpy, inputs), _noise(decoder), reads_axis, panel_axis)
    for name, mine, reference in zip(NAMES, ours, theirs):
        mine, reference = mine.numpy(), np.asarray(reference)
        assert mine.shape == reference.shape == (512,), name
        if name == "best0":
            np.testing.assert_array_equal(mine, reference)
        else:
            rtol = 5e-4 if name in ("best_p", "sigma_p") else 1e-3
            np.testing.assert_allclose(mine, reference, rtol=rtol, atol=1e-30, err_msg=name)
    one_row = tp.tp_posterior(*map(torch.from_numpy, inputs), _noise(decoder), panel_axis)
    for name, mine, whole in zip(NAMES, ours, one_row):
        assert mine.numpy().tobytes() == whole.numpy().tobytes(), name


@pytest.mark.parametrize("n,reads_axis", [(509, 4), (511, 3), (1, 2)])
def test_grid_posterior_rows_not_a_multiple(workload, n, reads_axis):
    """A batch whose size is not a multiple of R is padded to one, and the
    padding rows are cut off: the real rows' bytes are the one-row run's."""
    decoder, features, qpos = workload
    args = (features[:n], qpos[:n], decoder.likelihood_matrix, decoder.concentration, _noise(decoder))
    ours = tp.grid_posterior(*args, reads_axis, 2)
    for name, mine, whole in zip(NAMES, ours, tp.tp_posterior(*args, 2)):
        assert mine.shape == (n,) and mine.numpy().tobytes() == whole.numpy().tobytes(), name


@pytest.mark.parametrize(
    "value,shape",
    [("2:2", (2, 2)), ("1:1", (1, 1)), ("4:2", (4, 2)), ("0:2", None), ("2:0", None), ("2", None), ("a:b", None)],
)
def test_tp_shape(monkeypatch, value, shape):
    """Any R >= 1 and P >= 1; anything else a ValueError naming the value."""
    monkeypatch.setenv("PHENIQS_TP", value)
    if shape is None:
        with pytest.raises(ValueError, match=f"PHENIQS_TP={value}"):
            distributed.tp_shape()
    else:
        assert distributed.tp_shape() == shape


def test_grid_world_size_refused(monkeypatch):
    """WORLD_SIZE must be R * P; the message names both."""
    monkeypatch.setenv("PHENIQS_TP", "2:2")
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setattr(distributed, "_GROUP", None)
    with pytest.raises(ValueError, match=r"PHENIQS_TP=2:2 needs 4 ranks.*WORLD_SIZE is 3"):
        distributed.panel_group("cpu")


@pytest.mark.parametrize("rank,row,column,row_leader", [(0, 0, 0, True), (2, 0, 2, False), (3, 1, 0, True),
                                                         (5, 1, 2, False)])
def test_grid_roles(monkeypatch, rank, row, column, row_leader):
    """Grid rank g sits at row g // P and column g % P; column 0 leads its
    row; rank 0 alone leads the run."""
    monkeypatch.setenv("PHENIQS_TP", "2:3")
    monkeypatch.setenv("RANK", str(rank))
    group = distributed.PanelGroup(rank, 2, 3, torch.device("cpu"), "gloo", None, None, None)
    assert (group.row, group.column, group.row_leader) == (row, column, row_leader)
    assert group.row_leader_rank == 3 * row and group.transport == torch.device("cpu")
    assert distributed.is_row_leader() == row_leader
    assert distributed.is_leader() == (rank == 0) == group.leader


GRID_E2E = r"""
import json, sys
from pheniqs_tpu_torch.benchmark import run_e2e
from pheniqs_tpu_torch.device import tp
from pheniqs_tpu_torch.device.flagship import flagship_ontology
paths, out, report, fidelity, sample, cellular, batch = json.loads(sys.argv[1])
ontology = flagship_ontology(sample_barcodes=sample, cellular_barcodes=cellular)
stats = run_e2e(paths, out, fidelity=fidelity, threads=2, batch_size=batch, device="cpu", ontology=ontology,
                report_url=report)
print(json.dumps({"stats": stats, "collective_s": tp.collective_seconds}))
"""


def _inputs(tmp_path, n: int, sample: int = 96, cellular: int = 384):
    from pheniqs_tpu_torch.benchmark import synthesize_fastq_input

    ontology = flagship_ontology(sample_barcodes=sample, cellular_barcodes=cellular)
    return synthesize_fastq_input(str(tmp_path / "input"), n, ontology=ontology), ontology


def _default(tmp_path, paths, ontology, batch: int):
    """The unsharded port's fast records and report on one CPU device."""
    from pheniqs_tpu_torch.benchmark import run_e2e

    out, report = str(tmp_path / "default.sam"), str(tmp_path / "default.json")
    run_e2e(paths, out, fidelity="fast", threads=2, batch_size=batch, device="cpu", ontology=ontology,
            report_url=report)
    return decisions(open(out).read()), json.load(open(report))


def _grid(tmp_path, paths, shape: str, fidelity: str, batch: int, sample: int = 96, cellular: int = 384,
          threshold: int = 128):
    """run_e2e on every rank of PHENIQS_TP=`shape`: (rank 0's records, its
    report, each rank's printed line)."""
    reads, panel = (int(x) for x in shape.split(":"))
    label = shape.replace(":", "x")
    out, report = str(tmp_path / f"grid_{label}.sam"), str(tmp_path / f"grid_{label}.json")
    argument = json.dumps([paths, out, report, fidelity, sample, cellular, batch])
    outputs = _run_ranks(GRID_E2E, reads * panel, [argument], PHENIQS_TP=shape,
                         PHENIQS_TP_THRESHOLD=str(threshold))
    lines = [json.loads(text.strip().splitlines()[-1]) for text in outputs]
    return decisions(open(out).read()), json.load(open(report)), lines


def test_grid_engine_fast_matches_default(tmp_path):
    """PHENIQS_TP=2:2 (the 384-barcode panel sharded at threshold 128, the
    96-barcode one whole on each row leader): the unsharded run's fast
    records, and the 1:2 run's report."""
    paths, ontology = _inputs(tmp_path, 10000)
    default, default_report = _default(tmp_path, paths, ontology, 4096)
    one_row, one_row_report, _ = _grid(tmp_path, paths, "1:2", "fast", 4096)
    ours, report, lines = _grid(tmp_path, paths, "2:2", "fast", 4096)
    assert lines[0]["stats"]["reads"] == 10000
    assert [line["stats"] for line in lines[1:]] == [None, None, None]  # the other ranks write nothing
    assert len(ours) == len(default) == len(one_row) == 10000
    assert ours == default == one_row
    _report_apart(report, one_row_report)
    _report_apart(report, default_report)


def test_grid_engine_4x2_matches_default(tmp_path):
    """PHENIQS_TP=4:2 over eight gloo ranks: four rows, each merging its
    two shards; the unsharded run's fast records and report."""
    paths, ontology = _inputs(tmp_path, 8000)
    default, default_report = _default(tmp_path, paths, ontology, 4096)
    ours, report, lines = _grid(tmp_path, paths, "4:2", "fast", 4096)
    assert lines[0]["stats"]["reads"] == 8000 and len(lines) == 8
    assert ours == default
    _report_apart(report, default_report)


def test_grid_engine_rows_not_a_multiple(tmp_path):
    """PHENIQS_TP=3:1: batches of 1000 reads are padded to 1026 rows, a
    multiple of 3, and cut into three slices of 342; the padding rows are
    out of the records and the counters."""
    paths, ontology = _inputs(tmp_path, 2500, 24, 300)
    default, default_report = _default(tmp_path, paths, ontology, 1000)
    ours, report, lines = _grid(tmp_path, paths, "3:1", "fast", 1000, 24, 300)
    assert lines[0]["stats"]["reads"] == 2500 and len(ours) == 2500
    assert ours == default
    _report_apart(report, default_report)


def test_grid_hybrid_matches_strict(tmp_path):
    """``torchrun --nproc-per-node 4 -m pheniqs_tpu_torch mux --fidelity
    hybrid`` with PHENIQS_TP=2:2 (threshold 128) equals the reference's
    strict engine on every record of the flagship input."""
    paths, ontology = _inputs(tmp_path, 20000)
    config = {
        "input": list(paths),
        "template": {"transform": {"token": ["1::"]}},
        "sample": ontology["sample"],
        "cellular": ontology["cellular"],
        "molecular": ontology["molecular"],
    }
    outputs = {}
    for label, command, fidelity in (
        ("strict", [sys.executable, "-m", "pheniqs_tpu.cli.main"], "strict"),
        ("grid_hybrid", [sys.executable, "-m", "torch.distributed.run", "--standalone",
                         "--nproc-per-node", "4", "-m", "pheniqs_tpu_torch"], "hybrid"),
    ):
        out = tmp_path / f"out_{label}.sam"
        config_path = tmp_path / f"job_{label}.json"
        config_path.write_text(json.dumps(dict(config, output=[str(out)])))
        env = dict(os.environ, PYTHONPATH=REPO, PHENIQS_TORCH_DEVICE="cpu", JAX_PLATFORMS="cpu",
                   PHENIQS_TP="2:2", PHENIQS_TP_THRESHOLD="128")
        if label == "strict":
            env.pop("PHENIQS_TP")
        result = subprocess.run(
            [*command, "mux", "--config", str(config_path), "--fidelity", fidelity, "--threads", "2",
             "--batch-size", "8192"],
            env=env, capture_output=True, text=True, timeout=300,
        )
        assert result.returncode == 0, (label, result.stderr[-3000:])
        outputs[label] = decisions(out.read_text())
    assert len(outputs["strict"]) == 20000
    assert outputs["strict"] == outputs["grid_hybrid"]
