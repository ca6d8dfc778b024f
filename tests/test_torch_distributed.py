"""Data parallelism over the reads on the CPU (mirrors
tests/test_device_classify.py::test_sharded_step_matches_single_device and
tests/test_multihost.py::test_multi_process_decode_and_psum): the port's
ShardedDecodeStep against JAX's make_sharded_decode_step on the virtual
8-device mesh and against the port's own DecodeStep, batches decoded
across gloo processes (initialize_multihost, host_batch_slices), and the
engine over 2 and 3 CPU slices (run_e2e).

Tolerances, each with its reason:
  * against JAX: the uncertain byte equal on every row; decoded indices
    and qcfail bits exact and confidences rtol 1e-5 on the rows neither
    side flags (exp and sum order differ by a few ulp: tests/test_torch_step.py);
    counters: integer columns exact (padding rows are masked out of the
    counters on the wire, so there is nothing to subtract), confidence
    sums rtol 1e-5 (the reference holds its psum to 1e-5);
  * against the port's one DecodeStep: the decision blob byte for byte
    (every slice runs the same plain versions on its rows); counters:
    integer columns byte-equal, confidence sums rtol 1e-6 (each slice's
    sum is rounded to f32 once before the float64 adds: at most R + 1
    roundings of 2^-24);
  * across processes: the gathered rank-order float64 sum byte-equal to
    the same sum in one process, and integer columns equal to one
    DecodeStep over the whole batch; each process's decisions byte-equal
    to that step's rows;
  * the engine: hybrid SAM equal to strict on every record; fast SAM
    records equal to the one-device run's; the report equal to the
    one-device run's on every integer, floats within rtol 1e-6 (the
    counter vectors of the slices add in float64 before the accumulators);
    so too three shard engines merged by merge_host_accumulators (their
    float64 sums reassociated).
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
from jax.sharding import Mesh

from pheniqs_tpu.device import compile_instrument as jax_compile
from pheniqs_tpu.device.step import make_sharded_decode_step
from pheniqs_tpu_torch.device import wire
from pheniqs_tpu_torch.device.distributed import host_batch_slices, initialize_multihost, reads_devices
from pheniqs_tpu_torch.device.flagship import flagship_ontology, mdd_flagship_ontology
from pheniqs_tpu_torch.device.instrument import carry_instrument, compile_instrument, instruments_on
from pheniqs_tpu_torch.device.step import DecodeStep, ShardedDecodeStep, pad_rows, slice_sum
from pheniqs_tpu_torch.tools.profile_step import WIDTHS, wire_blob
from test_device_classify import make_pamld_ontology, random_panel, simulate_reads
from test_hybrid import decisions
from test_torch_step import _hold_counters, _hold_settled_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIDENCES = ("accumulated_confidence", "accumulated_pf_confidence")


def _counters_apart(instrument, mine, theirs, rtol):
    """Integer columns byte-equal, confidence sums within `rtol`."""
    offset = 0
    for _, name, size in wire.counter_layout(instrument):
        a, b = mine[offset : offset + size], theirs[offset : offset + size]
        if name in CONFIDENCES:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
        offset += size
    assert offset == mine.size == theirs.size


def test_sharded_step_matches_jax():
    """The pamld_case shapes (24 barcodes of 12 nt, one segment) on the
    6-bit wire, 509 reads: JAX's sharded step over 8 devices on the blob
    padded to 512 rows, the port's over 8 CPU slices padding it itself."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual 8-device mesh")
    rng = np.random.default_rng(7)
    panel = random_panel(rng, 24, 12)
    ontology = {"sample": make_pamld_ontology(panel), "input segment cardinality": 1}
    n = 509
    code, qual, length = simulate_reads(rng, panel, n)
    length[rng.random(n) < 0.03] = 7  # short reads: flagged, re-resolved in f64
    qcfail = rng.random(n) < 0.03
    blob = wire.pack_h2d_blob([12], [(code, qual, length)], qcfail, qual_bits=6)
    reference = jax_compile(ontology)
    ours = carry_instrument(reference, "cpu")

    mesh = Mesh(np.array(jax.devices()[:8]), ("reads",))
    sharded = jax.jit(make_sharded_decode_step(reference, mesh, want_uncertain=True, pack_outputs=True,
                                               h2d_widths=[12], qual_bits=6))
    padded = pad_rows(torch.from_numpy(blob), 8).numpy()
    packed, flat = sharded({"blob": jnp.asarray(padded)})
    layout = wire.d2h_layout(ours, True)
    theirs = np.asarray(packed["blob"]).reshape(-1, layout["total"])[:n]

    step = ShardedDecodeStep(instruments_on(ours, ["cpu"] * 8), [12], 6, want_uncertain=True)
    out, counters = step(torch.from_numpy(blob))
    mine = out.numpy().reshape(-1, layout["total"])
    assert mine.shape == theirs.shape == (n, layout["total"])
    u = layout["uncertain_offset"]
    np.testing.assert_array_equal(mine[:, u], theirs[:, u])
    settled = ~mine[:, u].astype(bool)
    assert settled.mean() > 0.8
    _hold_settled_rows(layout, mine, theirs, settled)
    _hold_counters(ours, counters.numpy(), np.asarray(flat))


INSTRUMENTS = {
    "flagship": flagship_ontology,
    "mdd": mdd_flagship_ontology,
    # a panel past 1024 barcodes: the K7 path
    "k7": lambda: flagship_ontology(cellular_barcodes=4096),
}


@pytest.fixture(scope="module", params=sorted(INSTRUMENTS))
def one_step(request):
    """One DecodeStep over 3001 reads of the instrument on the j4 wire (a
    row count no slice count below divides): (instrument, wire, blob,
    counters)."""
    ontology = INSTRUMENTS[request.param]()
    instrument = compile_instrument(ontology, "cpu")
    arrays = wire_blob(ontology, instrument, 3001, seed=17)
    inputs = [torch.from_numpy(x) for x in arrays]
    out, counters = DecodeStep(instrument, WIDTHS, wire.JOINT4, want_uncertain=True)(*inputs)
    return instrument, inputs, out.numpy(), counters.numpy()


@pytest.mark.parametrize("slices", [1, 2, 3, 8])
def test_sharded_step_matches_one_step(one_step, slices):
    instrument, inputs, want_blob, want_counters = one_step
    step = ShardedDecodeStep(instruments_on(instrument, ["cpu"] * slices), WIDTHS, wire.JOINT4,
                             want_uncertain=True)
    assert [s.instrument for s in step.steps] == [instrument] * slices  # one card: one instrument
    out, counters = step(*inputs)
    assert out.numpy().tobytes() == want_blob.tobytes()
    if slices == 1:
        assert counters.dtype == torch.float32 and counters.numpy().tobytes() == want_counters.tobytes()
    else:
        assert counters.dtype == torch.float64
        _counters_apart(instrument, counters.numpy(), want_counters.astype(np.float64), rtol=1e-6)


def test_pad_rows_and_bounds():
    """pad_rows appends H2D_PAD | H2D_QCFAIL rows up to a multiple; the
    slices are contiguous and in read order."""
    blob = torch.arange(7 * 3, dtype=torch.uint8).view(7, 3)
    padded = pad_rows(blob, 4)
    assert padded.shape == (8, 3) and torch.equal(padded[:7], blob)
    assert padded[7].tolist() == [0, 0, wire.H2D_PAD | wire.H2D_QCFAIL]
    assert pad_rows(blob, 7) is blob
    instrument = compile_instrument(flagship_ontology(sample_barcodes=8, cellular_barcodes=8), "cpu")
    step = ShardedDecodeStep(instruments_on(instrument, ["cpu"] * 3), WIDTHS, wire.JOINT4)
    assert step.bounds(3072) == [(0, 1024), (1024, 2048), (2048, 3072)]


def test_reads_devices():
    """An explicit list passes through, capped by the ontology's "devices";
    the CPU is one device; "cuda" without a card raises."""
    assert reads_devices(["cpu"] * 3) == [torch.device("cpu")] * 3
    assert reads_devices(["cpu"] * 3, 2) == [torch.device("cpu")] * 2
    assert reads_devices(["cpu"] * 3, 0) == [torch.device("cpu")] * 3
    assert reads_devices("cpu", 4) == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            reads_devices("cuda")


def test_host_batch_slices_round_robin():
    owners = [[k for k in range(3) if host_batch_slices(k, 3)(index)] for index in range(7)]
    assert owners == [[0], [1], [2], [0], [1], [2], [0]]


def test_initialize_multihost_single_host(monkeypatch):
    """(0, 1) when WORLD_SIZE is unset or 1, and under PHENIQS_TP (whose
    ranks are the panel group's)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize_multihost() == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert initialize_multihost() == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("PHENIQS_TP", "1:4")
    assert initialize_multihost() == (0, 1)


HOST = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from pheniqs_tpu_torch.device import wire
from pheniqs_tpu_torch.device.distributed import host_batch_slices, initialize_multihost
from pheniqs_tpu_torch.device.flagship import flagship_ontology
from pheniqs_tpu_torch.device.instrument import compile_instrument
from pheniqs_tpu_torch.device.step import DecodeStep
from pheniqs_tpu_torch.tools.profile_step import WIDTHS, wire_blob

out_dir, batches, rows = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
process_id, num_processes = initialize_multihost()
ontology = flagship_ontology(sample_barcodes=16, cellular_barcodes=48)
instrument = compile_instrument(ontology, "cpu")
blob, ccb, qcb = (torch.from_numpy(x) for x in wire_blob(ontology, instrument, batches * rows, seed=5))
step = DecodeStep(instrument, WIDTHS, wire.JOINT4, want_uncertain=True)
owns = host_batch_slices(process_id, num_processes)
local, mine = None, {}
for index in range(batches):
    if owns(index):
        out, flat = step(blob[index * rows : (index + 1) * rows], ccb, qcb)
        mine[str(index)] = out.numpy()
        local = flat.to(torch.float64) if local is None else local + flat.to(torch.float64)
gathered = [torch.zeros_like(local) for _ in range(num_processes)]
dist.all_gather(gathered, local)
total = gathered[0]
for part in gathered[1:]:  # rank order
    total = total + part
np.savez(f"{out_dir}/host_{process_id}.npz", total=total.numpy(), local=local.numpy(), **mine)
dist.destroy_process_group()
print(json.dumps([process_id, num_processes]))
"""


@pytest.mark.parametrize("processes", [2, 4])
def test_multi_process_decode_and_counters(tmp_path, processes):
    """`processes` gloo processes (initialize_multihost from the env://
    environment) each decode the batches host_batch_slices gives them;
    the gathered rank-order float64 counter sum equals the same sum in
    one process, and one DecodeStep over the whole batch on every integer
    column."""
    batches, rows = 8, 128
    # the rendezvous store is held here, on a port the OS picked and kept
    # (tests/test_torch_tp.py:_run_ranks)
    store = torch.distributed.TCPStore("localhost", 0, world_size=processes, is_master=True,
                                       wait_for_workers=False)
    env = dict(os.environ, PYTHONPATH=REPO, WORLD_SIZE=str(processes), MASTER_ADDR="localhost",
               MASTER_PORT=str(store.port), TORCHELASTIC_USE_AGENT_STORE="True")
    env.pop("PHENIQS_TP", None)
    procs = [
        subprocess.Popen([sys.executable, "-c", HOST, str(tmp_path), str(batches), str(rows)],
                         env=dict(env, RANK=str(rank)), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(processes)
    ]
    try:
        outputs = [proc.communicate(timeout=300) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    for rank, (proc, (out, err)) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, err[-3000:]
        assert json.loads(out.strip().splitlines()[-1]) == [rank, processes]

    ontology = flagship_ontology(sample_barcodes=16, cellular_barcodes=48)
    instrument = compile_instrument(ontology, "cpu")
    blob, ccb, qcb = (torch.from_numpy(x) for x in wire_blob(ontology, instrument, batches * rows, seed=5))
    step = DecodeStep(instrument, WIDTHS, wire.JOINT4, want_uncertain=True)
    whole_blob, whole = step(blob, ccb, qcb)
    row_bytes = whole_blob.numel() // (batches * rows)
    hosts = [np.load(tmp_path / f"host_{rank}.npz") for rank in range(processes)]
    expected = hosts[0]["local"]
    for host in hosts[1:]:
        expected = expected + host["local"]
    for host in hosts:
        assert host["total"].tobytes() == expected.tobytes()
    for rank, host in enumerate(hosts):
        owned = [index for index in range(batches) if index % processes == rank]
        assert sorted(int(k) for k in host.files if k.isdigit()) == owned
        for index in owned:
            want = whole_blob[index * rows * row_bytes : (index + 1) * rows * row_bytes].numpy()
            assert host[str(index)].tobytes() == want.tobytes()
    _counters_apart(instrument, expected, whole.numpy().astype(np.float64), rtol=1e-6)


@pytest.fixture(scope="module")
def flagship_input(tmp_path_factory):
    from pheniqs_tpu_torch.benchmark import synthesize_fastq_input

    ontology = flagship_ontology(sample_barcodes=24, cellular_barcodes=48)
    paths = synthesize_fastq_input(str(tmp_path_factory.mktemp("reads") / "input"), 3000, ontology=ontology)
    return paths, ontology


def _run(paths, base, out, fidelity, devices=None, cap=None):
    """(SAM text, report, engine) of one run of the timed e2e engine on
    the CPU: 3000 reads in batches of 1024 (the last one partial)."""
    from pheniqs_tpu_torch.benchmark import e2e_ontology, make_engine

    ontology = e2e_ontology(paths, str(out), 2, base)
    if cap is not None:
        ontology["devices"] = cap
    engine = make_engine(ontology, fidelity, 2, "cpu", devices)
    engine._init_timeline()
    engine.execute(batch_size=1024)
    report = engine.finalize_report()
    return out.read_text(), report, engine


def _report_apart(mine, theirs, where=""):
    """Every integer equal, floats within rtol 1e-6."""
    assert type(mine) is type(theirs), where
    if isinstance(mine, dict):
        assert set(mine) == set(theirs), where
        for key in mine:
            _report_apart(mine[key], theirs[key], f"{where}/{key}")
    elif isinstance(mine, list):
        assert len(mine) == len(theirs), where
        for k, (a, b) in enumerate(zip(mine, theirs)):
            _report_apart(a, b, f"{where}[{k}]")
    elif isinstance(mine, float):
        assert mine == pytest.approx(theirs, rel=1e-6, abs=0), where
    else:
        assert mine == theirs, where


@pytest.mark.parametrize("slices", [2, 3])
def test_engine_slices_hybrid_equals_strict(flagship_input, tmp_path, slices):
    paths, base = flagship_input
    strict, _, _ = _run(paths, base, tmp_path / "strict.sam", "strict")
    hybrid, _, engine = _run(paths, base, tmp_path / "hybrid.sam", "hybrid", ["cpu"] * slices)
    assert len(engine.devices) == slices
    assert len(decisions(strict)) == 3000
    assert decisions(hybrid) == decisions(strict)


def _records(sam: str) -> list[str]:
    return [line for line in sam.splitlines() if not line.startswith("@")]


@pytest.mark.parametrize("slices", [2, 3])
def test_engine_slices_fast_equals_one_device(flagship_input, tmp_path, slices):
    """Fast mode over CPU slices: the same SAM records and report as one
    device (its f32 confidences are the same plain arithmetic per row)."""
    paths, base = flagship_input
    one, one_report, _ = _run(paths, base, tmp_path / "one.sam", "fast")
    many, many_report, engine = _run(paths, base, tmp_path / "many.sam", "fast", ["cpu"] * slices)
    assert len(engine.devices) == slices
    assert len(_records(one)) == 3000
    assert _records(many) == _records(one)
    _report_apart(many_report, one_report)


def test_engine_slices_run_upload_and_launch(flagship_input, tmp_path, monkeypatch):
    """The engine over slices decodes each batch through the one split,
    decode and gather of ShardedDecodeStep (upload, then launch), the
    methods that forward and multichip_bench drive: one of each a batch,
    the staging rows cut into the slices' rows, and the report that of one
    device (floats within rtol 1e-6)."""
    paths, base = flagship_input
    calls = []
    for name in ("upload", "launch"):
        original = getattr(ShardedDecodeStep, name)

        def counted(self, pieces, *args, _name=name, _original=original, **kwargs):
            rows = [pieces.shape[0]] if _name == "upload" else [piece.shape[0] for piece in pieces]
            calls.append((_name, rows))
            return _original(self, pieces, *args, **kwargs)

        monkeypatch.setattr(ShardedDecodeStep, name, counted)
    _, report, _ = _run(paths, base, tmp_path / "many.sam", "hybrid", ["cpu"] * 2)
    assert calls == [("upload", [1024]), ("launch", [512, 512])] * 3  # 3000 reads, batches of 1024
    monkeypatch.undo()
    _, one_report, _ = _run(paths, base, tmp_path / "one.sam", "hybrid")
    _report_apart(report, one_report)


def test_slice_sum_adds_in_slice_order():
    """slice_sum: float64, the rows added in order, the input untouched."""
    rows = torch.tensor([[1.0, 2.0**-30], [2.0**24, 1.0], [3.0, 2.0**-30]], dtype=torch.float32)
    total = slice_sum(rows)
    assert total.dtype == torch.float64
    assert total.tolist() == [1.0 + 2.0**24 + 3.0, 2.0**-30 + 1.0 + 2.0**-30]
    assert rows[0].tolist() == [1.0, 2.0**-30]


def test_engine_devices_key_caps_the_slices(flagship_input, tmp_path):
    """The ontology's "devices" (--devices) keeps the first of the listed
    devices."""
    paths, base = flagship_input
    _, _, engine = _run(paths, base, tmp_path / "capped.sam", "fast", ["cpu"] * 3, cap=2)
    assert engine.devices == [torch.device("cpu")] * 2
    assert len(engine._instruments) == 2


def test_run_e2e_reports_its_devices(flagship_input, tmp_path):
    from pheniqs_tpu_torch.benchmark import run_e2e

    paths, base = flagship_input
    listed = run_e2e(paths, str(tmp_path / "a.sam"), fidelity="fast", threads=2, batch_size=1024, device="cpu",
                     ontology=base, devices=["cpu"] * 3)
    counted = run_e2e(paths, str(tmp_path / "b.sam"), fidelity="fast", threads=2, batch_size=1024, device="cpu",
                      ontology=base, devices=2)
    strict = run_e2e(paths, str(tmp_path / "c.sam"), fidelity="strict", threads=2, batch_size=1024, ontology=base)
    assert (listed["devices"], counted["devices"], strict["devices"]) == (3, 1, 0)
    assert listed["reads"] == counted["reads"] == 3000


def test_merge_host_accumulators_gives_the_single_run(flagship_input, tmp_path, monkeypatch):
    """Three engines, each over its PHENIQS_SHARD=k:3 batches on two CPU
    slices, merged into the first (merge_host_accumulators): the report
    of one engine over every batch (floats within rtol 1e-6, the float64
    sums reassociated across the shards)."""
    from pheniqs_tpu_torch.benchmark import e2e_ontology, make_engine
    from pheniqs_tpu_torch.device.distributed import merge_host_accumulators

    paths, base = flagship_input
    _, whole, _ = _run(paths, base, tmp_path / "whole.sam", "hybrid", ["cpu"] * 2)
    engines = []
    for k in range(3):
        monkeypatch.setenv("PHENIQS_SHARD", f"{k}:3")
        engine = make_engine(e2e_ontology(paths, str(tmp_path / f"part_{k}.sam"), 2, base), "hybrid", 2, "cpu",
                             ["cpu"] * 2)
        engine._init_timeline()
        engine.execute(batch_size=1024)
        engines.append(engine)
    assert [engine.incoming_count for engine in engines] == [1024, 1024, 952]
    merge_host_accumulators(engines)
    _report_apart(engines[0].finalize_report(), whole)
