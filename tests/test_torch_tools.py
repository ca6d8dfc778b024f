"""The port's measurement tools (pheniqs_tpu_torch/tools/) on the CPU at
small sizes, against the JAX package's tools of the same names.

host_pipeline: the parse and parse+pack rungs count the reads and batches
the reference's ``_measure_prefix`` counts on the same FASTQ, and the full
rung counts every read. profile_step: every rung runs on both instruments
and the sweep at two sizes; the full rung's blob and counters against the
JAX ``make_decode_step`` on the same j4 blob, with tests/test_torch_step.py's
tolerances (indices and qcfail bits exact and the uncertain byte exact,
confidences rtol 1e-5 on settled rows; integer counters exact, confidence
sums rtol 1e-5). panel_memory: the synthetic decoder's codes and
concentrations equal the reference tool's; its classify against the JAX
``pamld_classify_device`` as tests/test_torch_large_panel.py holds the
chunked path (decisions exact and confidences rtol 1e-5 on settled rows);
``resident_bytes`` the sum of the tensors' nbytes. multichip_bench: the
device step over CPU slices, the scaling gate read on the work partition
(each slice's rows; no wall-clock comparison on cores that xdist workers
share), the e2e line over two CPU slices. profile_step's device_ms and
device_launches against a stub profiler: a trace holding fewer of a
wrapper's kernels than it counted is taken again, then refused (launches)
or replaced by CUDA events (time). Each tool refuses ``cuda`` on a machine
without one."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pheniqs_tpu.device import compile_instrument as jax_compile
from pheniqs_tpu.device.step import make_decode_step
from pheniqs_tpu.tools import host_pipeline as jax_host_pipeline
from pheniqs_tpu.tools import panel_memory as jax_panel_memory
from pheniqs_tpu_torch.benchmark import e2e_ontology, synthesize_fastq_input
from pheniqs_tpu_torch.device import classify, wire
from pheniqs_tpu_torch.device.instrument import compile_instrument
from pheniqs_tpu_torch.device.step import DecodeStep
from pheniqs_tpu_torch.tools import host_pipeline, panel_memory, profile_step
from test_torch_step import _hold_counters, _hold_settled_rows

READS = 4000
BATCH = 1024


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    work = tmp_path_factory.mktemp("host_pipeline")
    return synthesize_fastq_input(str(work / "in"), READS), str(work / "out.sam")


@pytest.mark.parametrize("packed", [False, True], ids=["parse", "parse+pack"])
def test_host_prefixes_count_what_the_reference_counts(fastq, monkeypatch, packed):
    paths, out = fastq
    mine = host_pipeline._measure_prefix(e2e_ontology(paths, out, 1), BATCH, packed, "cpu")

    from pheniqs_tpu.benchmark import e2e_ontology as jax_e2e_ontology

    sizes = []
    stage_engine = jax_host_pipeline._stage_engine

    def counting(ontology):
        engine = stage_engine(ontology)
        read_batches = engine.read_batches

        def counted(batch_size):
            for batch in read_batches(batch_size):
                sizes.append(batch.size)
                yield batch

        engine.read_batches = counted
        return engine

    monkeypatch.setattr(jax_host_pipeline, "_stage_engine", counting)
    theirs = jax_host_pipeline._measure_prefix(jax_e2e_ontology(paths, out, 1), BATCH, packed)
    assert mine["reads"] == theirs["reads"] == sum(sizes) == READS
    assert mine["batches"] == len(sizes) == -(-READS // BATCH)
    assert mine["reads_per_s"] > 0


def test_host_pipeline_ladder_counts_every_read(tmp_path, capsys):
    work = tmp_path / "work"
    argv = ["--reads", str(READS), "--batch", str(BATCH), "--threads", "2", "--device", "cpu",
            "--dir", str(work), "--out", str(tmp_path / "out.sam")]
    assert host_pipeline.main(argv) == 0
    captured = capsys.readouterr()
    rows = [json.loads(line) for line in captured.out.splitlines()]
    assert [row["stage"] for row in rows] == ["parse", "parse+pack", "full"]
    assert all(row["reads"] == READS and row["reads_per_s"] > 0 for row in rows)
    assert rows[-1]["threads"] == 2 and rows[-1]["batches"] == -(-READS // BATCH)
    closing = json.loads(captured.err.strip().splitlines()[-1])
    assert closing["metric"] == "host_pipeline_ceiling"
    assert list(closing["stages"]) == ["parse", "parse+pack", "full"]


@pytest.mark.parametrize("instrument", ["flagship", "mdd"])
def test_profile_step_runs_every_rung(instrument):
    rows = list(profile_step.profile(instrument, 1024, (512, 1024, 2048), iters=2, device="cpu"))
    assert [(row["variant"], row["batch"]) for row in rows] == [
        *((name, 1024) for name in profile_step.RUNGS), ("full", 512), ("full", 2048),
    ]
    for row in rows:
        assert row["instrument"] == instrument
        assert row["latency_ms"] > 0 and row["pipelined_ms"] > 0
        assert row["latency_reads_per_s"] > 0 and row["pipelined_reads_per_s"] > 0
        # device metrics exist only on a card
        assert row["device_ms"] is None and row["launches"] is None


def test_profile_step_markdown(capsys):
    rows = profile_step.main(["--device", "cpu", "--batch", "256", "--iters", "1", "--sweep", "", "--markdown"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu | flagship, depth 2"
    assert lines[1].startswith("| variant | batch | latency ms | pipelined ms | device ms | launches |")
    assert len(lines) == 3 + len(profile_step.RUNGS) == 3 + len(rows)


@pytest.mark.parametrize("instrument", ["flagship", "mdd"])
def test_profile_step_full_rung_matches_jax(instrument):
    ontology = profile_step.INSTRUMENTS[instrument]()
    ours = compile_instrument(ontology, "cpu")
    blob, ccb, qcb = profile_step.wire_blob(ontology, ours, 1024, seed=31)
    inputs = [tuple(torch.from_numpy(x) for x in (blob, ccb, qcb))]
    step = profile_step.make_step(ours)
    profile_step.hold_full(step, inputs)
    mine_blob, mine_counters = profile_step.rungs(step)["full"](*inputs[0])

    reference = jax_compile(ontology)
    jax_step = make_decode_step(
        reference, want_uncertain=True, want_counters=True, pack_outputs=True,
        h2d_widths=profile_step.WIDTHS, qual_bits="j4",
    )
    packed, flat = jax_step({"blob": jnp.asarray(blob), "ccb": jnp.asarray(ccb), "qcb": jnp.asarray(qcb)})
    layout = wire.d2h_layout(ours, True)
    mine = mine_blob.numpy().reshape(-1, layout["total"])
    theirs = np.asarray(packed["blob"]).reshape(-1, layout["total"])
    u = layout["uncertain_offset"]
    np.testing.assert_array_equal(mine[:, u], theirs[:, u])
    _hold_settled_rows(layout, mine, theirs, mine[:, u] == 0)
    _hold_counters(ours, mine_counters.numpy(), np.asarray(flat))


def test_run_to_names_the_step_stages():
    ontology = profile_step.INSTRUMENTS["flagship"]()
    ours = compile_instrument(ontology, "cpu")
    wire_args = [torch.from_numpy(x) for x in profile_step.wire_blob(ontology, ours, 256, seed=5)]
    step = DecodeStep(ours, profile_step.WIDTHS, "j4", want_uncertain=True)
    blob, flat = step(*wire_args)
    packed, counted = step.run_to("pack", *wire_args)
    decisions, flat_k4 = step.run_to("counters", *wire_args)
    assert torch.equal(packed, blob) and torch.equal(counted, flat) and torch.equal(flat_k4, flat)
    assert torch.equal(step.run_to("classify", *wire_args).decoded, decisions.decoded)
    assert torch.equal(step.run_to("unpack", *wire_args).qcfail, wire_args[0][:, -1] & wire.H2D_QCFAIL != 0)
    with pytest.raises(ValueError, match="unknown stage"):
        step.run_to("features", *wire_args)


def test_panel_decoder_matches_reference():
    mine = panel_memory.synthetic_panel_decoder(2048, 16, seed=7, device="cpu")
    theirs = jax_panel_memory.synthetic_panel_decoder(2048, 16, seed=7)
    np.testing.assert_array_equal(mine.panel_codes.numpy(), np.asarray(theirs.panel_codes))
    np.testing.assert_array_equal(mine.concentration.numpy(), np.asarray(theirs.concentration))
    np.testing.assert_array_equal(mine.likelihood_matrix.numpy(), np.asarray(theirs.likelihood_matrix))
    np.testing.assert_array_equal(mine.panel_codes_u8.numpy(), mine.panel_codes.numpy())
    assert (mine.barcode_count, mine.width, mine.noise) == (theirs.barcode_count, theirs.width, theirs.noise)
    with pytest.raises(ValueError, match="take K1"):
        panel_memory.synthetic_panel_decoder(1024, 16, device="cpu")


def test_panel_classify_matches_jax():
    from pheniqs_tpu.device.classify import pamld_classify_device as jax_classify
    from pheniqs_tpu.device.instrument import DeviceInstrument as JaxInstrument
    from pheniqs_tpu.phred import SUBSTITUTION_LUT, TRUE_POSITIVE_QUALITY

    b, w, n = 2048, 16, 256
    mine_dec = panel_memory.synthetic_panel_decoder(b, w, seed=7, device="cpu")
    theirs_dec = jax_panel_memory.synthetic_panel_decoder(b, w, seed=7)
    rng = np.random.default_rng(3)
    code = mine_dec.panel_codes.numpy()[rng.integers(b, size=n)]
    flip = rng.random((n, w)) < 0.05
    code = np.where(flip, np.array([1, 2, 4, 8])[rng.integers(4, size=(n, w))], code)
    qual = rng.integers(5, 40, size=(n, w))
    qcfail = rng.random(n) < 0.05

    reference = JaxInstrument(
        decoders=[theirs_dec], multiplexing_index=0, input_segment_cardinality=1,
        substitution_lut=jnp.asarray(SUBSTITUTION_LUT.astype(np.float32)),
        tpq=jnp.asarray(TRUE_POSITIVE_QUALITY.astype(np.float32)),
    )
    theirs = jax_classify(
        reference, theirs_dec, jnp.asarray(code.astype(np.int32)), jnp.asarray(qual.astype(np.int32)),
        jnp.asarray(qcfail), want_uncertain=True,
    )
    ours = panel_memory.panel_instrument(mine_dec, torch.device("cpu"))
    mine = classify.pamld_classify_device(
        ours, mine_dec, torch.from_numpy(code.astype(np.uint8)), torch.from_numpy(qual.astype(np.uint8)),
        torch.from_numpy(qcfail), want_uncertain=True,
    )
    theirs = {k: np.asarray(v) for k, v in theirs.items()}
    mine = {k: v.numpy() for k, v in mine.items()}
    settled = ~(theirs["uncertain"] | mine["uncertain"])
    assert settled.mean() > 0.5
    for key in ("decoded", "argmax", "distance", "branch", "qcfail"):
        np.testing.assert_array_equal(mine[key][settled], theirs[key][settled], err_msg=key)
    np.testing.assert_allclose(mine["confidence"][settled], theirs["confidence"][settled], rtol=1e-5, atol=0)


@pytest.mark.parametrize("b,w", [(2048, 16), (3000, 10)])
def test_resident_bytes_counts_the_decoder_tensors(b, w):
    dec = panel_memory.synthetic_panel_decoder(b, w, device="cpu")
    resident = panel_memory.resident_bytes(dec)
    tensors = (dec.panel_codes, dec.panel_codes_u8, dec.likelihood_matrix, dec.concentration)
    assert resident["total"] == sum(t.numel() * t.element_size() for t in tensors) == (25 * w + 4) * b
    assert panel_memory.allocator_slack(resident) == 4 * 512 + (1 << 20) * sum(
        t.numel() * t.element_size() > 1 << 20 for t in tensors
    )


def test_panel_memory_rows_on_the_cpu(capsys):
    rows = panel_memory.main(["--sizes", "2048,3000", "--batch", "256", "--iters", "1", "--device", "cpu"])
    assert [json.loads(line) for line in capsys.readouterr().out.splitlines()] == rows
    assert [row["panel_b"] for row in rows] == [2048, 3000]
    for row in rows:
        assert row["resident_bytes"] == (25 * 16 + 4) * row["panel_b"]
        assert row["device"] == "cpu" and row["allocated_growth"] is None and row["memory_after"] is None
        assert row["latency_s"] > 0 and row["decoded_fraction"] > 0.8


@pytest.mark.parametrize("tool,argv", [
    (host_pipeline, ["--reads", "100"]),
    (profile_step, ["--batch", "256", "--sweep", ""]),
    (panel_memory, ["--sizes", "2048", "--batch", "256"]),
])
def test_tools_refuse_cuda_without_a_gpu(tool, argv, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if tool is host_pipeline:
        argv = argv + ["--dir", str(tmp_path / "in")]
    for device in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            tool.main(argv + device)
    assert not (tmp_path / "in_100_20260818").exists()


# --- multichip_bench: ShardedDecodeStep's rate and the scaling gate ---------


def test_multichip_device_step_on_the_cpu():
    """run_device_step on --device cpu: 3 slices on the one CPU device,
    placed round-robin and said so, each a third of the padded batch."""
    from pheniqs_tpu_torch.tools import multichip_bench

    row = multichip_bench.run_device_step(3, 2000, reps=2, device="cpu")
    assert row["devices"] == ["cpu"] * 3 and row["round_robin"] is True
    assert row["reads_per_device_shard"] == 667 and row["timer"] == "host clock" and row["kind"] == "cpu"
    assert len(row["step_ms_all"]) == 2 and row["reads_per_s"] > 0


@pytest.mark.parametrize("broken", [False, True])
def test_multichip_scaling_gate_reads_the_partition(monkeypatch, broken):
    """The port's counterpart of tests/test_scaling_gate.py, on the work
    partition and not on wall-clock times (xdist workers share the cores):
    with PHENIQS_SCALING_BREAK=1 every slice holds the whole batch, without
    it a quarter."""
    from pheniqs_tpu_torch.tools import multichip_bench

    if broken:
        monkeypatch.setenv("PHENIQS_SCALING_BREAK", "1")
    else:
        monkeypatch.delenv("PHENIQS_SCALING_BREAK", raising=False)
    result = multichip_bench.run_scaling(4, reads=1024, device="cpu")
    assert result["single"]["reads_per_device_shard"] == 1024
    assert result["sharded"]["reads_per_device_shard"] == (1024 if broken else 256)
    assert result["partition_efficiency"] > 0


def test_multichip_bench_virtual_e2e(tmp_path, capsys, monkeypatch):
    """--virtual 2: the e2e engine over two CPU slices, one JSON line."""
    from pheniqs_tpu_torch.tools import multichip_bench

    monkeypatch.setenv("PHENIQS_BENCH_DIR", str(tmp_path))
    assert multichip_bench.main(["--virtual", "2", "--reads", "2000", "--batch-size", "1024",
                                 "--threads", "2", "--fidelity", "fast"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["metric"] == "multichip_e2e_fast" and row["hosts"] == 1
    assert row["devices_per_host"] == 2 and row["reads"] == 2000 and row["kind"] == "cpu"


def test_multichip_bench_refuses_cuda_without_a_gpu(monkeypatch):
    from pheniqs_tpu_torch.tools import multichip_bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--device-step"], ["--device-step", "--device", "cuda"], ["--reads", "100"]):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            multichip_bench.main(argv)


# --- profile_step: readings held to the kernels' launch counters ------------


class _Trace:
    """A torch.profiler result with the given device activities."""

    def __init__(self, names, device_us=1000.0):
        from torch.autograd import DeviceType

        self.names, self.device_us, self.cuda = names, device_us, DeviceType.CUDA

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        from types import SimpleNamespace

        return [SimpleNamespace(name=name, device_type=self.cuda) for name in self.names]

    def key_averages(self):
        from types import SimpleNamespace

        return [SimpleNamespace(self_device_time_total=self.device_us)]


def _stub_profiler(monkeypatch, traces):
    """torch.profiler.profile handing out `traces` in turn; no card."""
    import torch.profiler

    queue = list(traces)
    monkeypatch.setattr(torch.profiler, "profile", lambda **kwargs: queue.pop(0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    return queue


def _launching():
    """A call that counts two kernel launches, as K3 and K5 would."""
    from pheniqs_tpu_torch.kernels import pack, unpack

    unpack.launches += 1
    pack.launches += 1


UNPACK = "phq_unpack_kernel(unsigned char const*, int, int)"
PACK = "void phq_pack_kernel<4>(int, int, unsigned int)"
TORCH = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>(int)"


@pytest.mark.parametrize("dropped", ["a kernel", "a wrapper's kernel beside a torch kernel"])
def test_device_launches_refuses_a_short_trace(monkeypatch, dropped):
    """Two traces that miss K5's kernel for its counted launch (a memset
    and a copy do not count as kernels, and neither does a kernel torch
    launches itself, so a trace as long as the count may still be short):
    device_launches raises with both counts; a whole second trace is taken
    instead."""
    short = [UNPACK, "Memset (Device)", "Memcpy DtoH (Device -> Pinned)"]
    if dropped != "a kernel":
        short.append(TORCH)
    _stub_profiler(monkeypatch, [_Trace(short), _Trace(short)])
    with pytest.raises(RuntimeError, match="pack_outputs: 0 in the trace, 1 launched"):
        profile_step.device_launches(_launching)
    whole = [UNPACK, "Memset (Device)", PACK]
    queue = _stub_profiler(monkeypatch, [_Trace(short), _Trace(whole)])
    assert profile_step.device_launches(_launching) == {UNPACK: 1, "Memset (Device)": 1, PACK: 1}
    assert not queue


def test_device_ms_falls_back_on_a_short_trace(monkeypatch, capsys):
    """device_ms gives no reading from a short trace: after two it times
    by the replay of a CUDA graph of the calls (graph_ms, device time
    alone) and says so with both counts; a whole trace gives its device
    time per call."""
    short = _Trace([UNPACK] * 4 + [PACK] * 3 + [TORCH], device_us=50.0)  # K5 3 times for 4 calls
    _stub_profiler(monkeypatch, [short, short])
    monkeypatch.setattr(profile_step, "graph_ms", lambda fn, reps: (7.5, {}))
    monkeypatch.setattr(profile_step, "event_ms", lambda fn, reps: pytest.fail("timed with launch gaps"))
    assert profile_step.device_ms(_launching, reps=4) == 7.5
    err = capsys.readouterr().err
    assert "pack_outputs: 3 in the trace, 4 launched" in err and "CUDA graph" in err
    _stub_profiler(monkeypatch, [short, _Trace([UNPACK, PACK] * 4, device_us=2000.0)])
    assert profile_step.device_ms(_launching, reps=4) == 0.5


def test_device_ms_times_with_events_only_where_the_calls_cannot_be_captured(monkeypatch, capsys):
    """Where a short trace's calls cannot be captured in a CUDA graph
    (graph_ms raises), device_ms times them with CUDA events and says that
    the launch gaps are counted."""
    short = _Trace([UNPACK] * 3, device_us=50.0)
    _stub_profiler(monkeypatch, [short, short])

    def refuse(fn, reps):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(profile_step, "graph_ms", refuse)
    monkeypatch.setattr(profile_step, "event_ms", lambda fn, reps: 9.25)
    assert profile_step.device_ms(_launching, reps=4) == 9.25
    assert "launch gaps included" in capsys.readouterr().err


class _Graph:
    """torch.cuda.CUDAGraph and torch.cuda.graph without a card: the
    captured calls run once, at capture; a replay runs nothing."""

    replays = 0

    def replay(self):
        _Graph.replays += 1


class _Event:
    times = iter((2.0, 14.0))

    def __init__(self, enable_timing=False):
        pass

    def record(self):
        self.at = next(_Event.times)

    def elapsed_time(self, end):
        return end.at - self.at


@pytest.mark.parametrize("calls", [_launching, "uneven"])
def test_graph_ms_reads_the_launches_at_capture(monkeypatch, calls):
    """graph_ms reads the wrappers' launch counts just before and just
    after the capture of `reps` calls (one warm-up call before it, not
    counted), times only the replays (one untimed, then `replays` between
    two events) and gives the time and the launches a call; launches that
    differ between the captured calls are refused."""
    import contextlib

    from pheniqs_tpu_torch.kernels import launch_counts, unpack

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph, raising=False)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph: contextlib.nullcontext(), raising=False)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(_Event, "times", iter((2.0, 14.0)))
    monkeypatch.setattr(_Graph, "replays", 0)
    if calls == "uneven":
        state = iter(range(100))

        def calls():
            unpack.launches += next(state) % 2

        with pytest.raises(RuntimeError, match="not a multiple"):
            profile_step.graph_ms(calls, reps=4)
        return
    before = launch_counts()
    ms, launched = profile_step.graph_ms(calls, reps=4, replays=3)
    assert ms == (14.0 - 2.0) / (3 * 4) and _Graph.replays == 1 + 3
    assert {name: n for name, n in launched.items() if n} == {"unpack_tokens": 1, "pack_outputs": 1}
    assert launch_counts()["unpack_tokens"] == before["unpack_tokens"] + 1 + 4
