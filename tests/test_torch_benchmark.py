"""The port's benchmark program (``python -m pheniqs_tpu_torch.benchmark``)
on the CPU at a small size: its runs against strict, in process and through
the CLI, the device-time summary of a profiler trace, and the compile of
its runs, by the port's own compiler, against the reference compiler's."""

import json
import os

import pytest

from pheniqs_tpu_torch import benchmark
from pheniqs_tpu_torch.device.flagship import mdd_flagship_ontology


@pytest.mark.parametrize("cli", [False, True])
def test_benchmark_program_compares_runs_with_strict(tmp_path, capsys, cli):
    argv = [
        "mdd:strict", "mdd:hybrid", "mdd:fast", "--reads", "1500", "--threads", "2",
        "--batch-size", "1024", "--device", "cpu", "--work", str(tmp_path / "work"),
    ]
    assert benchmark.main(argv + (["--cli"] if cli else [])) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert [line["run"] for line in lines] == ["mdd:strict", "mdd:hybrid", "mdd:fast"]
    for line in lines[1:]:
        assert line["records"] == 1500
        # MDD decisions are integer-exact and the cellular decoder is re-resolved
        assert line["mismatches_vs_strict"] == 0
    if cli:
        assert all(line["rc"] == 0 for line in lines)
        assert "TorchStreamedDeviceEngine" in lines[1]["engine"][0]
    else:
        assert lines[1]["reads"] == 1500 and "resolved_fraction" in lines[1]
    assert not os.path.exists(tmp_path / "work")


def test_trace_summary_unions_device_intervals(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "phq_pamld_kernel<16>", "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "kernel", "name": "phq_pamld_kernel<16>", "ts": 120.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 140.0, "dur": 30.0},
        {"ph": "X", "cat": "kernel", "name": "phq_pack_kernel", "ts": 400.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 0.0, "dur": 1000.0},
    ]
    (tmp_path / "old.trace.json").write_text(json.dumps({"traceEvents": []}))
    path = tmp_path / "pheniqs_1.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    os.utime(tmp_path / "old.trace.json", (0, 0))
    summary = benchmark.trace_summary(str(tmp_path))
    # [100, 170] and [400, 500]: 170 us busy over a 400 us span
    assert summary["busy_s"] == pytest.approx(170e-6, rel=1e-12)
    assert summary["span_s"] == pytest.approx(400e-6, rel=1e-12)
    assert list(summary["top"]) == [
        "kernel: phq_pack_kernel", "kernel: phq_pamld_kernel<16>", "gpu_memcpy: Memcpy DtoH",
    ]
    assert [count for count, _ in summary["top"].values()] == [1, 2, 1]
    assert [ms for _, ms in summary["top"].values()] == pytest.approx([0.1, 0.06, 0.03], rel=1e-12)


def test_strict_runs_compile_with_the_reference_compiler(tmp_path):
    """The port's runs, strict ones included, compile with the port's own
    copy of the compiler; on the MDD flagship it gives the job the
    reference compiler gives, apart from the program line that names the
    job class."""
    from pheniqs_tpu.cli.interface import Interface
    from pheniqs_tpu.job import TranscodeJob

    ontology = mdd_flagship_ontology()
    paths = benchmark.synthesize_fastq_input(str(tmp_path / "in"), 200, ontology=ontology)
    out = str(tmp_path / "out.sam")
    config = tmp_path / "job.json"
    config.write_text(json.dumps(dict(benchmark.instruction(paths, out, ontology), threads=2)))
    job = TranscodeJob(Interface(["pheniqs-tpu", "mux", "--config", str(config), "--threads", "2"]).operation())
    job.compiler.assemble()
    reference = job.compiler.compile()
    port = benchmark.e2e_ontology(paths, out, 2, ontology)
    for key in ("program", "full command"):
        reference.pop(key), port.pop(key)
    assert reference == port


def test_with_inputs_runs_a_compiled_instruction_on_other_inputs(tmp_path, monkeypatch):
    """An instruction compiled on some inputs, pointed at other files of
    the same layout, equals the instruction compiled on those (but for the
    name of the temporary configuration it was read from), leaves the
    compiled one as it was, and runs (twice, compiling nothing) to the
    same SAM as a run that compiles."""
    import copy

    from pheniqs_tpu_torch.device.flagship import flagship_ontology

    ontology = flagship_ontology()
    small = benchmark.synthesize_fastq_input(str(tmp_path / "small"), 16, ontology=ontology)
    large = benchmark.synthesize_fastq_input(str(tmp_path / "large"), 64, ontology=ontology)
    out = str(tmp_path / "out.sam")
    compiled = benchmark.e2e_ontology(small, out, 2, ontology)
    kept = copy.deepcopy(compiled)
    volatile = ("full command", "program")
    moved = benchmark.with_inputs(compiled, large)
    fresh = benchmark.e2e_ontology(large, out, 2, ontology)
    assert {k: v for k, v in moved.items() if k not in volatile} == {
        k: v for k, v in fresh.items() if k not in volatile}
    assert compiled == kept
    with pytest.raises(ValueError):
        benchmark.with_inputs(compiled, large[:3])

    benchmark.run_e2e(large, out, fidelity="strict", threads=2, batch_size=32, device="cpu", ontology=ontology)
    expected = benchmark.sam_decisions(out)
    import pheniqs_tpu_torch.job as job

    built = []
    original = job.TranscodeJob
    monkeypatch.setattr(job, "TranscodeJob", lambda *args: built.append(args) or original(*args))
    for _ in range(2):
        os.unlink(out)
        stats = benchmark.run_e2e(large, out, fidelity="strict", threads=2, batch_size=32, device="cpu",
                                  ontology=ontology, compiled=compiled)
        assert stats["reads"] == 64 and benchmark.sam_decisions(out) == expected
    assert not built and compiled == kept
