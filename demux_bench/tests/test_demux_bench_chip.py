"""Each cell of BENCHMARK.json for a few seconds on the card, through the program's CLI, as
the benchmark runs it; the program's process loads neither JAX nor the
JAX package (``python -X importtime``). Skips where there is no card."""

import sys

import pytest

from demux_bench import cells, run

JAX = {"jax", "jaxlib", "flax", "pheniqs_tpu"}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["tenx-v2-fast"])
def test_cell_on_the_card(workload):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    program = [sys.executable, "-X", "importtime", "-m", "pheniqs_tpu_torch"]
    outcome, numbers, _ = run.run_cell(cells.load(workload), 4242, 3.0, traced=False, program=program)
    assert run.result_line(outcome, numbers, False, {})["correct"], numbers
    loaded = {line.rsplit("|", 1)[-1].strip().split(".")[0]
              for line in outcome.stderr.splitlines() if line.startswith("import time:")}
    assert "pheniqs_tpu_torch" in loaded and not loaded & JAX
