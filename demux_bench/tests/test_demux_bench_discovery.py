"""A configuration, a traffic mix and a metric added as files, with their
entries, are found by name without an edit to the harness."""

import json
import shutil

from demux_bench import cells
from demux_bench.cells import ROOT


def test_added_cell_is_found(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "demux_bench", tmp_path / "demux_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = tmp_path / "demux_bench"
    config = json.loads((bench / "configs" / "tenx-3p-v2.json").read_text())
    config.update(name="throwaway")
    (bench / "configs" / "throwaway.json").write_text(json.dumps(config))
    plan = json.loads((bench / "traffic" / "tenx-v2-fast.json").read_text())
    plan["pool_batches"] = 3
    (bench / "traffic" / "throwaway-mix.json").write_text(json.dumps(plan))
    (bench / "metrics" / "throwaway_share.py").write_text("def read(run):\n    return 42.0\n")
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "throwaway", "source": "https://example.org", "reduced": [],
                                "file": "demux_bench/configs/throwaway.json", "why": "a test"})
    manifest["workloads"].append({"name": "throwaway-cell", "config": "throwaway",
                                  "traffic": "throwaway-mix", "chips": 1, "why": "a test"})
    manifest["per_layer"].append({"name": "throwaway_share", "unit": "%", "better": "higher",
                                  "source": "program_counter", "layer": "device",
                                  "moves": "setup_s", "workloads": ["throwaway-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = cells.load("throwaway-cell", root=tmp_path)
    assert cell.config["name"] == "throwaway" and cell.traffic["pool_batches"] == 3
    assert [m["name"] for m in cell.per_layer] == ["throwaway_share"]
    assert "setup_s" in [m["name"] for m in cell.end_to_end]
    assert cells.reader("throwaway_share", root=tmp_path)(None) == 42.0
