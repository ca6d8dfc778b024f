"""Instruments at the sizes a CPU test holds: each cell of BENCHMARK.json
cut down, and a two-round combinatorial instrument shaped like
sci-RNA-seq (docs/scirnaseq_vignette.md: an 8 nt UMI and a 10 nt RT
barcode in R1, a 10 + 10 nt PCR pair in I1 and I2, two cellular PAMLD
decoders and no sample decoder), whose traffic varies its first cellular
decoder."""

import copy

from demux_bench import cells

#: each cell of BENCHMARK.json with the whitelist and library sizes at
#: which a CPU holds it (multiples of the 192 maps its traffic puts
#: barcodes through)
CELLS = {"tenx-v2-fast": (192 * 21, 192 * 2)}

_PAMLD = {"algorithm": "pamld", "noise": 0.05, "confidence_threshold": 0.99, "high_quality_threshold": 30,
          "high_quality_distance_threshold": 0}
SCI_CONFIG = {
    "name": "sci-rna-seq-small",
    "segments": [34, 10, 10, 50],
    "decoders": [
        {"role": "molecular", "algorithm": "naive", "tokens": [[0, 0, 8]]},
        # the random barcode probability 4^-W, the least the program takes
        dict(_PAMLD, role="cellular", barcodes=384, tokens=[[0, 8, 18]], random_barcode_probability=4.0 ** -10),
        dict(_PAMLD, role="cellular", barcodes=192, tokens=[[1, 0, 10], [2, 0, 10]],
             random_barcode_probability=4.0 ** -20),
    ],
}
SCI_TRAFFIC = {
    "fidelity": "fast", "threads": 2, "batch_size": 512, "pool_batches": 2,
    "vary": {"role": "cellular", "rotations": 2, "barcodes": 96},
    "warmup_batches": 1, "error_rate": 0.02,
    "check": {"sigma_tolerance": 0.001, "confidence_tolerance": 0.001,
              "limits": {"missing": 0, "decisions_apart": 0, "report_apart": 0, "confidence_gap": 0.001,
                         "shm_left": 0}},
}
INSTRUMENTS = sorted(CELLS) + ["sci-rna-seq-small"]


def small(name: str) -> cells.Cell:
    """A cell of BENCHMARK.json cut to a CPU's size, or the sci-RNA-seq
    instrument; 512-read batches, one warm-up batch, two threads."""
    if name == "sci-rna-seq-small":
        manifest = cells.load("tenx-v2-fast")
        return cells.Cell(name, 1, copy.deepcopy(SCI_CONFIG), copy.deepcopy(SCI_TRAFFIC),
                          manifest.end_to_end, manifest.per_layer)
    cell = cells.load(name)
    cell.traffic.update(batch_size=512, pool_batches=2, warmup_batches=1, threads=2)
    cell.config["decoders"][1]["barcodes"], cell.traffic["vary"]["barcodes"] = CELLS[name]
    return cell
