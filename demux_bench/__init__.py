"""The benchmark of pheniqs_tpu_torch: FASTQ through named pipes into
``python -m pheniqs_tpu_torch mux``, SAM out through a pipe, on one card.

One run renders a cell's traffic from ``--seed``, launches the program's
CLI as a child process, measures a window once the first batches have
come out, and holds what came out to a plain reference
(``demux_bench/reference``) that shares no code with the program:

    python3 -m demux_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one cell is data, found by name from
``BENCHMARK.json``: ``configs/<config>.json`` (the instrument),
``traffic/<cell>.json`` (the reads, the run and the comparison's limits)
and ``metrics/<metric>.py`` (one reader a metric).
"""
