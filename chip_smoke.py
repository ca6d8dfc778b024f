#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pheniqs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --nccl     # on a host with >= 2 cards: only the
                                     # PHENIQS_TP runs over NCCL (1:2; 1:4 and
                                     # the 2:2 grid on four cards) and their
                                     # strict reference, and the reads phase over
                                     # cuda:0 and cuda:1 with multichip_bench's
                                     # whitelist rates over 1, 2 (and 4) cards
    python3 chip_smoke.py --times T  # only the tile loop's, K3's, K6's,
                                     # K4's, K5's (on each path's layout)
                                     # and the decode steps' device times
                                     # and launches, the plan's choice at
                                     # batch sizes from 16384 to 262144
                                     # and K1's slice unit, K3's column-
                                     # plan rows and K6's wide rows, K4's
                                     # and K5's rows at 3 to 64 decoders
                                     # by device time alone with their
                                     # probes (epilogue), the package
                                     # imported from tree T, a copy of
                                     # another commit inside this
                                     # checkout; --sections picks some

It drives six paths of the port, all on the flagship read layout
(150 + 8 + 8 + 26 nt, RTA3 qualities; the wide flagship's segment 3 is
106 nt): the wide flagship (a 96-nt cellular panel), the flagship (PAMLD 96 sample
barcodes, PAMLD 384 cell barcodes, naive UMI), the MDD flagship (its sample
decoder MDD at distance tolerance [1, 1]), the whitelist flagship (its
cellular panel a 737,280-barcode 16 nt whitelist) and the panel-sharded
path (PHENIQS_TP=1:2: two ranks, the 4096-barcode cellular panel of a
flagship variant split between them; the 2:2 grid, four ranks, its reads
split over two rows too) and the reads axis (the engine's batches cut
over two slices, ShardedDecodeStep). Phases, each printing its own lines;
any failure propagates and the exit code is not 0:

  1. environment  a CUDA GPU is present; its name and power limit
                  (nvidia-smi); TF32 off for matmul and cuDNN; whether the
                  port's native host library loaded
  2. build        nvcc builds every csrc/*.cu kernel from this checkout
                  (one nvcc process per source, in parallel)
  3. kernels      each kernel against its plain torch version on the card
                  at main-path shapes (N=131072, j4 wire): on the flagship
                  (plus a 1024-barcode panel for K1, and K3 on every wire
                  layout and the general gather, two launches identical,
                  with its reads a block and shared bytes, and on its edge
                  cases under the block plan and the column plan: N = 0,
                  1, R - 1, R + 1, 16384 + 7, blobs off 16-byte
                  alignment, unpack_edge_checks), on the MDD
                  flagship (K6 byte-exact and two launches identical, also
                  at tolerance 2 with quality masking and short reads; its
                  share of reads resolved by the key table and reads
                  scanned a warp; a panel with a duplicated barcode, 5-,
                  24- and 64-position and 2000-barcode panels on unaligned
                  rows, and a wide panel of 8 bit planes,
                  mdd_edge_checks; K5 byte-exact, two launches
                  identical and nothing written past its span on eight
                  layouts of 10-261 bytes a read at N = 0 to 131071,
                  pack_edge_checks, and its plan on each path; ptxas'
                  registers of K3, K6 and K5; the decode steps' device
                  launches a batch)
                  and on a 4096-barcode cellular panel (K7);
                  K1 and K7 launched twice, byte-identical; the sliced K1
                  held to its one-launch instance on the same batch
                  (sliced_vs_one_launch: argmax, decoded and distance
                  bit-equal, the rest apart only at the confidence
                  threshold, counted); the uncertain
                  flags of K1, K7 and the whole step held to the plain
                  version's (check_flags), K4 twice and against
                  its plain version byte for byte, the GPU-measured TPQ
                  epsilon, per-kernel device times of kernel, plain
                  version and, where one PyTorch call computes the same
                  function, that call; K4 on its edge cases (k4_edge_checks:
                  one bin, the last bin, argmax apart from decoded, extreme
                  confidences, no valid row, forced rows, N = 0, N not a
                  multiple of a block's share, 737,281 bins, a batch K4
                  sums in row slices) and its shared-memory threshold
                  sweep; the tile loop as the card runs it (registers,
                  spills and blocks/SM of each instance; the slices, cuts
                  and waves of each panel, K1's included, tile_loop_report);
                  then every kernel of the whitelist's decode step (K3, K7 at 737,280 barcodes, K4
                  over 737,281 bins, timed, K5's int32 index), where the
                  bound flags nearly every row and the decisions are held
                  on all rows (each differing row a near tie in f64, but
                  for at most WIDE_DISAGREE_LIMIT of them), K7
                  timed once each; and K8 at the whitelist over P = 2 and
                  4 shards in one process, held to K7 and to its plain
                  version, per shard timed
  3b. wide        the inputs the kernels once refused, N=131072: K1 at
                  W = 65-300 (its looped instance) on 96 and 384
                  barcodes, at W = 97 x B = 101 and with 5 of 384
                  barcodes holding an N, K7 at 96 x 4096 and K8 over two
                  shards of it, each launched twice (identical), its decisions
                  bit-equal to the tile-order twin and apart from the plain
                  version only on near ties in f64 or at a threshold both
                  flag (wide_pamld_entry, wide_k8_entry); K6's wide
                  instance at 9 and 12 segments of 80 and 130 positions,
                  K3's column plan on programs of ~3,000 (beside the block
                  plan) and ~10,000 ints and 2048 length columns, K4 and
                  K5 at 33 and 64 decoders (device time alone: the replay
                  of a CUDA graph of 10 calls, their plans' groups, reads
                  a block, shared bytes and ptxas' registers) and K5's
                  rows in place, byte-exact (their edge cases also in the
                  kernels phase); each timed beside its bound (the kernels
                  line's extra.wide); the wide flagship (a 96-nt cellular
                  barcode) hybrid identical to strict on 20k reads, its f64
                  re-resolution rate beside the bound's prediction, its
                  launches, and fast against strict on 200k reads, every
                  record apart a near tie; the same on its 4096-barcode
                  variant on fewer reads; the wide MDD instrument (an MDD
                  sample barcode of 12 segments and 130 positions,
                  tolerance 2) hybrid identical to strict on 20k reads,
                  its K6 launches counted
  4. decisions    the hybrid port (streamed engine, forked render workers)
                  identical to the strict f64 engine: on 200k flagship
                  reads, on 200k MDD-flagship reads and on 20k reads of a
                  4096-barcode cellular panel (K7); the f64 re-resolution
                  rate at most RESOLVED_LIMIT; and the fast port on 1024
                  whitelist reads differing from strict in at most
                  WHITELIST_FAST_LIMIT records. The 737,280-barcode
                  instruction compiles once, in a process of its own
                  while phases 3 and 3b run (PRECOMPILE), and every
                  whitelist e2e run (here, in throughput and in grid)
                  runs it on its own inputs (run_e2e's `compiled`)
  5. throughput   the e2e runs at batch 131072: the flagship hybrid on ~2M
                  reads, the MDD flagship hybrid on ~1M, the whitelist fast
                  on 4 batches; run_e2e's stats and each kernel's launch
                  count in each run (counts set to 0 just before it), every
                  kernel of a path launched in that path's run
  6. tp           PHENIQS_TP=1:2 through run_e2e in two processes sharing
                  the card (gloo), hybrid on the 20k reads of the
                  4096-barcode panel (threshold 2048), identical to the
                  strict run of phase 4; each rank's launch counts (set to
                  0 just before) and backend; on a host with two cards the
                  same run over NCCL
  6b. grid        the (reads, panel) grid: PHENIQS_TP=2:2 as four processes
                  sharing the card (gloo), hybrid on the same 20k reads,
                  identical to strict, each role's launches (rank 0 and the
                  other row's leader: K3, K1, K8, K4, K5; the followers: K3,
                  K8), the report that of the 1:2 run (integers exact,
                  floats within rtol 1e-6); the whitelist fast on two
                  batches of 131072 at 2:2 against the 1:2 decode of the
                  same batches (rank 0's instrument, both shards in one
                  step on the card): each batch's decision rows byte-equal
                  where every row's K1/K8 plans are 1:2's, else held by
                  blob_apart; rank 0's batch seconds beside the 1:2 step's,
                  each rank's collective seconds, the phase's time
  6c. prior       the two-pass PAMLD workflow: pass 1 hybrid on 50k flagship
                  reads writes its report, tools/prior folds the estimated
                  noise and concentrations into the job, pass 2 hybrid on
                  the adjusted job identical to strict on it
  7. reads        data parallelism over the reads: ShardedDecodeStep with
                  two slices (two cards where there are two, else two
                  streams on one) against the one-card DecodeStep at
                  N=131072 on the flagship, the MDD flagship and the
                  whitelist: each slice's K1/K7 plans beside one card's,
                  the decision blob byte for byte where they agree, else
                  held as pamld.against_one_launch holds the sliced K1
                  (blob_apart; the rows apart counted), the counters'
                  integer columns exact, each slice's kernel launches
                  (the wrappers' counts; one card's flagship step: 5,
                  9 device launches with memsets); the engine over two
                  slices hybrid on phase 4's flagship reads identical to
                  strict; hybrid on 1M flagship reads at R = 1 and 2 (and
                  fast over two cards), the same records and the same
                  report (integers exact, floats within rtol 1e-6), wall
                  and steady rates side by side; multichip_bench's
                  device-step line at R = 1 and 2 (CUDA events); on a host
                  with two or more cards, its whitelist fast e2e line at
                  R = 1, 2 (and 4), 16 batches each
  8. tools        the measurement tools of pheniqs_tpu_torch/tools/, each
                  row on a line of its own: host_pipeline's parse,
                  parse+pack and full (null device) rungs over phase 5's
                  flagship FASTQ and its ceiling line; profile_step's
                  ladder (null, unpack, classify, counters, full) on the
                  flagship at N=131072 with the full step swept over
                  16384-1048576 reads, and on the MDD flagship (latency,
                  pipelined, device time and launches), each full rung the
                  same bytes as DecodeStep.forward; panel_memory at 65536
                  and 262144 barcodes of 16 nt (K7 over 131072 reads, 3
                  calls), the growth of memory_allocated while the panel
                  is built held to its resident bytes within the
                  allocator's rounding
  9. result       no module of jax or pheniqs_tpu in sys.modules, the card
                  line, the kernels JSON line (with each kernel's bound from
                  its bytes and operations; K4's entry adds its peak
                  allocation, its time, bound, plain time, yardstick and
                  peak at the whitelist, and the threshold sweep; K7's its
                  slices, waves, blocks/SM and registers at the whitelist),
                  then the last line
                  {"ok": true, "device": {"platform": "gpu", ...}}

Imports nothing of JAX and nothing of the JAX package. Work files live in
.chip_smoke/ beside this script and are removed at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, ".chip_smoke")
N_KERNEL = 131072
N_DECISIONS = 200_000
N_K7_DECISIONS = 20_000
N_WHITELIST_STRICT = 1024
N_THROUGHPUT = 2_000_000
N_MDD_THROUGHPUT = 1_000_000
BATCH = 131072
N_WHITELIST_THROUGHPUT = 4 * BATCH
#: panel_memory's sizes in the tools phase (W = 16, N = N_KERNEL)
PANEL_SIZES = (65536, 262144)
#: the cellular panel of the K7 checks whose hybrid bound stays narrow
K7_PANEL = 4096
#: the share of rows on which a kernel and its plain version may disagree
#: about the hybrid uncertain flag (rounded down: none at N < 10^5): only a
#: row on the very edge of the bound can flip, as the sigma sums are added
#: in another order
FLAG_DISAGREE_LIMIT = 1e-5
#: the share of rows either run may flag beyond the rows the rules force
#: (short observations, padding, forced wire rows); flagship data flags
#: none beyond them at N=131072
FLAG_EXTRA_LIMIT = 1e-3
#: the highest f64 re-resolution share the e2e runs may show on flagship
#: reads (about 1e-5 of them fall inside the bound)
RESOLVED_LIMIT = 1e-3
#: at the whitelist's 737,280 barcodes the bound flags nearly every row,
#: so kernel and plain version are held on every row: their decisions may
#: differ on rows whose two best barcodes are a near tie in f64 (within the
#: rounding of sigma's terms summed in two orders; near_tie_rows) and on at
#: most this share of other rows (a confidence and its threshold within the
#: rounding of 737,280 terms summed in two orders), and their confidences
#: agree within WIDE_CONFIDENCE_RTOL where the decisions do and the rules
#: force nothing
WIDE_DISAGREE_LIMIT = 1e-4
WIDE_CONFIDENCE_RTOL = 1e-4
#: the most records of N_WHITELIST_STRICT whitelist reads on which the fast
#: port (f32, no re-resolution) may differ from the strict f64 engine
WHITELIST_FAST_LIMIT = 8

#: PHENIQS_TP_THRESHOLD of the 2-rank run: it shards the K7_PANEL
#: variant's cellular panel and leaves its 96-barcode sample panel whole
TP_THRESHOLD = 2048
#: the panel counts of K8's in-process checks at the whitelist
K8_PANELS = (2, 4)
#: the H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s,
#: f32 operations/s outside the
#: tensor cores (the PAMLD kernels may not use them: exact f32 sigma)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

#: kernel name -> (source in the repo, the TPU program's function it replaces)
KERNELS = {
    "unpack_tokens": ("pheniqs_tpu_torch/csrc/unpack_tokens.cu", "pheniqs_tpu/device/step.py:434"),
    "pamld_classify": ("pheniqs_tpu_torch/csrc/pamld.cu", "pheniqs_tpu/device/classify.py:402"),
    "counters": ("pheniqs_tpu_torch/csrc/counters.cu", "pheniqs_tpu/device/step.py:48"),
    "pack_outputs": ("pheniqs_tpu_torch/csrc/pack.cu", "pheniqs_tpu/device/step.py:685"),
    "mdd_classify": ("pheniqs_tpu_torch/csrc/mdd.cu", "pheniqs_tpu/device/classify.py:667"),
    # K1 on panels past 1024 barcodes, in place of the TPU's chunked posterior
    "pamld_chunked": ("pheniqs_tpu_torch/csrc/pamld.cu", "pheniqs_tpu/device/classify.py:240"),
    # the same tile loop over one shard of a panel split across ranks
    "pamld_panel_sharded": ("pheniqs_tpu_torch/csrc/pamld.cu", "pheniqs_tpu/device/classify.py:335"),
}

#: path -> the kernels its decode step runs
PATH_KERNELS = {
    "flagship": ("unpack_tokens", "pamld_classify", "counters", "pack_outputs"),
    "mdd": ("unpack_tokens", "mdd_classify", "pamld_classify", "counters", "pack_outputs"),
    "whitelist": ("unpack_tokens", "pamld_classify", "pamld_chunked", "counters", "pack_outputs"),
    "tp leader": ("unpack_tokens", "pamld_classify", "pamld_panel_sharded", "counters", "pack_outputs"),
    "tp row leader": ("unpack_tokens", "pamld_classify", "pamld_panel_sharded", "counters", "pack_outputs"),
    "tp follower": ("unpack_tokens", "pamld_panel_sharded"),
    # the wide phase's flagship variants (96-nt cellular barcodes)
    "wide": ("unpack_tokens", "pamld_classify", "counters", "pack_outputs"),
    "wide K7": ("unpack_tokens", "pamld_classify", "pamld_chunked", "counters", "pack_outputs"),
    # the wide MDD instrument (a sample barcode of 12 segments, 130 positions)
    "wide mdd": ("unpack_tokens", "mdd_classify", "pamld_classify", "counters", "pack_outputs"),
}


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them
    (tools/profile_step.py:card_line)."""
    import torch

    from pheniqs_tpu_torch.tools.profile_step import card_line as line

    return line(torch.device("cuda"))


def environment():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    say(f"[environment] {card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | devices {torch.cuda.device_count()}")
    from pheniqs_tpu_torch import native

    if native.load() is not None:
        say(f"[environment] native host library loaded: {os.path.relpath(native._LIBRARY, HERE)}")
    else:
        say(f"[environment] native host library NOT loaded (pure-Python host paths): {native.build_error()}")
    return card


def bound(entry: dict) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take
    for a kernel's work, the larger of its bytes (each input read once,
    each output written once) over HBM_BYTES_PER_S and its operations over
    F32_OPS_PER_S."""
    bytes_ms = entry["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = entry.get("ops", 0) / F32_OPS_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms > bytes_ms else (bytes_ms, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def classify_work(dec, n: int, w: int, plain: dict) -> tuple[int, int]:
    """(bytes, operations) one decoder's classify needs for `n` reads of
    width `w`: the observation, the panel and its concentrations read, the
    seven (N,) results written; PAMLD evaluates sigma once per (read,
    barcode), a match and a strictness compare and two f32 adds per
    position, then four operations of the posterior (exp, product, sum,
    compare); MDD compares and counts each position of the barcodes a read
    needs, whatever implements the function: a read with an exact match
    (``plain["exact"]``, mdd_exact_rows) its W positions once, any other
    read all B barcodes."""
    import torch

    b = dec.barcode_count
    moved = 2 * n * w + b * w + 4 * b + 2 * n + 19 * n
    if dec.algorithm == "mdd":
        needed = int(torch.where(plain["exact"], 1, b).sum())
        return moved, 2 * w * needed
    return moved, 4 * n * b * (w + 1)


def build_kernels():
    from pheniqs_tpu_torch.kernels import build

    start = time.perf_counter()
    path = build.build()
    build.library()
    seconds = time.perf_counter() - start
    say(f"[build] {path.name} built and loaded in {seconds:.1f} s")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            say(f"[build] {line.strip()}")


def ptxas_report(fragment: str, log: str | None = None) -> dict:
    """{kernel: "N registers, S B smem, spills"} from ptxas' report in the
    build log, for every entry function whose mangled name holds
    `fragment` (one line each instance)."""
    import re

    from pheniqs_tpu_torch.kernels import build

    report, name = {}, None
    for line in (build.build_log() if log is None else log).splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = entry.group(1) if fragment in entry.group(1) else None
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            report[name] = f"spills {spill.group(1)}/{spill.group(2)} B"
        used = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if used:
            report[name] = f"{used.group(1)} registers, {used.group(2) or 0} B static smem, {report.get(name, '')}"
    return report


# The timing helpers are the measurement tools' (tools/profile_step.py),
# imported on call: `--times TREE` puts another tree's package on the path
# before the first import of pheniqs_tpu_torch.
def device_ms(fn, reps: int = 10) -> float:
    """Device milliseconds per call of `fn` from torch.profiler, from a
    trace holding every kernel launch the wrappers counted, else from CUDA
    events (pheniqs_tpu_torch/tools/profile_step.py:device_ms)."""
    from pheniqs_tpu_torch.tools.profile_step import device_ms as measured

    return measured(fn, reps)


def device_launches(fn, tries: int = 2) -> dict:
    """{name: count} of the device activities one call of `fn` puts on the
    card, from a trace holding every kernel launch the wrappers counted;
    raises after two short traces (tools/profile_step.py:device_launches)."""
    from pheniqs_tpu_torch.tools.profile_step import device_launches as counted

    return counted(fn, tries)


def event_ms(fn, reps: int = 10) -> float:
    """CUDA-event milliseconds per call of `fn` over `reps` back-to-back
    calls (tools/profile_step.py:event_ms)."""
    from pheniqs_tpu_torch.tools.profile_step import event_ms as timed

    return timed(fn, reps)


def once_ms(fn):
    """(result, CUDA-event milliseconds) of one call of `fn`: for calls
    that take seconds, where a warm-up call and repeats cost too much."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    return result, start.elapsed_time(end)


def counted_once_ms(counter: str, fn):
    """(result, CUDA-event milliseconds, launches) of one call of `fn`: the
    launches are the change of kernel `counter`'s count
    (kernels.launch_counts) read just before the call and just after."""
    from pheniqs_tpu_torch.kernels import launch_counts

    before = launch_counts()[counter]
    result, ms = once_ms(fn)
    return result, ms, launch_counts()[counter] - before


def counted_event_ms(counter: str, fn, reps: int = 10) -> tuple[float, int]:
    """(event_ms of `fn`, launches of kernel `counter` a call): its count
    read just before the timed calls and just after, over event_ms's reps
    and its one warm-up call."""
    from pheniqs_tpu_torch.kernels import launch_counts

    before = launch_counts()[counter]
    ms = event_ms(fn, reps)
    total = launch_counts()[counter] - before
    if total % (reps + 1):
        raise AssertionError(f"{counter}: {total} launches over {reps + 1} calls")
    return ms, total // (reps + 1)


def counted_device_ms(counter: str, fn, reps: int = 10) -> tuple[float, int]:
    """(device_ms of `fn`, launches of kernel `counter` in one call of it,
    counted just before and just after that call)."""
    from pheniqs_tpu_torch.kernels import launch_counts

    before = launch_counts()[counter]
    fn()
    launches = launch_counts()[counter] - before
    return device_ms(fn, reps), launches


def counted_graph_ms(counter: str, fn, reps: int = 10) -> tuple[float, int]:
    """(ms a call of `fn` by device time alone, launches of kernel
    `counter` a call): the replay of a CUDA graph of `reps` calls, the
    wrappers' counts read at its capture
    (tools/profile_step.py:graph_ms)."""
    from pheniqs_tpu_torch.tools.profile_step import graph_ms

    ms, launched = graph_ms(fn, reps)
    return ms, launched[counter]


def held_launches(label: str, launches: int, expected: int) -> int:
    """`launches`, counted in a run, when the plan's `expected`; else raises."""
    if launches != expected:
        raise AssertionError(f"{label}: {launches} kernel launches a call, the plan's {expected}")
    return launches


def check_flags(what: str, mine, plain, forced, extra_limit: float = FLAG_EXTRA_LIMIT) -> tuple[int, int]:
    """Hold the uncertain flags of a kernel (`mine`) and its plain version
    (`plain`), both (N,) bool, to each other: both must flag every row of
    `forced` (the rows the rules flag whatever the sums), disagree on at
    most FLAG_DISAGREE_LIMIT of the rows and flag at most `extra_limit`
    of the rows beyond `forced`. Returns (rows in disagreement, rows the
    kernel flags beyond `forced`)."""
    n = mine.numel()
    disagree = int((mine != plain).sum())
    if disagree > int(n * FLAG_DISAGREE_LIMIT):
        raise AssertionError(f"{what}: uncertain flags of kernel and plain differ on {disagree} of {n} rows")
    extra = {}
    for name, flags in (("kernel", mine), ("plain", plain)):
        if not bool(flags[forced].all()):
            raise AssertionError(f"{what}: the {name} run leaves rows unflagged that the rules force")
        extra[name] = int((flags & ~forced).sum())
        if extra[name] > n * extra_limit:
            raise AssertionError(f"{what}: the {name} run flags {extra[name]} of {n} rows beyond the forced ones")
    return disagree, extra["kernel"]


def near_tie_rows(what: str, dec, codes, quals, first, second, differs) -> str:
    """The rows `differs` where two runs of one decoder disagree, each
    witnessed in float64 (pamld.tie_gaps): a row whose two best barcodes
    (0-based `first`, `second`) have posteriors within the window lambda *
    2 d_sigma(read) of each other is a near tie, which two f32 orders of
    sigma's terms may break either way (an exact tie where the f64 gap is
    0). Every other differing row (a gap beyond the window, or the same
    best barcode on both sides) counts against WIDE_DISAGREE_LIMIT of the
    rows. Returns the line's report."""
    import torch

    from pheniqs_tpu_torch.kernels import pamld

    n = differs.numel()
    rows = (differs & (first != second) & (first >= 0) & (second >= 0)).nonzero()[:, 0]
    gap, window = pamld.tie_gaps(dec, codes[rows], quals[rows], first[rows], second[rows])
    near = gap <= window
    exact = int((gap == 0).sum())
    beyond = int(differs.sum()) - int(near.sum())
    if beyond > int(n * WIDE_DISAGREE_LIMIT):
        raise AssertionError(f"{what}: {beyond} of {n} rows differ beyond a near tie in f64"
                             f" (at most {int(n * WIDE_DISAGREE_LIMIT)})")
    ratio = float((gap / window)[near].max()) if bool(near.any()) else 0.0
    return (f"{int(differs.sum())} rows differ: {exact} exact ties in f64, {int(near.sum()) - exact} more within"
            f" lambda 2 d_sigma (largest gap {ratio:.3f} of the window), {beyond} beyond"
            f" (at most {int(n * WIDE_DISAGREE_LIMIT)})")


def flagship_blob(ontology, instrument, n: int, seed: int, short: float = 0.0, panels=None):
    """A j4 wire blob of `n` reads of the flagship layout drawn from the
    ontology's panels, packed as the engine packs it (codebook sensed from
    the batch itself), with the last 512 rows as padding; `short` is the
    share of reads whose barcode segments are cut short."""
    import numpy as np

    from pheniqs_tpu_torch.device import wire
    from pheniqs_tpu_torch.device.flagship import synthetic_batch

    batch = synthetic_batch(ontology, n, seed=seed, panels=panels)
    used = [batch["segments"][i] for i in instrument.used_segments]
    if short:
        rng = np.random.default_rng(seed)
        for code, _, length in used:
            cut = rng.random(n) < short
            length[cut] = rng.integers(0, code.shape[1], size=int(cut.sum()))
    code = np.concatenate([c.ravel() for c, _, _ in used])
    qual = np.concatenate([q.ravel() for _, q, _ in used])
    pairs = np.unique((code.astype(np.int64) & 15) << 8 | np.minimum(qual, 63))
    ccb, qcb, lut_idx, lut_exact = wire.sense_joint_codebook(pairs)
    # each segment's wire lane in whole 4-position steps ([8, 8, 28] on the flagship)
    widths = [-(-c.shape[1] // 4) * 4 for c, _, _ in used]
    blob = wire.pack_h2d_blob(widths, used, batch["qcfail"], qual_bits=wire.JOINT4,
                              qual_lut=(lut_idx, lut_exact))
    blob[-512:] = 0
    blob[-512:, -1] = wire.H2D_PAD | wire.H2D_QCFAIL
    return widths, blob, ccb, qcb


def gather_blob(n: int, mode, seed: int = 9):
    """(instrument, layout, program, blob, ccb, qcb) on the card: `n` reads
    of two wire segments (24 + 12) on the `mode` wire for one decoder of
    the general gather (negative starts and ends, reverse complement, two
    tokens into one observation segment)."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from pheniqs_tpu_torch.device import wire
    from pheniqs_tpu_torch.device.instrument import DeviceDecoder, TokenPlan
    from pheniqs_tpu_torch.kernels import unpack

    rng = np.random.default_rng(seed)
    widths = [24, 12]
    segments = []
    for w in widths:
        segments.append((
            rng.choice(np.array([1, 2, 4, 8, 15], np.uint8), size=(n, w)),
            rng.choice(np.array([2, 12, 23, 37], np.uint8), size=(n, w)),
            rng.integers(0, w + 1, size=n).astype(np.int32),
        ))
    qcfail = rng.random(n) < 0.05
    plans = [
        TokenPlan(0, -8, 0, False, False, 0, 8),
        TokenPlan(0, 2, 10, True, True, 0, 8),
        TokenPlan(1, 0, -2, True, False, 1, 6),
        TokenPlan(1, 5, 12, True, False, 1, 7),
        TokenPlan(0, -6, -1, True, True, 2, 5),
    ]
    instrument = SimpleNamespace(decoders=[DeviceDecoder("pamld", "sample", 1, True, plans, [16, 13, 5])])
    cuda = torch.device("cuda")
    ccb = qcb = lut = None
    if mode == wire.JOINT4:
        # 20 distinct pairs: the 4 outside the codebook ride as forced rows
        pairs = np.unique(np.concatenate([(c.astype(np.int64) << 8 | q).ravel() for c, q, _ in segments]))
        ccb, qcb, lut_idx, lut_exact = wire.sense_joint_codebook(pairs[:16])
        lut = (lut_idx, lut_exact)
    elif mode != 6:
        _, qcb, lut_idx, lut_exact = wire.sense_qual_codebook([2, 12, 23, 37], str(mode))
        lut = (lut_idx, lut_exact)
    blob = torch.from_numpy(wire.pack_h2d_blob(widths, segments, qcfail, qual_bits=mode, qual_lut=lut)).to(cuda)
    ccb = None if ccb is None else torch.from_numpy(ccb).to(cuda)
    qcb = None if qcb is None else torch.from_numpy(qcb).to(cuda)
    layout = unpack.token_layout(instrument, widths, mode)
    program = torch.from_numpy(layout.program).to(cuda)
    return instrument, layout, program, blob, ccb, qcb


def program_blob(n: int, count: int, seed: int = 11):
    """gather_blob's shape for a token program past 2048 ints: three
    decoders of `count` token plans in all over two j4 wire segments (24 +
    32; negative starts, reverse complement, several plans into one
    observation segment): (instrument, layout, program, blob, ccb, qcb)."""
    from pheniqs_tpu_torch.device.instrument import DeviceDecoder, TokenPlan

    decoders = []
    for d in range(3):
        plans = [TokenPlan(p % 2, (p % 20) - (6 if p % 7 == 0 else 0), p % 20 + 1 + p % 3, bool(p % 4),
                           p % 5 == 0, p % 6, 1 + p % 3) for p in range(d, count, 3)]
        out = [sum(plan.width for plan in plans if plan.output_segment_index == k) for k in range(6)]
        decoders.append(DeviceDecoder("mdd" if d == 1 else "pamld", "cellular", d, True, plans, out))
    return token_case(decoders, [24, 32], n, seed)


def lengths_blob(n: int, seed: int = 12):
    """A layout whose lengths and short flags K3 writes in place: eight MDD
    decoders of 256 one-position segments (2048 length columns, past what
    32 reads a block stage) over one j4 wire segment of 256 positions, a
    fifth of the tokens reverse complemented: (instrument, layout,
    program, blob, ccb, qcb)."""
    from pheniqs_tpu_torch.device.instrument import DeviceDecoder, TokenPlan

    decoders = []
    for d in range(8):
        plans = [TokenPlan(0, (k + d) % 256, (k + d) % 256 + 1, True, k % 5 == 0, k, 1) for k in range(256)]
        decoders.append(DeviceDecoder("mdd", "cellular", d, True, plans, [1] * 256))
    return token_case(decoders, [256], n, seed)


def token_case(decoders, widths, n: int, seed: int):
    """(instrument, layout, program, blob, ccb, qcb) of `decoders` on `n`
    random reads of j4 wire segments `widths`, each of a random length."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from pheniqs_tpu_torch.device import wire
    from pheniqs_tpu_torch.kernels import unpack

    rng = np.random.default_rng(seed)
    segments = [(rng.choice(np.array([1, 2, 4, 8, 15], np.uint8), size=(n, w)),
                 rng.choice(np.array([2, 23, 37], np.uint8), size=(n, w)),
                 rng.integers(0, w + 1, size=n).astype(np.int32)) for w in widths]
    instrument = SimpleNamespace(decoders=decoders)
    # 15 (code, quality) pairs: the j4 codebook holds them all
    pairs = np.unique(np.concatenate([(c.astype(np.int64) << 8 | q).ravel() for c, q, _ in segments]))
    ccb, qcb, lut_idx, lut_exact = wire.sense_joint_codebook(pairs)
    cuda = torch.device("cuda")
    blob = wire.pack_h2d_blob(widths, segments, rng.random(n) < 0.05, qual_bits=wire.JOINT4,
                              qual_lut=(lut_idx, lut_exact))
    layout = unpack.token_layout(instrument, widths, wire.JOINT4)
    return (instrument, layout, torch.from_numpy(layout.program).to(cuda), torch.from_numpy(blob).to(cuda),
            torch.from_numpy(ccb).to(cuda), torch.from_numpy(qcb).to(cuda))


def forced_plan(layout, row_bytes: int, columns: bool):
    """K3's column plan for `layout`, or its block plan (which must fit a
    block), put in the layout's cache so the wrapper launches it. Returns
    the plan."""
    from pheniqs_tpu_torch.kernels import unpack

    plan = unpack.column_plan(layout, row_bytes) if columns else unpack.block_plan(layout, row_bytes)
    if not columns and plan.shared_bytes > unpack.SHARED_BYTES:
        raise AssertionError(f"K3: no block of 128 reads stages the layout of {layout.program.size} ints")
    layout.block_plans[(row_bytes, layout.program.size)] = plan
    return plan


def plan_name(plan) -> str:
    """A K3 plan in words."""
    from pheniqs_tpu_torch.kernels import unpack

    if isinstance(plan, unpack.BlockPlan):
        return f"block plan (R = {plan.reads}, {plan.shared_bytes} shared bytes)"
    in_place = sum(1 for _, _, staged in plan.chunks if not staged)
    wire = "wire rows staged" if plan.stage_wire else "wire read in place"
    return (f"column plan ({unpack.COLUMN_READS} reads x {len(plan.chunks)} chunks of slots, {in_place} in place,"
            f" {plan.shared_bytes} shared bytes, {wire})")


TOKEN_FIELDS = ("codes", "quals", "lengths", "short", "qcfail", "pad", "forced")


def hold_unpack(label: str, instrument, layout, program, blob, ccb, qcb):
    """K3 launched twice on `blob`, byte-identical, and byte-exact against
    its plain version. Returns the tokens."""
    import torch

    from pheniqs_tpu_torch.kernels import unpack

    mine = unpack.unpack_tokens(instrument, layout, program, blob, ccb, qcb)
    again = unpack.unpack_tokens(instrument, layout, program, blob, ccb, qcb)
    plain = unpack.unpack_tokens_plain(instrument, layout, blob, ccb=ccb, qcb=qcb)
    torch.cuda.synchronize()
    for field in TOKEN_FIELDS:
        a, b, c = getattr(mine, field), getattr(again, field), getattr(plain, field)
        if not torch.equal(a, b):
            raise AssertionError(f"K3 {label}: two launches differ in {field}")
        if not torch.equal(a, c):
            raise AssertionError(f"K3 {label}: {field} differs from the plain version on {int((a != c).sum())} entries")
    return mine


def unaligned(blob, offset: int):
    """A copy of `blob` as a view `offset` bytes into a larger buffer (its
    data_ptr() % 16 == offset when offset < 16)."""
    import torch

    flat = torch.empty(blob.numel() + offset, dtype=blob.dtype, device=blob.device)
    view = flat[offset:].view(blob.shape)
    view.copy_(blob)
    return view


def unpack_checks(n: int):
    """K3 byte-exact against its plain version on the 6-bit, 2-bit and
    4-bit wires too, and on the general gather (negative starts and ends,
    reverse complement, two tokens into one observation segment)."""
    from pheniqs_tpu_torch.device import wire

    for mode in (6, 2, 4, wire.JOINT4):
        hold_unpack(f"{mode}-wire general gather", *gather_blob(n, mode))
    say(f"[kernels] K3 byte-exact on the 6/2/4/j4 wires with the general gather (N={n}), two launches identical")


def unpack_edge_checks() -> int:
    """K3 on the ragged and unaligned cases, byte-exact against its plain
    version and across two launches, under the block plan and forced to
    the column plan (forced_plan): N = 0, 1, R - 1, R + 1 and 16384 + 7
    reads (R the reads a block plan's block owns) on the 6-bit and j4
    wires with the general gather, each also as a view 3 bytes into a
    larger buffer; token programs past 2048 ints (program_blob: ~3,000
    ints, which a block of 128 reads stages whole, under both plans;
    ~10,000, which it does not, under the column plan); and 2048
    length columns (lengths_blob), under the column plan, aligned and 3
    bytes off. Returns the cases held."""
    from pheniqs_tpu_torch.device import wire
    from pheniqs_tpu_torch.kernels import unpack

    held = 0
    reads = unpack.MAX_BLOCK_READS
    for columns in (False, True):
        instrument, layout, program, blob, ccb, qcb = gather_blob(16384 + 7, wire.JOINT4)
        if not isinstance(unpack.unpack_plan(layout, blob.shape[1]), unpack.BlockPlan):
            raise AssertionError("K3: the general gather's layout left the block plan")
        forced_plan(layout, blob.shape[1], columns)
        empty = unpack.unpack_tokens(instrument, layout, program, blob[:0], ccb, qcb)
        if empty.codes.shape != (0, layout.token_cols) or empty.lengths.shape != (0, layout.length_cols):
            raise AssertionError("K3 N=0: outputs of the wrong shape")
        held += 1
        for mode in (6, wire.JOINT4):
            instrument, layout, program, blob, ccb, qcb = gather_blob(16384 + 7, mode, seed=10)
            plan = forced_plan(layout, blob.shape[1], columns)
            for n in (1, reads - 1, reads + 1, 16384 + 7):
                for offset in (0, 3):
                    rows = blob[:n].contiguous() if offset == 0 else unaligned(blob[:n], offset)
                    if rows.data_ptr() % 16 != offset:
                        raise AssertionError(f"K3 edge case: the view is {rows.data_ptr() % 16} bytes off, not {offset}")
                    hold_unpack(f"{mode}-wire N={n} at offset {offset}, {plan_name(plan)}", instrument, layout,
                                program, rows, ccb, qcb)
                    held += 1
    programs = []
    for count in WIDE_PROGRAM_PLANS:
        instrument, layout, program, blob, ccb, qcb = program_blob(16384 + 7, count)
        planned = unpack.unpack_plan(layout, blob.shape[1])
        fits = unpack.block_plan(layout, blob.shape[1]).shared_bytes <= unpack.SHARED_BYTES
        for columns in (False, True) if fits else (True,):
            plan = forced_plan(layout, blob.shape[1], columns)
            for rows in (blob, unaligned(blob, 3)):
                hold_unpack(f"program of {program.numel()} ints, {plan_name(plan)}", instrument, layout, program,
                            rows, ccb, qcb)
                held += 1
        programs.append(f"{program.numel()} ints (planned: {plan_name(planned)})")
    instrument, layout, program, blob, ccb, qcb = lengths_blob(16384 + 7)
    if not isinstance(unpack.unpack_plan(layout, blob.shape[1]), unpack.ColumnPlan):
        raise AssertionError(f"K3: {layout.length_cols} length columns not on the column plan")
    for rows in (blob, unaligned(blob, 3)):
        hold_unpack(f"{layout.length_cols} length columns, column plan", instrument, layout, program, rows, ccb, qcb)
        held += 1
    say(f"[kernels] K3 byte-exact and two launches identical on {held} edge cases: N = 0, 1, {reads - 1},"
        f" {reads + 1}, 16391 on the 6-bit and j4 wires, aligned and 3 bytes off, under the block plan and the"
        f" column plan; programs of {', '.join(programs)}, under each plan that stages them, and"
        f" {layout.length_cols} length columns under the column plan, 16391 reads aligned and 3 bytes off")
    return held


#: K5's edge layouts: (label, decoders as (algorithm, barcodes), hybrid)
PACK_LAYOUTS = (
    ("flagship (naive between two PAMLD), 14 B", (("pamld", 96), ("naive", 0), ("pamld", 384)), True),
    ("flagship fast, 13 B", (("pamld", 96), ("naive", 0), ("pamld", 384)), False),
    ("MDD flagship, 10 B", (("mdd", 96), ("naive", 0), ("pamld", 384)), True),
    ("whitelist fast, 17 B int32", (("pamld", 96), ("naive", 0), ("pamld", 737_280)), False),
    ("whitelist hybrid, 18 B int32", (("pamld", 96), ("naive", 0), ("pamld", 737_280)), True),
    ("naive last, 14 B", (("pamld", 96), ("pamld", 384), ("naive", 0)), True),
    ("9 decoders, 2 qcfail bytes", (("pamld", 1000), ("mdd", 40)) * 4 + (("naive", 0),), True),
    ("32 wide PAMLD decoders, 261 B", (("pamld", 40_000),) * 32, True),
    ("33 decoders, two mask words, 94 B", ((("pamld", 96), ("mdd", 40), ("naive", 0)) * 11), True),
    ("64 decoders, 183 B", ((("pamld", 96), ("mdd", 40), ("naive", 0)) * 22)[:64], True),
)
#: the read counts each K5 layout is held at
PACK_READS = (0, 1, 15, 17, 255, 257, N_KERNEL - 1)


def pack_bytes(plan, decoders: int, n: int, want_uncertain: bool) -> int:
    """The bytes K5 moves for `n` reads under `plan` (pack.pack_plan): the
    rows it loads (a decoded index and a confidence for each decoder of
    their masks, every qcfail row, in hybrid mode the uncertain rows of its
    mask and the forced row) and the blob it writes."""
    loaded = 4 * (bin(plan.decoded_mask).count("1") + bin(plan.confidence_mask).count("1")) + decoders
    if want_uncertain:
        loaded += bin(plan.uncertain_mask).count("1") + 1
    return n * (loaded + plan.layout["total"])


def pack_case(decoders, n: int, seed: int, device):
    """A stand-in instrument of `decoders` ((algorithm, barcodes) each)
    and random decision rows of `n` reads on `device`, made from `seed`:
    decoded indices up to each panel's size, confidences of any 32 bits
    (NaNs and infinities included), qcfail, uncertain and forced rows a
    coin each. Returns (instrument, Decisions, forced)."""
    import types

    import numpy as np
    import torch

    from pheniqs_tpu_torch.kernels import Decisions

    instrument = types.SimpleNamespace(
        decoders=[types.SimpleNamespace(algorithm=a, barcode_count=b) for a, b in decoders], pack_plans={})
    rng = np.random.default_rng(seed)
    d = len(decoders)
    decisions = Decisions.zeros(d, n, device)
    limits = np.array([[max(b, 1)] for _, b in decoders])
    decisions.decoded.copy_(torch.from_numpy(rng.integers(0, limits + 1, size=(d, n)).astype(np.int32)))
    decisions.confidence.copy_(torch.from_numpy(rng.integers(0, 2**32, size=(d, n), dtype=np.uint64)
                                                .astype(np.uint32).view(np.float32)))
    decisions.qcfail.copy_(torch.from_numpy(rng.random((d, n)) < 0.5))
    decisions.uncertain.copy_(torch.from_numpy(rng.random((d, n)) < 0.1))
    forced = torch.from_numpy(rng.random(n) < 0.1).to(device)
    return instrument, decisions, forced


def hold_pack(label: str, instrument, decisions, forced, want_uncertain: bool):
    """K5 launched twice, byte-identical, and byte-exact against its plain
    version (empty at N = 0); a third launch, uncounted, into a buffer with
    64 guard bytes after the span leaves them alone."""
    import torch

    from pheniqs_tpu_torch.kernels import build, pack

    device = decisions.decoded.device
    stream = torch.cuda.current_stream(device).cuda_stream
    total = pack.pack_plan(instrument, want_uncertain).layout["total"]
    n = decisions.decoded.shape[1]
    mine, again = (pack.pack_outputs(instrument, decisions, forced, want_uncertain) for _ in range(2))
    guarded = torch.full((n * total + 64,), 0xAB, dtype=torch.uint8, device=device)
    pack._launch(build.library(), instrument, decisions, forced, want_uncertain, guarded[: n * total], stream)
    # the plain version's reshapes need a read: at N = 0 the blob is empty
    plain = (pack.pack_outputs_plain(instrument, decisions, forced, want_uncertain) if n
             else torch.empty(0, dtype=torch.uint8, device=device))
    if not torch.equal(mine, again):
        raise AssertionError(f"K5 {label}: two launches differ")
    if not torch.equal(mine, plain):
        raise AssertionError(f"K5 {label}: differs from the plain version on {int((mine != plain).sum())} bytes")
    if not torch.equal(guarded[: n * total], plain) or not bool((guarded[n * total:] == 0xAB).all()):
        raise AssertionError(f"K5 {label}: a launch wrote outside its span")


def pack_edge_checks() -> int:
    """K5 on its edge cases (hold_pack), byte-exact against its plain
    version and across two launches: each PACK_LAYOUTS layout (totals 10,
    13, 14, 17, 18, 57 and 261 bytes: int16 and int32 indices, with and
    without the uncertain byte, a naive decoder between two PAMLD ones and
    after them, 9 and 32 decoders; the last the widest layout the plan
    allows) at every PACK_READS read count. Returns the cases held."""
    import torch

    from pheniqs_tpu_torch.kernels import pack

    held = 0
    plans = []
    for seed, (label, decoders, hybrid) in enumerate(PACK_LAYOUTS):
        for n in PACK_READS:
            instrument, decisions, forced = pack_case(decoders, n, seed, torch.device("cuda"))
            hold_pack(f"{label} N={n}", instrument, decisions, forced, hybrid)
            held += 1
        plan = pack.pack_plan(instrument, hybrid)
        plans.append(f"{label}: R={plan.reads}")
    say(f"[kernels] K5 byte-exact, two launches identical and nothing written past the span on {held} edge cases:"
        f" N = {', '.join(map(str, PACK_READS))} on each layout ({'; '.join(plans)})")
    return held


def mdd_synthetic(widths, barcodes: int, n: int, tolerance: int, qmt: int, short: float, seed: int,
                  error_rate: float = 0.08):
    """A synthetic MDD decoder on the card (random A/C/G/T panel of
    `barcodes` x sum(widths), its last barcode a copy of its second) and
    `n` reads drawn from it with `error_rate` substitutions (N among them),
    some segments (`short` of them) cut short, their rows one byte into
    wider buffers (unaligned views, as the unpack outputs' slots are):
    (dec, codes, quals, lengths, qcfail)."""
    import numpy as np
    import torch

    from pheniqs_tpu_torch.device.instrument import DeviceDecoder
    from pheniqs_tpu_torch.kernels import mdd

    rng = np.random.default_rng(seed)
    w = sum(widths)
    panel = rng.choice(np.array([1, 2, 4, 8], np.uint8), size=(barcodes, w))
    panel[-1] = panel[1]
    reads = panel[rng.integers(barcodes, size=n)]
    errors = rng.random((n, w)) < error_rate
    reads[errors] = rng.choice(np.array([1, 2, 4, 8, 15], np.uint8), size=int(errors.sum()))
    quals = rng.integers(2, 41, size=(n, w)).astype(np.uint8)
    lengths = np.tile(np.array(widths, np.int32), (n, 1))
    cut = rng.random(lengths.shape) < short
    lengths[cut] = rng.integers(0, np.broadcast_to(np.array(widths), lengths.shape)[cut] + 1)
    starts = np.concatenate([[0], np.cumsum(widths)[:-1]])
    for s, (start, width) in enumerate(zip(starts, widths)):
        beyond = np.arange(width)[None, :] >= lengths[:, s : s + 1]
        reads[:, start : start + width][beyond] = 0
        quals[:, start : start + width][beyond] = 0
    cuda = torch.device("cuda")
    dec = DeviceDecoder("mdd", "sample", 0, True, [], list(widths), barcode_count=barcodes, width=w,
                        panel_codes=torch.from_numpy(panel.astype(np.int32)).to(cuda),
                        panel_codes_u8=torch.from_numpy(panel).to(cuda), quality_masking_threshold=qmt,
                        distance_tolerance=tuple([tolerance] * len(widths)))
    dec.key_table = mdd.key_table_tensor(dec.panel_codes_u8)
    rows = []
    for x in (reads, quals):
        wide = torch.zeros((n, w + 3), dtype=torch.uint8, device=cuda)
        wide[:, 1 : 1 + w] = torch.from_numpy(x).to(cuda)
        rows.append(wide[:, 1 : 1 + w])
    qcfail = torch.from_numpy(rng.random(n) < 0.05).to(cuda)
    return dec, rows[0], rows[1], torch.from_numpy(lengths).to(cuda), qcfail


def mdd_edge_checks(n: int = N_KERNEL) -> int:
    """K6 byte-exact against its plain version and across two launches
    (classify_pair) where its design branches: the MDD flagship's panel
    with one barcode copied twice (reads equal to it decode to its lowest
    index), synthetic panels of 5, 24 and 64 positions (the 4-, 8- and
    16-word instances; 1 to 2 segments) and of 2000 barcodes (a key table
    too large for shared memory, read from L2), and the wide ones (WIDE_MDD:
    9 and 12 segments of 50-130 positions, the wide instance), at
    tolerance 1 and at tolerance 2 with quality masking and
    20 % short segments, on unaligned rows of 16384 + 7 reads; and a wide
    panel holding codes of 16 and more (mdd_eight_planes). Returns the
    cases held."""
    import dataclasses

    import torch

    from pheniqs_tpu_torch.device import wire
    from pheniqs_tpu_torch.device.flagship import mdd_flagship_ontology
    from pheniqs_tpu_torch.device.instrument import compile_instrument
    from pheniqs_tpu_torch.device.step import DecodeStep
    from pheniqs_tpu_torch.kernels import mdd, pamld, unpack

    cuda = torch.device("cuda")
    ontology = mdd_flagship_ontology()
    instrument = compile_instrument(ontology, cuda)
    widths, *arrays = flagship_blob(ontology, instrument, n, seed=98)
    step = DecodeStep(instrument, widths, wire.JOINT4, want_uncertain=True)
    tokens = unpack.unpack_tokens(instrument, step.layout, step.program,
                                  *(torch.from_numpy(x).to(cuda) for x in arrays))
    codes, quals, lengths, short = tokens.observation(step.layout, 0)
    dec = instrument.decoders[0]
    panel = dec.panel_codes_u8.clone()
    panel[40] = panel[5]
    panel[90] = panel[5]
    duplicated = dataclasses.replace(dec, panel_codes=panel.to(torch.int32), panel_codes_u8=panel,
                                     key_table=mdd.key_table_tensor(panel))
    pair = classify_pair(duplicated, instrument, codes, quals, lengths, tokens.qcfail, short,
                         pamld.empty_result(n, cuda))
    decoded = pair["plain"]["decoded"]
    if bool(((decoded == 41) | (decoded == 91)).any()) or not bool((decoded == 6).any()):
        raise AssertionError("K6 duplicated barcode: a read decoded to a later copy")
    say(f"[kernels] mdd flagship, barcode 6 copied to 41 and 91, N={n}: {pair['line']}")
    held = 1
    cases = (([5], 40), ([12, 12], 300), ([30, 34], 70), ([8, 8], 2000))
    for widths, barcodes in cases + WIDE_MDD:
        # the wide cases (past 8 segments or 64 positions) at 0.5 errors a
        # read and a quality masking threshold of 5: at 8 % and 20 the
        # tolerance would leave nothing to decode
        wide = (widths, barcodes) in WIDE_MDD
        for tolerance, qmt, cut in ((1, 0, 0.0), (2, 5 if wide else 20, 0.2)):
            dec, codes, quals, lengths, qcfail = mdd_synthetic(
                widths, barcodes, 16384 + 7, tolerance, qmt, cut, seed=barcodes + tolerance,
                error_rate=0.5 / sum(widths) if wide else 0.08)
            short = torch.zeros(codes.shape[0], dtype=torch.bool, device=cuda)
            pair = classify_pair(dec, instrument, codes, quals, lengths, qcfail, short,
                                 pamld.empty_result(codes.shape[0], cuda))
            say(f"[kernels] K6 S={len(widths)} W={widths} B={barcodes} tolerance {tolerance} qmt {qmt} short {cut:.0%}"
                f" N={codes.shape[0]}, unaligned rows: {pair['line']}")
            held += 1
    dec, codes, quals, lengths, qcfail = mdd_eight_planes(16384 + 7)
    short = torch.zeros(codes.shape[0], dtype=torch.bool, device=cuda)
    pair = classify_pair(dec, instrument, codes, quals, lengths, qcfail, short, pamld.empty_result(codes.shape[0], cuda))
    say(f"[kernels] K6 S=12 W=130 B=40, a panel with codes of 16 and 31 ({mdd.decoder_planes(dec)} planes),"
        f" N={codes.shape[0]}: {pair['line']}")
    return held + 1


def mdd_eight_planes(n: int):
    """WIDE_MDD's last shape (12 segments, 130 positions, 40 barcodes) with
    codes of 16 and 31 in three barcodes and in a fifth of the reads drawn
    from them (outside the wire's 4-bit codes: the wide instance's 8-plane
    panel), tolerance 2, qmt 5, 20 % short: (dec, codes, quals, lengths,
    qcfail)."""
    import dataclasses

    import torch

    from pheniqs_tpu_torch.kernels import mdd

    widths, barcodes = WIDE_MDD[-1]
    dec, codes, quals, lengths, qcfail = mdd_synthetic(widths, barcodes, n, 2, 5, 0.2, seed=31,
                                                       error_rate=0.5 / sum(widths))
    panel = dec.panel_codes_u8.clone()
    panel[3, 5] = 16
    panel[7, 40:60] = 31
    panel[9] = 16
    dec = dataclasses.replace(dec, panel_codes=panel.to(torch.int32), panel_codes_u8=panel,
                              key_table=mdd.key_table_tensor(panel))
    gen = torch.Generator(device=codes.device).manual_seed(31)
    rows = torch.randperm(n, device=codes.device, generator=gen)[: n // 5]
    codes = codes.clone()
    codes[rows] = torch.where(codes[rows] == 0, 0, panel[torch.tensor([3, 7, 9], device=codes.device)[rows % 3]])
    codes[: n // 50, 3] = 31
    return dec, codes, quals.contiguous(), lengths, qcfail


def sliced_vs_one_launch(dec, instrument, codes, quals, qcfail, short) -> str:
    """The sliced K1 against its one-launch instance on the same batch
    (pamld.against_one_launch): argmax, decoded and distance bit-equal on
    every row, confidences within 2*gamma(B+2) + 8u, and branch, qcfail and
    uncertain apart only on rows whose confidences straddle ct or an edge
    of its uncertain margin (within pamld.EDGE_ULPS ulps); those rows are
    counted. Returns the report."""
    from pheniqs_tpu_torch.kernels import pamld

    name = f"K1 B={dec.barcode_count}"
    n = codes.shape[0]
    held = pamld.against_one_launch(dec, codes, quals, qcfail, short, instrument.tpq_constants,
                                    instrument.tpq_analytic_eps)
    plan = held["plan"]
    if plan.slices == 1:
        raise AssertionError(f"{name} N={n}: the sliced plan keeps one slice ({plan})")
    for key, rows in held["unequal"].items():
        if rows:
            raise AssertionError(f"{name}: sliced and one-launch {key} differ on {rows} rows")
    if held["relative"] > held["tolerance"]:
        raise AssertionError(f"{name}: sliced and one-launch confidences {held['relative']:.3e} apart"
                             f" (at most {held['tolerance']:.3e})")
    if held["unexplained"]:
        raise AssertionError(f"{name}: sliced and one-launch branch/qcfail/uncertain differ on"
                             f" {held['unexplained']} rows whose confidences are not within {pamld.EDGE_ULPS}"
                             " ulps of ct or its margin")
    return (f"sliced ({plan.slices} slices of {plan.cut}-barcode cuts, 3 launches) vs one launch: argmax, decoded"
            f" and distance bit-equal on {n} rows; confidence differs on {held['moved']} rows, max relative"
            f" {held['relative']:.3e} (at most {held['tolerance']:.3e}, {held['relative'] / pamld.U32:.1f} u);"
            f" branch/qcfail/uncertain differ on {held['differs']} rows, each within {pamld.EDGE_ULPS} ulps of"
            f" ct or its margin ({held['at_edge']} rows of moved confidence sit there)")


def mdd_exact_rows(dec, lengths, plain: dict):
    """The reads K6 resolves by its key table: every segment at full
    length and an exact match (for such a read no mismatch is the only
    way to distance 0: positions masked for quality are errors only on a
    scan, and the exact test ignores them)."""
    import torch

    widths = torch.tensor(list(dec.segment_widths), dtype=torch.int32, device=lengths.device)
    full = (lengths == widths).all(dim=1)
    return full & (plain["decoded"] > 0) & (plain["distance"] == 0)


def mdd_split(exact) -> dict:
    """K6's split of the work: the share of reads the key table resolves,
    and the reads each warp of 32 consecutive reads scans the panel for."""
    import torch

    misses = torch.nn.functional.pad((~exact).to(torch.float32), (0, -exact.numel() % 32))
    per_warp = misses.view(-1, 32).sum(dim=1)
    return {"exact_share": float(exact.float().mean()), "scanned_a_warp": float(per_warp.mean()),
            "warps_without_scan": float((per_warp == 0).float().mean())}


def classify_pair(dec, instrument, codes, quals, lengths, qcfail, short, out, bounded=True) -> dict:
    """One decoder's classify kernel (K1, K7 or K6) against its plain
    version on the same tokens, each called once (CUDA-event times `ms`
    and `plain_ms`). PAMLD: launched twice, byte-identical; the uncertain
    flags held to the plain version's (check_flags); when `bounded`,
    integers exact and confidences rtol 1e-5 on rows neither run flags;
    else (a panel where the bound flags nearly every row) on every row:
    decisions differing from the plain version's only on near ties in f64
    but for at most WIDE_DISAGREE_LIMIT of the rows (near_tie_rows), equal
    on the rows neither flags, confidences rtol WIDE_CONFIDENCE_RTOL where
    the decisions agree and the row is not `short`; and the same rules
    against the tile loop's own arithmetic (pamld_classify_tile_order),
    decisions differing on at most WIDE_DISAGREE_LIMIT of the rows. MDD:
    every output byte-identical.
    Returns {max_abs_err (confidence), ms, plain_ms, plain, differs_plain
    (rows whose decisions differ from the plain version's), line}. K1's
    sliced launches are also held to its one-launch instance on the same
    tokens (sliced_vs_one_launch), whichever of the two the card's plan
    takes."""
    import torch

    from pheniqs_tpu_torch.kernels import mdd, pamld

    n = codes.shape[0]
    if dec.algorithm == "mdd":
        mine, ms, launches = counted_once_ms("mdd_classify",
                                             lambda: mdd.mdd_classify(dec, codes, quals, lengths, qcfail, out=out))
        again = mdd.mdd_classify(dec, codes, quals, lengths, qcfail)
        plain, plain_ms = once_ms(lambda: mdd.mdd_classify_plain(dec, codes, quals, lengths, qcfail))
        for key in ("decoded", "argmax", "distance", "branch", "confidence", "qcfail"):
            if not torch.equal(mine[key], again[key]):
                raise AssertionError(f"K6: two launches differ in {key} on {int((mine[key] != again[key]).sum())} rows")
            if not torch.equal(mine[key], plain[key]):
                raise AssertionError(f"K6 {key} differs on {int((mine[key] != plain[key]).sum())} rows")
        plain["exact"] = mdd_exact_rows(dec, lengths, plain)
        split = mdd_split(plain["exact"])
        return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "plain": plain, "launches": launches,
                "differs_plain": torch.zeros(n, dtype=torch.bool, device=codes.device), "line": (
            f"two launches byte-identical, byte-identical to plain; decoded"
            f" {float((plain['decoded'] > 0).float().mean()):.4%}, within tolerance"
            f" {float((plain['distance'] > 0).float().mean()):.4%}; exact by lookup {split['exact_share']:.4%},"
            f" scanned {split['scanned_a_warp']:.2f} reads a warp (warps without a scan"
            f" {split['warps_without_scan']:.2%})"
        )}
    name = f"K{7 if dec.barcode_count > pamld.LARGE_PANEL_B else 1} B={dec.barcode_count}"
    kwargs = dict(want_uncertain=True, eps=instrument.tpq_analytic_eps, short=short)
    mine, ms = once_ms(lambda: pamld.pamld_classify(
        dec, codes, quals, qcfail, tpq_constants=instrument.tpq_constants, out=out, **kwargs))
    again = pamld.pamld_classify(dec, codes, quals, qcfail, tpq_constants=instrument.tpq_constants, **kwargs)
    for key in mine:
        if not torch.equal(mine[key], again[key]):
            raise AssertionError(f"{name}: two launches differ in {key} on {int((mine[key] != again[key]).sum())} rows")
    one_launch = ""
    if dec.barcode_count <= pamld.LARGE_PANEL_B:
        one_launch = "; " + sliced_vs_one_launch(dec, instrument, codes, quals, qcfail, short)
    plain, plain_ms = once_ms(lambda: pamld.pamld_classify_plain(dec, codes, quals, qcfail, **kwargs))
    disagree, extra = check_flags(name, mine["uncertain"], plain["uncertain"], short,
                                  FLAG_EXTRA_LIMIT if bounded else 1.0)
    keys = ("decoded", "argmax", "distance", "branch", "qcfail")
    differs_plain = torch.zeros_like(mine["uncertain"])
    for key in keys:
        differs_plain |= mine[key] != plain[key]
    note = ""
    if bounded:
        held = ~(mine["uncertain"] | plain["uncertain"])
        rtol = 1e-5
    else:
        # the plain version's contraction adds sigma's terms in another
        # order than the tile loop, so two barcodes tied within the sums'
        # rounding may rank apart: every row whose decisions differ is a
        # near tie in f64, but for at most WIDE_DISAGREE_LIMIT of the rows
        ties = near_tie_rows(f"{name} vs plain", dec, codes, quals, mine["argmax"].long() - 1,
                             plain["argmax"].long() - 1, differs_plain)
        settled = ~(mine["uncertain"] | plain["uncertain"])
        for key in keys:
            if not torch.equal(mine[key][settled], plain[key][settled]):
                raise AssertionError(f"{name} {key} differs from the plain version on settled rows")
        # and every row to the tile loop's own arithmetic in torch
        twin = pamld.pamld_classify_tile_order(dec, codes, quals, qcfail, **kwargs)
        differs = torch.zeros_like(mine["uncertain"])
        for key in keys:
            differs |= mine[key] != twin[key]
        if int(differs.sum()) > int(n * WIDE_DISAGREE_LIMIT):
            raise AssertionError(f"{name}: decisions differ from the tile-order version on {int(differs.sum())} of {n} rows")
        same = ~differs & ~short
        a, b = mine["confidence"][same], twin["confidence"][same]
        if not torch.allclose(a, b, rtol=WIDE_CONFIDENCE_RTOL, atol=0.0):
            raise AssertionError(f"{name} confidence beyond rtol {WIDE_CONFIDENCE_RTOL} of the tile-order version's")
        twin_rel = float(((a - b).abs() / b.abs().clamp(min=1e-30)).max()) if a.numel() else 0.0
        # confidences where the rules force nothing: a short or padding row
        # sits at about the same sigma from every barcode, and a sum of
        # 737,280 near-equal terms rounds differently in two orders
        held = ~differs_plain & ~short
        rtol = WIDE_CONFIDENCE_RTOL
        note = (f"; against the plain version {ties}, settled rows {float(settled.float().mean()):.4%};"
                f" against the tile-order version decisions differ on {int(differs.sum())} rows, confidence"
                f" max relative {twin_rel:.3e}")
    for key in keys:
        a, b = mine[key][held], plain[key][held]
        if not torch.equal(a, b):
            raise AssertionError(f"{name} {key} differs on {int((a != b).sum())} settled rows")
    a, b = mine["confidence"][held], plain["confidence"][held]
    if not torch.allclose(a, b, rtol=rtol, atol=0.0):
        raise AssertionError(f"{name} confidence beyond rtol {rtol}")
    err = float((a - b).abs().max()) if a.numel() else 0.0
    relative = float(((a - b).abs() / b.abs().clamp(min=1e-30)).max()) if a.numel() else 0.0
    rows = "settled rows" if bounded else "unforced rows with the same decisions"
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "plain": plain, "differs_plain": differs_plain,
            "line": (
                f"two launches byte-identical; {rows} {float(held.float().mean()):.4%}, flagged"
                f" {float(mine['uncertain'].float().mean()):.4%} (short {float(short.float().mean()):.4%},"
                f" beyond short {extra} rows), flag disagreement {disagree} of {n} rows,"
                f" confidence max |diff| {err:.3e} (relative {relative:.3e}) on those rows{note}{one_launch}"
            )}


def step_checks(label: str, ontology, n: int, seed: int, timed: bool, short: float = 0.0, panels=None,
                instrument=None, bounded: bool = True, time_k4: bool = False) -> dict:
    """Every kernel of one instrument's decode step against its plain
    version on a j4 batch of `n` reads: K3 byte-exact, each decoder's
    classify kernel (classify_pair; unbounded past LARGE_PANEL_B barcodes
    unless `bounded`), K4 twice byte-identical and equal to the plain
    version byte for byte on every column (k4_hold), K5 byte-exact, and
    the whole step: the uncertain byte held to the plain version's, the
    same decision bytes off the margins (when not `bounded`, on every row
    but the classify kernels' own differences from their plain versions
    and at most WIDE_DISAGREE_LIMIT more). Returns K1's and K7's
    one-call times and, with `timed`, each kernel's and the step's device
    times (K4's alone with `time_k4`)."""
    import torch

    from pheniqs_tpu_torch.device import wire
    from pheniqs_tpu_torch.device.instrument import LARGE_PANEL_B, compile_instrument
    from pheniqs_tpu_torch.device.step import DecodeStep
    from pheniqs_tpu_torch.kernels import Decisions, mdd, pack, pamld, unpack

    cuda = torch.device("cuda")
    if instrument is None:
        instrument = compile_instrument(ontology, cuda)
    widths, blob_np, ccb_np, qcb_np = flagship_blob(ontology, instrument, n, seed, short, panels)
    blob, ccb, qcb = (torch.from_numpy(x).to(cuda) for x in (blob_np, ccb_np, qcb_np))
    step = DecodeStep(instrument, widths, wire.JOINT4, want_uncertain=True)
    layout = step.layout
    results = {}

    tokens = hold_unpack(label, instrument, layout, step.program, blob, ccb, qcb)
    hold_unpack(f"{label} 5 bytes off alignment", instrument, layout, step.program, unaligned(blob, 5), ccb, qcb)
    plan = unpack.unpack_plan(layout, blob.shape[1], step.program.numel())
    if not isinstance(plan, unpack.BlockPlan):
        raise AssertionError(f"{label} K3: the layout left the block plan ({plan})")
    say(f"[kernels] {label} K3 N={n}: byte-exact, two launches identical, also on a view 5 bytes off alignment;"
        f" the block plan, R = {plan.reads} reads a block, {plan.shared_bytes} shared bytes a block, everything"
        " staged")
    if timed:
        results["unpack_tokens"] = {
            "max_abs_err": 0.0,
            "bytes": nbytes(blob, ccb, qcb, *(getattr(tokens, f) for f in TOKEN_FIELDS)),
            "library_ms": None,
            "ms": device_ms(lambda: unpack.unpack_tokens(instrument, layout, step.program, blob, ccb, qcb)),
            "plain_ms": device_ms(lambda: unpack.unpack_tokens_plain(instrument, layout, blob, ccb=ccb, qcb=qcb)),
            "extra": {"reads_a_block": plan.reads, "shared_bytes_a_block": plan.shared_bytes,
                      "ptxas": ptxas_report("phq_unpack_kernel")},
        }

    kernel_rows = Decisions.zeros(len(instrument.decoders), n, cuda)
    qcfail = tokens.qcfail
    must_flag = tokens.forced.clone()
    classify_differs = torch.zeros(n, dtype=torch.bool, device=cuda)
    slot = 0
    for k, dec in enumerate(instrument.decoders):
        row = kernel_rows.row(k)
        if dec.algorithm not in ("pamld", "mdd"):
            row["qcfail"].copy_(qcfail)
            qcfail = row["qcfail"]
            continue
        codes, quals, lengths, short_rows = tokens.observation(layout, slot)
        slot += 1
        if dec.algorithm == "pamld":
            must_flag |= short_rows
        large = dec.barcode_count > LARGE_PANEL_B
        pair = classify_pair(dec, instrument, codes, quals, lengths, qcfail, short_rows, row,
                             bounded=bounded or not large)
        say(f"[kernels] {label} {dec.algorithm} B={dec.barcode_count} W={codes.shape[1]} N={n}: {pair['line']}")
        classify_differs |= pair["differs_plain"]
        name = "mdd_classify" if dec.algorithm == "mdd" else "pamld_chunked" if large else "pamld_classify"
        ms, plain_ms = pair["ms"], pair["plain_ms"]
        if timed:
            if dec.algorithm == "mdd":
                out = pamld.empty_result(n, cuda)
                ms = device_ms(lambda: mdd.mdd_classify(dec, codes, quals, lengths, qcfail, out=out))
                plain_ms = device_ms(lambda: mdd.mdd_classify_plain(dec, codes, quals, lengths, qcfail), reps=3)
            else:
                kwargs = dict(want_uncertain=True, eps=instrument.tpq_analytic_eps, short=short_rows)
                ms = device_ms(lambda: pamld.pamld_classify(
                    dec, codes, quals, qcfail, tpq_constants=instrument.tpq_constants, **kwargs))
                plain_ms = device_ms(lambda: pamld.pamld_classify_plain(dec, codes, quals, qcfail, **kwargs), reps=3)
        if timed or large:
            entry = results.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "parts": [],
                                              "bytes": 0, "ops": 0, "library_ms": None})
            moved, operations = classify_work(dec, n, codes.shape[1], pair["plain"])
            entry["bytes"] += moved
            entry["ops"] += operations
            entry["max_abs_err"] = max(entry["max_abs_err"], pair["max_abs_err"])
            entry["ms"] += ms
            entry["plain_ms"] += plain_ms
            entry["parts"].append((dec.barcode_count, ms, plain_ms))
            if dec.algorithm == "mdd":
                entry["extra"] = dict(mdd_split(pair["plain"]["exact"]), ptxas=ptxas_report("phq_mdd_kernel"))
            clock = "device time" if timed else "one call each, CUDA events"
            say(f"[kernels] {label} {dec.algorithm} B={dec.barcode_count}: kernel {ms:.4f} ms,"
                f" plain {plain_ms:.4f} ms ({clock})")
        qcfail = row["qcfail"]

    first = k4_hold(label, instrument, kernel_rows, tokens.pad, tokens.forced)
    say(f"[kernels] {label}: K4 two launches byte-identical ({first.numel()} counters), K4 = plain byte for byte")
    if timed or time_k4:
        results["counters"] = k4_measure(instrument, kernel_rows, tokens.pad, tokens.forced)
        k4 = results["counters"]
        say(f"[kernels] {label} K4 N={n}, {first.numel()} counters: kernel {k4['ms']:.4f} ms, plain"
            f" {k4['plain_ms']:.4f} ms, index_add_ yardstick {k4['library_ms']:.4f} ms (device time);"
            f" peak allocation of one call {k4['peak_bytes']} B")

    hold_pack(label, instrument, kernel_rows, tokens.forced, True)
    plan = pack.pack_plan(instrument, True)
    say(f"[kernels] {label} K5 N={n}: byte-exact, two launches identical; {plan.layout['total']} bytes a read,"
        f" R = {plan.reads} reads a block, {plan.shared_bytes} shared bytes")
    if timed:
        results["pack_outputs"] = {
            "max_abs_err": 0.0,
            "ms": device_ms(lambda: pack.pack_outputs(instrument, kernel_rows, tokens.forced, True)),
            "plain_ms": device_ms(lambda: pack.pack_outputs_plain(instrument, kernel_rows, tokens.forced, True)),
            "bytes": pack_bytes(plan, len(instrument.decoders), n, True),
            "library_ms": None,
            "extra": {"reads_a_block": plan.reads, "ptxas": ptxas_report("phq_pack_kernel")},
        }

    out, flat = step(blob, ccb, qcb)
    plain_out, plain_flat = step.forward_plain(blob, ccb, qcb)
    d2h = wire.d2h_layout(instrument, True)
    a = out.view(-1, d2h["total"]).cpu().numpy()
    b = plain_out.view(-1, d2h["total"]).cpu().numpy()
    u = d2h["uncertain_offset"]
    check_flags(f"{label} decode step", torch.from_numpy(a[:, u] != 0), torch.from_numpy(b[:, u] != 0),
                must_flag.cpu(), FLAG_EXTRA_LIMIT if bounded else 1.0)
    exact = list(range(d2h["int_bytes"])) + [d2h["qcfail_offset"]]
    if bounded:
        settled = (a[:, u] == 0) & (b[:, u] == 0)
        if not (a[settled][:, exact] == b[settled][:, exact]).all():
            raise AssertionError(f"{label} decode step: kernel and plain decision bytes differ on settled rows")
    else:
        # the step adds no difference beyond its classify kernels': their
        # rows that differ from the plain versions (near ties, classify_pair)
        differs = (a[:, exact] != b[:, exact]).any(axis=1)
        beyond = int((differs & ~classify_differs.cpu().numpy()).sum())
        if beyond > int(n * WIDE_DISAGREE_LIMIT):
            raise AssertionError(f"{label} decode step: decision bytes differ on {beyond} of {n} rows beyond"
                                 " the classify kernels' differences")
        say(f"[kernels] {label} decode step N={n}: decision bytes of kernels and plain differ on {int(differs.sum())}"
            f" rows, {beyond} beyond the classify kernels' differences from their plain versions"
            f" ({d2h['total']} bytes a read)")
    if not torch.equal(flat, first):
        raise AssertionError(f"{label} decode step: counters differ from the stepwise kernels'")
    if timed:
        results["step"] = {
            "ms": device_ms(lambda: step(blob, ccb, qcb)),
            "plain_ms": device_ms(lambda: step.forward_plain(blob, ccb, qcb), reps=3),
            "event_ms": event_ms(lambda: step(blob, ccb, qcb)),
            "plain_event_ms": event_ms(lambda: step.forward_plain(blob, ccb, qcb), reps=3),
        }
        try:
            launched = device_launches(lambda: step(blob, ccb, qcb))
            say(f"[kernels] {label} decode step: {sum(launched.values())} device launches a batch (torch.profiler):"
                f" {json.dumps(launched)}")
        except RuntimeError as error:  # a count read from the profiler: its dropped events are reported, not counted
            launched = str(error)
            say(f"[kernels] {label} decode step: device launches not counted: {error}")
        results["step"]["launches"] = launched
        say(f"[kernels] {label} decode step N={n}: kernels {results['step']['ms']:.4f} ms,"
            f" plain {results['step']['plain_ms']:.4f} ms (device time)")
    return results


def segment_sums_ms(instrument, rows) -> float:
    """The library yardstick of K4, the same sums K4 makes: for every
    decoder one ``index_add_`` of its decoded-keyed columns (count and pf
    count; the distances for PAMLD and MDD; the confidences for PAMLD),
    stacked (N, k), into (B + 1, k) f32 bins keyed by the decoded index,
    and for a PAMLD decoder a second of its (low confidence, noise) pair
    keyed by the argmax (device time of all the calls, one trace)."""
    import torch

    from pheniqs_tpu_torch.device.wire import counter_names

    calls = []
    for k, dec in enumerate(instrument.decoders):
        pf = (~rows.qcfail[k]).to(torch.float32)
        distance = rows.distance[k].to(torch.float32)
        confidence = rows.confidence[k]
        columns = [torch.ones_like(pf), pf, distance, pf * distance, confidence, pf * confidence]
        stacked = torch.stack(columns[: min(6, len(counter_names(dec)))], dim=1)
        index = rows.decoded[k].to(torch.int64)
        bins = torch.zeros((dec.barcode_count + 1, stacked.shape[1]), device=stacked.device)
        calls.append((bins, index, stacked))
        if dec.algorithm == "pamld":
            filters = torch.stack([(rows.branch[k] == 1), (rows.branch[k] == 2)], dim=1).to(torch.float32)
            pair = torch.zeros((dec.barcode_count + 1, 2), device=stacked.device)
            calls.append((pair, rows.argmax[k].to(torch.int64), filters))

    def run():
        for bins, index, columns in calls:
            bins.index_add_(0, index, columns)

    return device_ms(run)


def k4_bytes(instrument, n: int, want_uncertain: bool = True) -> int:
    """The bytes K4 must move for `n` rows: each decision row it reads
    (qcfail of every decoder; decoded and distance from PAMLD and MDD, as a
    naive decoder's rows all fall in its one bin; argmax, branch and
    confidence from PAMLD; the uncertain rows of PAMLD decoders), pad and
    forced read once, the counters written once."""
    from pheniqs_tpu_torch.kernels.counters import decoder_table

    moved = 2 * n + 4 * decoder_table(instrument).total
    for dec in instrument.decoders:
        moved += n
        if dec.algorithm in ("pamld", "mdd"):
            moved += 8 * n
        if dec.algorithm == "pamld":
            moved += 9 * n + (n if want_uncertain else 0)
    return moved


def k4_measure(instrument, rows, pad, forced) -> dict:
    """K4's kernels-line entry on one batch: device time of the kernel and
    its plain version, the library yardstick, the bytes of its bound, and
    its peak allocation in one call (torch.cuda.max_memory_allocated over
    the call, its output included)."""
    import torch

    from pheniqs_tpu_torch.kernels import counters

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    mine = counters.counters(instrument, rows, pad, forced, True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    plain = counters.counters_plain(instrument, rows, pad, forced, True)
    return {
        "max_abs_err": float((mine - plain).abs().max()) if mine.numel() else 0.0,
        "ms": device_ms(lambda: counters.counters(instrument, rows, pad, forced, True)),
        "plain_ms": device_ms(lambda: counters.counters_plain(instrument, rows, pad, forced, True)),
        "bytes": k4_bytes(instrument, pad.shape[0]),
        "library_ms": segment_sums_ms(instrument, rows),
        "peak_bytes": peak,
    }


#: K4's cases: name -> (decoders as (algorithm, barcodes, width), rows)
K4_FLAGSHIP = (("pamld", 96, 16), ("pamld", 384, 16), ("naive", 0, 0))
K4_CASES = {
    "flagship": (K4_FLAGSHIP, 4096),
    "mdd": ((("mdd", 96, 16), ("pamld", 384, 16), ("naive", 0, 0)), 4096),
    "naive only": ((("naive", 0, 0),), 4096),
    "one bin": ((("pamld", 384, 16), ("mdd", 96, 16)), 4096),
    "last bin": ((("pamld", 384, 16), ("mdd", 96, 16)), 4096),
    "argmax differs": ((("pamld", 96, 16),), 4096),
    "extreme confidences": ((("pamld", 96, 16),), 4096),
    "all invalid": (K4_FLAGSHIP, 4096),
    "forced": (K4_FLAGSHIP, 4096),
    "empty": (K4_FLAGSHIP, 0),
    "ragged": (K4_FLAGSHIP, 4096 + 37),
    # past 32 decoders: the uncertain mask in two words and more
    "33 decoders": ((("pamld", 96, 16), ("mdd", 40, 8), ("naive", 0, 0)) * 11, 4096),
    "64 decoders": (((("pamld", 96, 16), ("mdd", 40, 8), ("naive", 0, 0)) * 22)[:64], 4096),
}


#: a batch past the rows one K4 launch sums on 16 nt decoders (2^24 / 16)
K4_SLICED_ROWS = 2**20 + 1


def k4_case(name: str, n: int | None = None, seed: int = 5, decoders=None):
    """The decisions of one K4 case, made with numpy from `seed`:
    (instrument, arrays), the instrument a stand-in with the decoders'
    algorithm, barcode count and width, the arrays (D, n) decoded, argmax,
    distance, branch, confidence, qcfail (chained), uncertain and (n,) pad
    (the last 16 rows) and forced. Rows are drawn as K1 and K6 write them
    (decoded = argmax where the branch passes, else 0); the case's name
    bends them: every row in one bin; rows in the last bin; decoded drawn
    apart from argmax; confidences of 1 - 2^-24 and 1e-8; every row
    padding; a third of the rows forced and a fifth uncertain."""
    from types import SimpleNamespace

    import numpy as np

    specs, rows = K4_CASES.get(name, (decoders, n))
    decoders = decoders or specs
    n = rows if n is None else n
    rng = np.random.default_rng(seed)
    d = len(decoders)
    arrays = {key: np.zeros((d, n), dtype) for key, dtype in (
        ("decoded", np.int32), ("argmax", np.int32), ("distance", np.int32), ("branch", np.int8),
        ("confidence", np.float32), ("qcfail", bool), ("uncertain", bool))}
    qcfail = rng.random(n) < 0.05
    for k, (algorithm, barcodes, width) in enumerate(decoders):
        qcfail = qcfail | (rng.random(n) < 0.02)
        arrays["qcfail"][k] = qcfail
        if algorithm == "naive":
            continue
        argmax = rng.integers(1, barcodes + 1, n)
        if name == "one bin":
            argmax[:] = 7
        elif name == "last bin":
            argmax = np.where(rng.random(n) < 0.5, barcodes, argmax)
        branch = rng.choice(4, n, p=[0.8, 0.1, 0.06, 0.04])
        if name == "extreme confidences":
            branch[:] = 0
        decoded = np.where(branch == 0, argmax, 0)
        if name == "argmax differs":
            decoded = rng.integers(0, barcodes + 1, n)
        arrays["argmax"][k] = argmax
        arrays["decoded"][k] = decoded
        arrays["branch"][k] = branch
        arrays["distance"][k] = rng.integers(0, min(width, 4) + 1, n)
        if algorithm == "pamld":
            confidence = np.where(branch == 0, rng.uniform(0.95, 1.0, n), rng.uniform(0.0, 0.95, n))
            if name == "extreme confidences":
                confidence = rng.choice(np.array([1 - 2.0**-24, 1e-8]), n)
            arrays["confidence"][k] = confidence
            arrays["uncertain"][k] = rng.random(n) < (0.2 if name == "forced" else 0.01)
    arrays["pad"] = np.zeros(n, bool)
    arrays["pad"][max(0, n - 16):] = True
    if name == "all invalid":
        arrays["pad"][:] = True
    arrays["forced"] = rng.random(n) < (1 / 3 if name == "forced" else 0.005)
    instrument = SimpleNamespace(decoders=[
        SimpleNamespace(algorithm=algorithm, barcode_count=barcodes, width=width)
        for algorithm, barcodes, width in decoders
    ])
    return instrument, arrays


def k4_tensors(arrays: dict, device, offset: int = 0):
    """(Decisions, pad, forced) of a k4_case's arrays on `device`; with
    `offset`, each tensor starts that many elements into its allocation
    (contiguous, but too far off alignment for 4 reads a lane)."""
    import torch

    from pheniqs_tpu_torch.kernels import Decisions

    t = {}
    for key, value in arrays.items():
        tensor = torch.from_numpy(value)
        flat = torch.empty(tensor.numel() + offset, dtype=tensor.dtype, device=device)
        t[key] = flat[offset:].view(tensor.shape)
        t[key].copy_(tensor)
    rows = Decisions(**{key: t[key] for key in (
        "decoded", "argmax", "distance", "branch", "confidence", "qcfail", "uncertain")})
    return rows, t["pad"], t["forced"]


def k4_hold(label: str, instrument, rows, pad, forced, want_uncertain: bool = True, plan=None):
    """K4 on the card, twice, against its plain version on the same
    tensors: every counter byte-identical across the two launches and to
    the plain version, and one launch counted a call. `plan` another than
    the instrument's (counters.CounterPlan: the grouped instance where the
    instrument's is the per-decoder one)."""
    import functools

    import torch

    from pheniqs_tpu_torch.kernels import counters

    def call():
        if plan is None:
            return counters.counters(instrument, rows, pad, forced, want_uncertain)
        return counters._sliced(functools.partial(counters._launch, plan=plan), instrument, rows, pad, forced,
                                want_uncertain)

    before = counters.launches
    first = call()
    second = call()
    plain = counters.counters_plain(instrument, rows, pad, forced, want_uncertain)
    torch.cuda.synchronize()
    slices = len(counters.row_slices(instrument, pad.shape[0]))
    if counters.launches != before + 2 * slices:
        raise AssertionError(f"{label}: K4 counted {counters.launches - before} launches for two calls"
                             f" of {slices} row slices")
    if not torch.equal(first.view(torch.int32), second.view(torch.int32)):
        raise AssertionError(f"{label}: K4 is not deterministic: two launches differ")
    if not torch.equal(first.view(torch.int32), plain.view(torch.int32)):
        raise AssertionError(f"{label}: K4 differs from its plain version on {int((first != plain).sum())} counters")
    return first


#: K4's cases held again on rows one element off their allocation (4
#: reads a lane refused) at the edge checks' large size, a multiple of 4
K4_OFFSET_CASES = ("flagship", "forced", "extreme confidences", "33 decoders", "64 decoders")


def k4_edge_checks(large: int = N_KERNEL) -> int:
    """K4 held to its plain version byte for byte, two launches equal,
    with and without the uncertain mask, under each instance: every case
    runs the instrument's plan and, where that is the per-decoder
    instance, the grouped kernel too (CounterPlan.per_decoder off). The
    cases: every K4_CASES case at its own size and at `large` + 37 rows
    (not a multiple of a block's, a warp's or a lane's share: one read a
    lane); K4_OFFSET_CASES at `large` rows one element off alignment (one
    read a lane on rows a multiple of 4); the whitelist's 737,281 bins at
    `large`, `large` + 37 and off alignment; and K4_SLICED_ROWS rows,
    which K4 sums in row slices. The grouped kernel is held at both widths
    of a lane (launch_arguments' `vec`: 4 reads, or 1). Returns the number
    of cases."""
    import dataclasses

    import torch

    from pheniqs_tpu_torch.kernels import counters

    cuda = torch.device("cuda")
    whitelist = (("pamld", 96, 16), ("pamld", 737_280, 16), ("naive", 0, 0))
    cases = [(name, None, None, 0) for name in K4_CASES]
    cases += [(name, large + 37, None, 0) for name in K4_CASES if K4_CASES[name][1]]
    cases += [(name, large, None, 1) for name in K4_OFFSET_CASES]
    cases += [("whitelist bins", rows, whitelist, offset) for rows, offset in ((large, 0), (large + 37, 0), (large, 1))]
    cases += [("row slices", K4_SLICED_ROWS, K4_FLAGSHIP, 0)]
    widths = set()
    for name, n, decoders, offset in cases:
        instrument, arrays = k4_case(name, n, decoders=decoders)
        tensors = k4_tensors(arrays, cuda, offset)
        plan = counters.counter_plan(instrument)
        plans = [plan] + ([dataclasses.replace(plan, per_decoder=False)] if plan.per_decoder else [])
        rows = tensors[1].shape[0]
        for each in plans:
            label = (f"K4 case {name}, {rows} rows{' off alignment' if offset else ''},"
                     f" {'per-decoder' if each.per_decoder else 'grouped'} instance")
            for want_uncertain in (True, False):
                out = k4_hold(label, instrument, *tensors, want_uncertain, plan=each)
            if not each.per_decoder and len(counters.row_slices(instrument, rows)) == 1:
                widths.add(counters.launch_arguments(instrument, *tensors, True, 132, each)[1]["vec"])
        if name == "row slices" and out.dtype != torch.float64:
            raise AssertionError(f"K4 in row slices returned {out.dtype}")
    if widths != {1, 4}:
        raise AssertionError(f"K4 edge checks held the grouped kernel at {sorted(widths)} reads a lane, not 1 and 4")
    say(f"[k4] byte-identical to the plain version and across two launches, with and without the uncertain mask,"
        f" on {len(cases)} cases under each instance (the grouped kernel at 1 and 4 reads a lane):"
        f" every K4_CASES case at its size and at {large + 37} rows, {len(K4_OFFSET_CASES)} off alignment at"
        f" {large}, 737,281 bins at {large}, {large + 37} and off alignment, and {K4_SLICED_ROWS} rows in"
        f" {len(counters.row_slices(instrument, K4_SLICED_ROWS))} row slices")
    return len(cases)


def k4_threshold_sweep(n: int = N_KERNEL) -> list:
    """K4's device time on one synthetic PAMLD decoder of B barcodes at
    `n` rows, with its histogram in shared memory and with every row added
    straight into global atomics, at B + 1 across the shared-memory limit
    (counters.SHARED_LIMIT set to the most a block may take, then to 0,
    and put back). Returns (B, shared ms, global ms) per B."""
    import torch

    from pheniqs_tpu_torch.kernels import counters

    cuda = torch.device("cuda")
    chosen = counters.SHARED_LIMIT
    rows = []
    try:
        for barcodes in (96, 384, 1024, 1536, 2048, 3072, 4096):
            instrument, arrays = k4_case("sweep", n, decoders=(("pamld", barcodes, 16),))
            tensors = k4_tensors(arrays, cuda)
            times = []
            for limit in (counters.SHARED_MAX, 0):
                counters.SHARED_LIMIT = limit
                times.append(device_ms(lambda: counters.counters(instrument, *tensors, True)))
            counters.SHARED_LIMIT = counters.SHARED_MAX
            shared = counters.decoder_table(instrument).rows[0][5]
            rows.append((barcodes, *times))
            say(f"[k4] B={barcodes} N={n}: shared histogram ({shared} B) {times[0]:.4f} ms,"
                f" global atomics {times[1]:.4f} ms (device time)")
    finally:
        counters.SHARED_LIMIT = chosen
    return rows


def tile_loop_report(n: int, panels) -> dict:
    """The tile loop as the card runs it (csrc/pamld.cu phq_pamld_info):
    per instance (MAXW 16, 32 and 64, and the looped one at W = 128, 160
    and 300; classify, stage A, stage B) its
    registers, local (spill) bytes and resident blocks per SM; threads,
    reads and barcodes a step, tiles and the slice unit; and for each panel
    of `panels` at `n` reads the slice plan as pamld_classify runs it (K1's
    panels too): slices, their cut (a whole tile or the unit), blocks,
    resident slots and waves. Returns {B: the plan's keys} for the kernels
    line."""
    import torch

    from pheniqs_tpu_torch.kernels import pamld

    cuda = torch.device("cuda")
    for w in (16, 32, 64, 128, 160, 300):
        loop = pamld.tile_loop(w, cuda)
        parts = ", ".join(f"{name} {blocks} blocks/SM, {registers} registers, {local} B local"
                          for name, (blocks, registers, local) in loop.instances.items())
        instance = f"MAXW={loop.maxw}" if loop.maxw else f"looped (MAXW=0) at W={w}"
        say(f"[kernels] tile loop {instance}: {loop.threads} threads x {loop.reads_per_block // loop.threads}"
            f" reads a block, {loop.unroll} barcodes a step, tiles of {loop.tile} barcodes, slices cut below a tile"
            f" at {loop.unit}, {loop.sms} SMs; {parts}")
    loop = pamld.tile_loop(16, cuda)
    plans = {}
    for barcodes in panels:
        plan = pamld.plan_for(n, barcodes, 16, cuda)
        instance = "stage B" if plan.slices > 1 else "classify"
        slots = loop.sms * loop.instances[instance][0]
        waves = plan.read_blocks * plan.slices / slots
        if plan.slices == 1:
            layout = "one launch"
        else:
            cut = "whole tiles" if plan.cut == plan.tile else "units"
            layout = f"{plan.slices} slices of {plan.cuts} {cut} of {plan.cut} barcodes"
        say(f"[kernels] B={barcodes} W=16 N={n}: {layout}, {plan.read_blocks} x {plan.slices} blocks over {slots}"
            f" resident slots ({instance}), {waves:.2f} waves, {1 if plan.slices == 1 else 3} launches")
        plans[barcodes] = {"slices": plan.slices, "cut": plan.cut, "waves": waves, "blocks_per_sm": slots // loop.sms,
                           "registers": loop.instances[instance][1]}
        if plan.slices == 1 and barcodes <= loop.tile:
            alternative = pamld.sliced_plan(n, barcodes, 16, cuda)
            say(f"[kernels] B={barcodes} W=16 N={n}: one launch fills its slots as well as slices; sliced it would be"
                f" {alternative.slices} slices of {alternative.cut} barcodes, {alternative.waves:.2f} waves")
            plans[barcodes]["sliced"] = {"slices": alternative.slices, "cut": alternative.cut,
                                         "waves": alternative.waves}
    return plans


def pamld_observations(ontology, n: int, seed: int, panels=None):
    """(instrument, [(dec, codes, quals, qcfail, short)] for each PAMLD
    decoder) of a j4 batch of `n` reads of `ontology` on the card (drawn
    from `panels` where given, flagship_blob), unpacked by K3's plain
    version."""
    import torch

    from pheniqs_tpu_torch.device import wire
    from pheniqs_tpu_torch.device.instrument import compile_instrument
    from pheniqs_tpu_torch.device.step import DecodeStep
    from pheniqs_tpu_torch.kernels import unpack

    cuda = torch.device("cuda")
    instrument = compile_instrument(ontology, cuda)
    widths, *arrays = flagship_blob(ontology, instrument, n, seed=seed, panels=panels)
    blob, ccb, qcb = (torch.from_numpy(x).to(cuda) for x in arrays)
    layout = DecodeStep(instrument, widths, wire.JOINT4, want_uncertain=True).layout
    tokens = unpack.unpack_tokens_plain(instrument, layout, blob, ccb=ccb, qcb=qcb)
    observations = []
    slot = 0
    for dec in instrument.decoders:
        if dec.algorithm not in ("pamld", "mdd"):
            continue
        codes, quals, _, short = tokens.observation(layout, slot)
        slot += 1
        if dec.algorithm == "pamld":
            observations.append((dec, codes, quals, tokens.qcfail, short))
    return instrument, observations


#: the slice counts of the cut sweep at B = 96 (each a divisor: slices of
#: equal width), for the per-slice cost of a block's prologue
SWEEP_SLICES = (1, 2, 3, 4, 6, 8, 12)


def kernel_breakdown(fn, reps: int = 10) -> dict:
    """Device milliseconds per call of `fn` by kernel, from torch.profiler
    over `reps` calls: {kernel name without its arguments: ms}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {}
    for event in prof.key_averages():
        if event.self_device_time_total > 0:
            name = event.key.split("(")[0].replace("void ", "")
            times[name] = times.get(name, 0.0) + event.self_device_time_total / 1000.0 / reps
    return times


def slice_cut_sweep(n: int = N_KERNEL) -> dict:
    """What the slice unit of K1 trades, on the flagship's panels at `n`
    reads (device time of one pamld_classify call, every launch it makes):
    at B = 96 the panel in S slices of 96 / S barcodes for each S of
    SWEEP_SLICES, and a line fitted over S >= 2: its slope is what one more
    slice costs (the per-block prologue of every read block in stages A
    and B: TPQ table, the reads' loads and features, the shift rows, the
    tile load, the partials written; and stage C's reads of one more
    slice), its intercept the arithmetic; then at B = 96 and 384 the plan
    a unit of 16, 32, 48 or 64 barcodes would give; and the device time by
    kernel of the one-launch instance and of the sliced plan at B = 96 and
    384. Returns the times and the fit for the kernels line."""
    import dataclasses

    import numpy as np

    from pheniqs_tpu_torch.device.flagship import flagship_ontology
    from pheniqs_tpu_torch.kernels import pamld

    instrument, observations = pamld_observations(flagship_ontology(), n, seed=384)
    loop = pamld.tile_loop(16, instrument.device)
    read_blocks = -(-n // loop.reads_per_block)
    result = {"forced": [], "units": [], "by_kernel": {}}

    def call(dec, codes, quals, qcfail, short, plan):
        return lambda: pamld._classify_launches(
            dec, codes, quals, qcfail, short, instrument.tpq_constants, True, instrument.tpq_analytic_eps, None,
            plan=plan)

    for dec, codes, quals, qcfail, short in observations:
        b = dec.barcode_count
        if b == 96:
            for slices in SWEEP_SLICES:
                plan = pamld.SlicePlan(slices, b, loop.tile, read_blocks, loop.slots, b // slices)
                ms = device_ms(call(dec, codes, quals, qcfail, short, plan))
                result["forced"].append({"slices": slices, "cut": b // slices, "waves": plan.waves, "ms": ms})
                say(f"[kernels] cut sweep B={b} N={n}: {slices} slices of {b // slices} barcodes, {plan.waves:.2f}"
                    f" waves, {ms:.4f} ms (device time)")
            fit = [(r["slices"], r["ms"]) for r in result["forced"] if r["slices"] >= 2]
            slope, intercept = np.polyfit([x for x, _ in fit], [y for _, y in fit], 1)
            result["per_slice_ms"], result["arithmetic_ms"] = float(slope), float(intercept)
            say(f"[kernels] cut sweep B={b} N={n}: a line over S >= 2 slices: {slope:.5f} ms a slice (the"
                f" prologues of {read_blocks} read blocks in stages A and B, stage C's reads) + {intercept:.4f} ms")
        for unit in (16, 32, 48, 64):
            plan = pamld.slice_plan(n, b, loop.tile, loop.reads_per_block, loop.slots, unit)
            ms = device_ms(call(dec, codes, quals, qcfail, short, plan))
            result["units"].append({"barcodes": b, "unit": unit, "slices": plan.slices, "waves": plan.waves, "ms": ms})
            say(f"[kernels] cut sweep B={b} N={n}: a unit of {unit} gives {plan.slices} slices, {plan.waves:.2f}"
                f" waves, {ms:.4f} ms (device time)")
        plan = pamld.sliced_plan(n, b, codes.shape[1], codes.device)
        for label, chosen in (("one launch", dataclasses.replace(plan, slices=1)), ("sliced", plan)):
            parts = kernel_breakdown(call(dec, codes, quals, qcfail, short, chosen))
            result["by_kernel"][f"B={b} {label}"] = parts
            say(f"[kernels] cut sweep B={b} N={n} {label} ({chosen.slices} slices), device time by kernel: "
                + ", ".join(f"{name} {ms:.4f} ms" for name, ms in parts.items()))
    return result


def kernel_checks(n: int = N_KERNEL, timed: bool = True) -> dict:
    """Each kernel against its plain version on the card, on the flagship
    (and a 1024-barcode cellular panel), the MDD flagship (and its
    tolerance-2, quality-masked variant on reads cut short) and a
    4096-barcode cellular panel. Returns per kernel {max_abs_err, ms,
    plain_ms} and the flagship step's times; raises on any disagreement."""
    import torch

    from pheniqs_tpu_torch.device.flagship import flagship_ontology, mdd_flagship_ontology
    from pheniqs_tpu_torch.device.instrument import LARGE_PANEL_B, analytic_tpq, analytic_tpq_epsilon
    from pheniqs_tpu_torch.kernels import pamld

    cuda = torch.device("cuda")
    # the TPQ epsilon, measured by K1's own __device__ function
    eps = analytic_tpq_epsilon(cuda)
    q = torch.arange(1, 128, dtype=torch.int32)
    tpq_gap = float((pamld.tpq_device(q.to(cuda)).cpu() - analytic_tpq(q)).abs().max())
    say(f"[kernels] GPU-measured analytic TPQ epsilon {eps:.6e}"
        f" (CPU torch {analytic_tpq_epsilon('cpu'):.6e}; max |GPU - CPU| {tpq_gap:.3e})")
    unpack_checks(n)
    start = time.perf_counter()
    unpack_edge_checks()
    mdd_edge_checks(n)
    pack_edge_checks()
    say(f"[kernels] K3's, K6's and K5's edge checks took {time.perf_counter() - start:.1f} s")
    for fragment in ("phq_unpack_kernel", "phq_unpack_columns", "phq_mdd_kernel", "phq_mdd_wide", "phq_pack_kernel"):
        for kernel, line in ptxas_report(fragment).items():
            say(f"[kernels] ptxas {kernel}: {line}")

    results = step_checks("flagship", flagship_ontology(), n, seed=384, timed=timed)
    step_checks(f"flagship B={LARGE_PANEL_B}", flagship_ontology(cellular_barcodes=LARGE_PANEL_B),
                n, seed=LARGE_PANEL_B, timed=timed)
    mdd = step_checks("mdd flagship", mdd_flagship_ontology(), n, seed=96, timed=timed)
    if timed:
        results["mdd_classify"] = mdd["mdd_classify"]
        results["mdd_step"] = mdd["step"]
    variant = mdd_flagship_ontology()
    variant["sample"]["distance tolerance"] = [2, 2]
    variant["sample"]["quality masking threshold"] = 20
    step_checks("mdd flagship tolerance 2, qmt 20, 10% short", variant, n, seed=97, timed=False, short=0.1)
    chunked = step_checks(f"flagship B={K7_PANEL}", flagship_ontology(cellular_barcodes=K7_PANEL),
                          n, seed=K7_PANEL, timed=timed)
    if timed:
        results["chunked_4096"] = chunked["pamld_chunked"]["parts"][-1]
    return results


class Whitelist:
    """The whitelist flagship, its panels and its instrument on the card,
    built once (737,280 barcodes: seconds of host work each)."""

    def __init__(self):
        import torch

        from pheniqs_tpu_torch.device.flagship import panel_codes, whitelist_flagship_ontology
        from pheniqs_tpu_torch.device.instrument import compile_instrument

        start = time.perf_counter()
        self.ontology = whitelist_flagship_ontology()
        self.panels = panel_codes(self.ontology)
        self.instrument = compile_instrument(self.ontology, torch.device("cuda"))
        self.decoder = self.instrument.decoders[2]
        #: the e2e instruction PRECOMPILE compiled (precompiled), which
        #: every whitelist e2e run takes
        self.compiled = None
        say(f"[kernels] whitelist flagship: {self.decoder.barcode_count} x {self.decoder.width} nt"
            f" cellular panel built and placed in {time.perf_counter() - start:.1f} s")

    #: every e2e run of the whitelist writes here
    output = os.path.join(WORK, "whitelist.sam")
    #: PRECOMPILE's compiled instruction, pickled
    instruction = os.path.join(WORK, "whitelist_instruction.pickle")

    def inputs(self, n: int) -> list[str]:
        from pheniqs_tpu_torch.benchmark import synthesize_fastq_input

        return synthesize_fastq_input(os.path.join(WORK, "whitelist"), n, ontology=self.ontology, panels=self.panels)


#: the whitelist's e2e instruction, compiled by a process of its own while
#: the kernel phases run on the card (its ~80 s of JSON work off the run's
#: path) on 16 reads, and pickled into Whitelist.instruction
PRECOMPILE = r"""
import os, pickle, sys

sys.path.insert(0, sys.argv[1])
import chip_smoke
from pheniqs_tpu_torch.benchmark import e2e_ontology, synthesize_fastq_input
from pheniqs_tpu_torch.device.flagship import whitelist_flagship_ontology

ontology = whitelist_flagship_ontology()
paths = synthesize_fastq_input(os.path.join(chip_smoke.WORK, "precompile"), 16, ontology=ontology)
compiled = e2e_ontology(paths, chip_smoke.Whitelist.output, int(sys.argv[2]), ontology)
with open(chip_smoke.Whitelist.instruction, "wb") as stream:
    pickle.dump(compiled, stream, protocol=pickle.HIGHEST_PROTOCOL)
"""


def precompile_whitelist(threads: int) -> subprocess.Popen:
    """Start PRECOMPILE (its output in WORK)."""
    with open(os.path.join(WORK, "precompile.log"), "w") as log:
        return subprocess.Popen([sys.executable, "-c", PRECOMPILE, HERE, str(threads)], stdout=log,
                                stderr=subprocess.STDOUT, text=True)


def precompiled(process: subprocess.Popen, timeout: float = 900) -> dict:
    """Wait for PRECOMPILE and return its instruction; raise with its
    output if it failed."""
    import pickle

    if process.wait(timeout=timeout) != 0:
        with open(os.path.join(WORK, "precompile.log")) as log:
            raise AssertionError(f"the whitelist's instruction did not compile:\n{log.read()[-4000:]}")
    with open(Whitelist.instruction, "rb") as stream:
        return pickle.load(stream)


def whitelist_checks(whitelist: Whitelist, n: int = N_KERNEL) -> dict:
    """Every kernel of the whitelist's decode step against its plain
    version (step_checks, unbounded): K3, K1 on the sample panel, K7 at
    737,280 barcodes, K4 over 737,281 bins (timed: k4_measure) and K5's
    int32 decoded index. Returns K7's max |diff| and one-call times, and
    K4's entry."""
    return step_checks("whitelist flagship", whitelist.ontology, n, seed=737, timed=False,
                       panels=whitelist.panels, instrument=whitelist.instrument, bounded=False, time_k4=True)


def exact_row_min(dec, codes, quals, start: int, stop: int, chunk: int = 1024):
    """The f64 row minimum of sigma over panel columns [start, stop): the
    exact sums of the f32 terms F.G + qpos*U, in column chunks."""
    import numpy as np
    import torch

    from pheniqs_tpu_torch.kernels import pamld

    features = pamld.observation_features_plain(codes, quals).to(torch.float64)
    best = torch.full((codes.shape[0],), float("inf"), dtype=torch.float64, device=codes.device)
    for first in range(start, stop, chunk):
        g = dec.likelihood_matrix[:, first : min(first + chunk, stop)].to(torch.float64)
        best = torch.minimum(best, (features @ g).min(dim=1).values)
    return best + (quals > 0).sum(dim=1).to(torch.float64) * float(np.float32(pamld.UNIFORM_BASE_QUALITY))


def k8_checks(whitelist: Whitelist, n: int = N_KERNEL) -> dict:
    """K8 at the whitelist, in one process: the 737,280-barcode panel split
    into P = 2 and 4 shards on the card, every shard's stages launched here
    and merged in process (device/tp.py). Held to K7 on the same batch:
    argmax identical on every row (the shift and the maxima are exact in
    any order), decisions identical on the rows neither flags and
    differing on at most WIDE_DISAGREE_LIMIT of all rows, flags disagreeing
    on at most FLAG_DISAGREE_LIMIT of the rows, confidences within rtol
    1e-5 where settled (the totals are summed per shard, then across
    shards); the whole K8 on every row as K7 is (classify_pair, unbounded:
    to its plain version, near ties in f64 apart, and to the tile loop's
    own arithmetic); and each shard's merged stages alone: the row minimum
    of it and of the plain version each within d_sigma of the f64 one
    (exact_row_min), the best index differing from the plain version's
    only on near ties in f64 but for at most WIDE_DISAGREE_LIMIT of the
    rows. Per shard: the kernel's stages A + B and the plain version's,
    one call each (CUDA events). Returns the kernels-line entry of the
    P = 2 run (per shard)."""
    import torch

    from pheniqs_tpu_torch.device import tp, wire
    from pheniqs_tpu_torch.device.step import DecodeStep
    from pheniqs_tpu_torch.kernels import pamld, unpack

    instrument, dec = whitelist.instrument, whitelist.decoder
    cuda = torch.device("cuda")
    widths, blob_np, ccb_np, qcb_np = flagship_blob(whitelist.ontology, instrument, n, 738, panels=whitelist.panels)
    blob, ccb, qcb = (torch.from_numpy(x).to(cuda) for x in (blob_np, ccb_np, qcb_np))
    layout = DecodeStep(instrument, widths, wire.JOINT4, want_uncertain=True).layout
    tokens = unpack.unpack_tokens_plain(instrument, layout, blob, ccb=ccb, qcb=qcb)
    slot = sum(1 for d in instrument.decoders[:2] if d.algorithm in ("pamld", "mdd") and d.plans)
    codes, quals, _, short = tokens.observation(layout, slot)
    qcfail = tokens.qcfail
    kwargs = dict(tpq_constants=instrument.tpq_constants, want_uncertain=True,
                  eps=instrument.tpq_analytic_eps, short=short)
    k7, k7_ms = once_ms(lambda: pamld.pamld_classify(dec, codes, quals, qcfail, **kwargs))
    twin = pamld.pamld_classify_tile_order(dec, codes, quals, qcfail, want_uncertain=True,
                                           eps=instrument.tpq_analytic_eps, short=short)
    keys = ("decoded", "argmax", "distance", "branch", "qcfail")
    result = None
    for panels in K8_PANELS:
        shards = [tp.shard_panel(dec, rank, panels) for rank in range(panels)]
        label = f"K8 P={panels} B={dec.barcode_count} N={n}"
        k8, k8_ms = once_ms(lambda: pamld.pamld_classify_sharded(dec, shards, codes, quals, qcfail, **kwargs))
        if not torch.equal(k8["argmax"], k7["argmax"]):
            raise AssertionError(f"{label}: argmax differs from K7's on {int((k8['argmax'] != k7['argmax']).sum())} rows")
        disagree, _ = check_flags(f"{label} vs K7", k8["uncertain"], k7["uncertain"], short, 1.0)
        settled = ~(k8["uncertain"] | k7["uncertain"])
        differs = torch.zeros_like(settled)
        for key in keys:
            if not torch.equal(k8[key][settled], k7[key][settled]):
                raise AssertionError(f"{label}: {key} differs from K7's on settled rows")
            differs |= k8[key] != k7[key]
        if int(differs.sum()) > int(n * WIDE_DISAGREE_LIMIT):
            raise AssertionError(f"{label}: decisions differ from K7's on {int(differs.sum())} of {n} rows")
        a, b = k8["confidence"][settled], k7["confidence"][settled]
        if not torch.allclose(a, b, rtol=1e-5, atol=0.0):
            raise AssertionError(f"{label}: confidence beyond rtol 1e-5 of K7's on settled rows")
        same = ~differs & ~short
        vs_k7 = float(((k8["confidence"] - k7["confidence"]).abs() / k7["confidence"].abs().clamp(min=1e-30))[same].max())
        plain, plain_ms = once_ms(lambda: pamld.pamld_classify_sharded(
            dec, shards, codes, quals, qcfail, plain=True, **kwargs))
        check_flags(f"{label} vs plain", k8["uncertain"], plain["uncertain"], short, 1.0)
        # every row as K7's (classify_pair): to the plain version, near ties
        # in f64 apart, and to the tile loop's own arithmetic
        differs_plain = torch.zeros_like(settled)
        for key in keys:
            differs_plain |= k8[key] != plain[key]
        ties = near_tie_rows(f"{label} vs plain", dec, codes, quals, k8["argmax"].long() - 1,
                             plain["argmax"].long() - 1, differs_plain)
        held = ~differs_plain & ~short
        a, b = k8["confidence"][held], plain["confidence"][held]
        if not torch.allclose(a, b, rtol=WIDE_CONFIDENCE_RTOL, atol=0.0):
            raise AssertionError(f"{label}: confidence beyond rtol {WIDE_CONFIDENCE_RTOL} of the plain version's")
        err = float((a - b).abs().max())
        differs = torch.zeros_like(settled)
        for key in keys:
            differs |= k8[key] != twin[key]
        if int(differs.sum()) > int(n * WIDE_DISAGREE_LIMIT):
            raise AssertionError(f"{label}: decisions differ from the tile-order version's on {int(differs.sum())} rows")
        same_twin = ~differs & ~short
        if not torch.allclose(k8["confidence"][same_twin], twin["confidence"][same_twin],
                              rtol=WIDE_CONFIDENCE_RTOL, atol=0.0):
            raise AssertionError(f"{label}: confidence beyond rtol {WIDE_CONFIDENCE_RTOL} of the tile-order version's")
        settled = ~(k8["uncertain"] | plain["uncertain"])
        for key in keys:
            if not torch.equal(k8[key][settled], plain[key][settled]):
                raise AssertionError(f"{label}: {key} differs from the plain version's on settled rows")
        say(f"[kernels] {label}: argmax = K7's on every row; decisions differ from K7's on {int((~same & ~short).sum())}"
            f" unforced rows, flags on {disagree}; confidence vs K7 max relative {vs_k7:.3e}; vs plain {ties},"
            f" confidence max |diff| {err:.3e}; vs the tile-order version decisions differ on {int(differs.sum())}"
            f" rows; whole K8 {k8_ms:.1f} ms (K7 {k7_ms:.1f} ms), plain {plain_ms:.1f} ms (one call each, CUDA events)")
        shard = shards[0]
        (shift, merged), ms = once_ms(lambda: pamld.pamld_classify_sharded(
            dec, [shard], codes, quals, None, finish=False, **kwargs))
        (plain_shift, plain_merged), shard_plain_ms = once_ms(lambda: pamld.pamld_classify_sharded(
            dec, [shard], codes, quals, None, finish=False, plain=True, **kwargs))
        # the row minimum of each within d_sigma(read) of the f64 minimum of
        # the same f32 terms, the bound the hybrid guarantee rests on (a
        # relative tolerance does not fit: a near-perfect match's minimum is
        # near 0, and the tile loop's sum M + C cancels two sums of about
        # the read's quality sum)
        exact = exact_row_min(dec, codes, quals, shard.base, shard.base + shard.count)
        d_sigma = pamld.sigma_bound(codes.shape[1], 0.0, quals.to(torch.float64).sum(dim=1))
        worst = {}
        for side, value in (("kernel", shift), ("plain", plain_shift)):
            worst[side] = float(((value.double() - exact).abs() / d_sigma).max())
            if worst[side] > 1.0:
                raise AssertionError(f"{label} shard 0: the {side} row minimum lies {worst[side]:.3f} d_sigma from"
                                     " the f64 one")
        beyond_rtol = int(((shift - plain_shift).abs() > 1e-5 * plain_shift.abs()).sum())
        # the shard's best barcode of a read from another shard is one of
        # many at the same distance: the two orders break those ties apart
        index_ties = near_tie_rows(f"{label} shard 0 best index vs plain", dec, codes, quals, merged["best0"],
                                   plain_merged["best0"], merged["best0"] != plain_merged["best0"])
        say(f"[kernels] {label} shard 0 ({shard.count} barcodes): stages A + B {ms:.1f} ms, plain {shard_plain_ms:.1f} ms"
            f" (one call each, CUDA events); row minimum within {worst['kernel']:.3e} d_sigma of the f64 one"
            f" (plain {worst['plain']:.3e}; {beyond_rtol} rows beyond rtol 1e-5 of plain); best index: {index_ties}")
        if result is None:
            w = codes.shape[1]
            result = {"max_abs_err": err, "ms": ms, "plain_ms": shard_plain_ms, "library_ms": None,
                      "bytes": 2 * n * w + shard.count * (w + 4) + 4 * n * 6,
                      "ops": 4 * n * shard.count * (w + 1)}
    return result


# --- the wide phase: the inputs the kernels once refused -------------------
#: K1's observation widths (all past 64: the looped instance) and cellular
#: panels in the wide phase
WIDE_WIDTHS = (65, 96, 128, 160, 300)
WIDE_PANELS = (96, 384)
#: K7 (and K8 over two shards) at 96 positions
WIDE_K7_PANEL = 4096
#: (B, W) of the wide case at the loop's tails: W not a multiple of 4 or 16
#: (the last block of positions cut to one word), B not a multiple of the
#: barcode loop's group or of the slice unit 48
WIDE_ODD = (101, 97)
#: barcodes holding an N in the mixed wide case (B = 384, W = 96): barcodes
#: with other codes than A, C, G and T inside groups of strict ones
WIDE_MIXED = 5
#: --times' wide rows (W, B): K1 at each, K7 and K8 over two shards at 96 x
#: WIDE_K7_PANEL (wide_times)
WIDE_TIMED = ((65, 96), (65, 384), (96, 96), (96, 384), (300, 96), (300, 384))
#: K6 past 8 segments or 64 positions: (segment widths, barcodes) of 9 and
#: 12 segments of 40-130 positions (the wide instance past 64)
WIDE_MDD = (([9] * 8 + [8], 80), ([7] * 8 + [6] * 4, 60), ([15] * 4 + [14] * 5, 50), ([11] * 10 + [10, 10], 40))
#: token plans of K3's programs past 2048 ints (~3,000 and ~10,000 ints)
WIDE_PROGRAM_PLANS = (330, 1100)
#: K4's and K5's decoder counts past 32
WIDE_DECODERS = (33, 64)
#: K5's rows past the shared budget (assembled in place): decoders of
#: int32 indices, and the reads they are held at
WIDE_PACK_IN_PLACE = (300, 4097)
#: the wide flagship's e2e runs (W = 96): hybrid == strict, then fast
#: against strict; the same on its 4096-barcode variant, on fewer reads
N_WIDE_HYBRID = 20_000
N_WIDE_FAST = 200_000
N_WIDE_K7_HYBRID = 4_000
N_WIDE_K7_FAST = 20_000
#: the wide MDD instrument's hybrid run against strict
N_WIDE_MDD = 20_000


def wide_unpack_cases(n: int):
    """((instrument, layout, program, blob, ccb, qcb), columns) of K3's
    wide rows on `n` reads: each program of WIDE_PROGRAM_PLANS under the
    column plan, and under the block plan where it stages the program
    whole; the 2048 length columns of lengths_blob under the column plan."""
    from pheniqs_tpu_torch.kernels import unpack

    for count in WIDE_PROGRAM_PLANS:
        case = program_blob(n, count)
        if unpack.block_plan(case[1], case[3].shape[1]).shared_bytes <= unpack.SHARED_BYTES:
            yield case, False
        yield case, True
    yield lengths_blob(n), True


def wide_ontology(b: int, w: int, mixed: int = 0) -> dict:
    """wide_flagship_ontology(b, w) with an N at position 7k mod w of
    barcode 9k + 1 for k < `mixed`."""
    from pheniqs_tpu_torch.device.flagship import wide_flagship_ontology

    ontology = wide_flagship_ontology(b, w)
    codec = ontology["cellular"][0]["codec"]
    for k, key in enumerate(list(codec)[1 : 1 + 9 * mixed : 9]):
        word, at = codec[key]["barcode"][0], 7 * k % w
        codec[key]["barcode"] = [word[:at] + "N" + word[at + 1 :]]
    return ontology


def wide_decoders(n: int):
    """(name, B, W, mixed, dec, instrument, codes, quals, qcfail, short) of
    each wide K1/K7 case: the wide flagship's cellular decoder at each of
    WIDE_WIDTHS x WIDE_PANELS, at WIDE_ODD, with WIDE_MIXED barcodes holding
    an N at 384 x 96 (its reads drawn from the barcodes without the N, as
    a sequencer's N is a base of its own quality), and at WIDE_K7_PANEL x
    96, on `n` of its reads (j4 wire, K3's plain version)."""
    from pheniqs_tpu_torch.device.flagship import panel_codes

    cases = [(b, w, 0) for w in WIDE_WIDTHS for b in WIDE_PANELS]
    cases += [(*WIDE_ODD, 0), (384, 96, WIDE_MIXED), (WIDE_K7_PANEL, 96, 0)]
    for b, w, mixed in cases:
        instrument, observations = pamld_observations(wide_ontology(b, w, mixed), n, seed=w + b + mixed,
                                                      panels=panel_codes(wide_ontology(b, w)))
        dec, codes, quals, qcfail, short = observations[1]
        name = "pamld_chunked" if b > 1024 else "pamld_classify"
        yield name, b, w, mixed, dec, instrument, codes, quals, qcfail, short


def apart_rows(what: str, dec, codes, quals, mine: dict, other: dict, differs) -> str:
    """The rows `differs` where two runs of one PAMLD decoder decide apart
    at a width where sigma's f32 rounding in two orders moves a confidence
    by ~1e-3 of itself: a row whose best barcodes differ is a near tie in
    f64 (near_tie_rows); a row with the same best barcode sits at a
    threshold's edge (the confidence or the noise filter), which both runs
    must flag uncertain (the hybrid host re-resolves it). Returns the
    line's report."""
    apart = differs & (mine["argmax"] != other["argmax"])
    edge = differs & ~apart
    unflagged = int((edge & ~(mine["uncertain"] & other["uncertain"])).sum())
    if unflagged:
        raise AssertionError(f"{what}: {unflagged} rows decided apart at a threshold are not flagged by both")
    ties = near_tie_rows(what, dec, codes, quals, mine["argmax"].long() - 1, other["argmax"].long() - 1, apart)
    return f"{ties}; {int(edge.sum())} more at a threshold's edge, flagged by both"


def wide_pamld_entry(dec, instrument, codes, quals, qcfail, short, mixed: int = 0) -> dict:
    """One wide K1/K7 case on the card: launched twice, byte-identical; the
    sliced launches held to the one-launch instance (sliced_vs_one_launch,
    where the panel is one tile); decisions bit-equal on every row to its
    tile-order twin (pamld_classify_tile_order: the same sigma order, the
    posterior's sum in another), confidences within that sum's bound
    2*gamma(B+2) + 8u of the twin's, uncertain flags apart on at most
    FLAG_DISAGREE_LIMIT of the rows; against the plain version (the
    contraction F.G) every row whose decisions differ a near tie in f64
    or a threshold's edge both flag (apart_rows), settled rows equal, and
    confidences where the
    decisions agree within the bound's own margin rel_eps(read) of each
    other (at these widths sigma is ~10^3, whose f32 rounding in two orders
    moves an ambiguous read's confidence by ~1e-4 of itself). `mixed`: the
    panel's barcodes holding an N. Returns its extra.wide entry."""
    import torch

    from pheniqs_tpu_torch.kernels import pamld

    n, w = codes.shape
    b = dec.barcode_count
    name = f"K{7 if b > pamld.LARGE_PANEL_B else 1} W={w} B={b} N={n}"
    if mixed:
        name += f" ({mixed} barcodes with an N)"
    holding = int((dec.panel_codes_u8 == 15).any(dim=1).sum())
    if holding != mixed:
        raise AssertionError(f"{name}: {holding} barcodes of the panel hold an N")
    kwargs = dict(want_uncertain=True, eps=instrument.tpq_analytic_eps, short=short)
    counter = "pamld_chunked" if b > pamld.LARGE_PANEL_B else "pamld_classify"

    def call():
        return pamld.pamld_classify(dec, codes, quals, qcfail, tpq_constants=instrument.tpq_constants, **kwargs)

    mine, again = call(), call()
    ms, launches = counted_event_ms(counter, call, reps=5)
    for key in mine:
        if not torch.equal(mine[key], again[key]):
            raise AssertionError(f"{name}: two launches differ in {key} on {int((mine[key] != again[key]).sum())} rows")
    one_launch = ""
    if b <= pamld.LARGE_PANEL_B:
        one_launch = "; " + sliced_vs_one_launch(dec, instrument, codes, quals, qcfail, short)
    keys = ("decoded", "argmax", "distance", "branch", "qcfail")
    twin = pamld.pamld_classify_tile_order(dec, codes, quals, qcfail, **kwargs)
    for key in keys:
        if not torch.equal(mine[key], twin[key]):
            raise AssertionError(f"{name}: {key} differs from the tile-order twin on {int((mine[key] != twin[key]).sum())}"
                                 " rows")
    twin_rel = float(((mine["confidence"] - twin["confidence"]).abs() / twin["confidence"].abs().clamp(min=1e-30)).max())
    tolerance = 2.0 * pamld.gamma(b + 2) + 8.0 * pamld.U32
    if twin_rel > tolerance:
        raise AssertionError(f"{name}: confidence {twin_rel:.3e} of the tile-order twin's, beyond {tolerance:.3e}")
    twin_flags = int((mine["uncertain"] != twin["uncertain"]).sum())
    if twin_flags > int(n * FLAG_DISAGREE_LIMIT):
        raise AssertionError(f"{name}: uncertain flags differ from the tile-order twin's on {twin_flags} rows")
    plain = pamld.pamld_classify_plain(dec, codes, quals, qcfail, **kwargs)
    plain_ms = event_ms(lambda: pamld.pamld_classify_plain(dec, codes, quals, qcfail, **kwargs), reps=3)
    differs = torch.zeros_like(mine["uncertain"])
    for key in keys:
        differs |= mine[key] != plain[key]
    ties = apart_rows(f"{name} vs plain", dec, codes, quals, mine, plain, differs)
    settled = ~(mine["uncertain"] | plain["uncertain"])
    for key in keys:
        if not torch.equal(mine[key][settled], plain[key][settled]):
            raise AssertionError(f"{name}: {key} differs from the plain version on settled rows")
    held = ~differs & ~short
    rel_eps, _ = pamld._uncertain_margins(dec, w, instrument.tpq_analytic_eps, quals.sum(dim=1).to(torch.float32))
    a, c = mine["confidence"][held], plain["confidence"][held]
    beyond = int(((a - c).abs() > rel_eps[held] * torch.maximum(a, c)).sum())
    if beyond:
        raise AssertionError(f"{name}: {beyond} confidences beyond rel_eps(read) of the plain version's")
    err = float((a - c).abs().max()) if a.numel() else 0.0
    plain_rel = float(((a - c).abs() / c.abs().clamp(min=1e-30)).max()) if a.numel() else 0.0
    plan = pamld.plan_for(n, b, w, codes.device)
    loop = pamld.tile_loop(w, codes.device)
    blocks, registers, local = loop.instances["classify" if plan.slices == 1 else "stage B"]
    moved, ops = classify_work(dec, n, w, plain)
    # one launch over one slice, else stages A, B and C; the looped
    # instance's read state one more
    expected = (1 if plan.slices == 1 else 3) + (1 if w > pamld.LOOPED_PAST else 0)
    entry = {"W": w, "B": b, "N": n, "mixed": mixed, "instance": loop.maxw, "slices": plan.slices,
             "launches": held_launches(name, launches, expected),
             "ms": ms, "plain_ms": plain_ms, "max_abs_err": err, "bytes": moved, "ops": ops,
             "registers": registers, "local_bytes": local, "blocks_per_sm": blocks,
             "flagged": float(mine["uncertain"].float().mean()), "twin_confidence_rel": twin_rel}
    entry["bound_ms"], entry["bound_by"] = bound(entry)
    say(f"[wide] {name}: two launches byte-identical; decisions bit-equal to the tile-order twin (confidence max"
        f" relative {twin_rel:.3e}, flags apart on {twin_flags} rows); vs plain {ties}, settled rows"
        f" {float(settled.float().mean()):.4%}, confidence max relative {plain_rel:.3e} (each within rel_eps(read));"
        f" flagged {entry['flagged']:.4%}{one_launch}; instance MAXW={loop.maxw} ({registers} registers, {local} B"
        f" local, {blocks} blocks/SM), {entry['launches']} launches; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA"
        f" events over 5 and 3 calls), bound {entry['bound_ms']:.4f} ms ({entry['bound_by']})")
    return entry


def wide_k8_entry(dec, instrument, codes, quals, qcfail, short, panels: int = 2) -> dict:
    """K8 at 96 positions: the WIDE_K7_PANEL panel over `panels` shards in
    one process, launched twice (identical), argmax equal to K7's on every
    row, against its plain version (apart_rows; settled rows equal) and
    its decisions bit-equal to the tile-order twin. Returns its
    extra.wide entry (the whole K8 over its shards)."""
    import torch

    from pheniqs_tpu_torch.device import tp
    from pheniqs_tpu_torch.kernels import pamld

    n, w = codes.shape
    label = f"K8 W={w} P={panels} B={dec.barcode_count} N={n}"
    shards = [tp.shard_panel(dec, rank, panels) for rank in range(panels)]
    kwargs = dict(tpq_constants=instrument.tpq_constants, want_uncertain=True, eps=instrument.tpq_analytic_eps,
                  short=short)

    def call():
        return pamld.pamld_classify_sharded(dec, shards, codes, quals, qcfail, **kwargs)

    k8, again = call(), call()
    ms, launches = counted_event_ms("pamld_panel_sharded", call, reps=5)
    for key in k8:
        if not torch.equal(k8[key], again[key]):
            raise AssertionError(f"{label}: two launches differ in {key}")
    k7 = pamld.pamld_classify(dec, codes, quals, qcfail, **kwargs)
    if not torch.equal(k8["argmax"], k7["argmax"]):
        raise AssertionError(f"{label}: argmax differs from K7's on {int((k8['argmax'] != k7['argmax']).sum())} rows")
    plain = pamld.pamld_classify_sharded(dec, shards, codes, quals, qcfail, plain=True, **kwargs)
    plain_ms = event_ms(lambda: pamld.pamld_classify_sharded(dec, shards, codes, quals, qcfail, plain=True, **kwargs),
                        reps=3)
    keys = ("decoded", "argmax", "distance", "branch", "qcfail")
    differs = torch.zeros_like(k8["uncertain"])
    for key in keys:
        differs |= k8[key] != plain[key]
    ties = apart_rows(f"{label} vs plain", dec, codes, quals, k8, plain, differs)
    settled = ~(k8["uncertain"] | plain["uncertain"])
    twin = pamld.pamld_classify_tile_order(dec, codes, quals, qcfail, want_uncertain=True,
                                           eps=instrument.tpq_analytic_eps, short=short)
    for key in keys:
        if not torch.equal(k8[key][settled], plain[key][settled]):
            raise AssertionError(f"{label}: {key} differs from the plain version's on settled rows")
        if not torch.equal(k8[key], twin[key]):
            raise AssertionError(f"{label}: {key} differs from the tile-order twin on {int((k8[key] != twin[key]).sum())}"
                                 " rows")
    moved, ops = classify_work(dec, n, w, plain)
    entry = {"W": w, "B": dec.barcode_count, "N": n, "shards": panels, "ms": ms, "plain_ms": plain_ms,
             "bytes": moved, "ops": ops, "launches": launches}
    entry["bound_ms"], entry["bound_by"] = bound(entry)
    say(f"[wide] {label}: two launches identical; argmax = K7's on every row; vs plain {ties}; decisions bit-equal to"
        f" the tile-order twin; whole K8 {ms:.4f} ms in {launches} launches, plain {plain_ms:.4f} ms (CUDA events over"
        f" 5 and 3 calls), bound"
        f" {entry['bound_ms']:.4f} ms ({entry['bound_by']})")
    return entry


def wide_checks(n: int = N_KERNEL) -> dict:
    """The wide phase's kernel checks and times at `n` reads, each row on
    its own line: K1 at WIDE_WIDTHS x WIDE_PANELS, at WIDE_ODD and with
    WIDE_MIXED barcodes holding an N, K7 at 96 x WIDE_K7_PANEL
    and K8 over two shards of it (wide_pamld_entry, wide_k8_entry); K6's
    WIDE_MDD cases timed (byte-exact: classify_pair); K3's programs past
    2048 ints staged and in place, and 2048 length columns written in
    place (lengths_blob; byte-exact: hold_unpack); K4 and K5 at
    WIDE_DECODERS (byte-exact: k4_hold, hold_pack) and K5's rows in place.
    The edge cases of each are held in the kernels phase. Each entry's
    launches are counted over its timed call and held to its plan's.
    Returns {kernel: [extra.wide entries]}."""
    import torch

    from pheniqs_tpu_torch.kernels import mdd, pack, pamld, unpack

    cuda = torch.device("cuda")
    entries = {name: [] for name in KERNELS}
    k7_case = None
    for name, b, w, mixed, dec, instrument, codes, quals, qcfail, short in wide_decoders(n):
        entries[name].append(wide_pamld_entry(dec, instrument, codes, quals, qcfail, short, mixed))
        if b > pamld.LARGE_PANEL_B:
            k7_case = (dec, instrument, codes, quals, qcfail, short)
    entries["pamld_panel_sharded"].append(wide_k8_entry(*k7_case))
    for widths, barcodes in (WIDE_MDD[0], WIDE_MDD[-1]):
        dec, codes, quals, lengths, qcfail = mdd_synthetic(widths, barcodes, n, 2, 5, 0.2, seed=barcodes,
                                                           error_rate=0.5 / sum(widths))
        short = torch.zeros(n, dtype=torch.bool, device=cuda)
        out = pamld.empty_result(n, cuda)
        pair = classify_pair(dec, None, codes, quals, lengths, qcfail, short, out)
        ms, launches = counted_device_ms("mdd_classify",
                                         lambda: mdd.mdd_classify(dec, codes, quals, lengths, qcfail, out=out))
        moved, ops = classify_work(dec, n, sum(widths), pair["plain"])
        planes = mdd.decoder_planes(dec)
        entry = {"S": len(widths), "W": sum(widths), "B": barcodes, "N": n, "ms": ms,
                 "plain_ms": pair["plain_ms"], "bytes": moved, "ops": ops, "planes": planes,
                 "batch_reads": mdd.batch_reads(sum(widths), planes),
                 "launches": held_launches(f"K6 S={len(widths)}", launches, 1)}
        entry["bound_ms"], entry["bound_by"] = bound(entry)
        entries["mdd_classify"].append(entry)
        say(f"[wide] K6 S={len(widths)} W={sum(widths)} B={barcodes} tolerance 2 qmt 5 short 20% N={n}: {pair['line']};"
            f" wide instance, {planes} planes, {entry['batch_reads']} reads a warp's batch; kernel {ms:.4f} ms (device"
            f" time over 10 calls, {launches} launch a call), plain {pair['plain_ms']:.4f} ms (one call), bound"
            f" {entry['bound_ms']:.4f} ms ({entry['bound_by']})")
    for (instrument, layout, program, blob, ccb, qcb), columns in wide_unpack_cases(n):
        planned = unpack.unpack_plan(layout, blob.shape[1])
        plan = forced_plan(layout, blob.shape[1], columns)
        label = (f"K3 program of {program.numel()} ints ({layout.token_cols} token and {layout.length_cols} length"
                 f" columns), {plan_name(plan)}{'' if plan == planned else ', forced'}")
        tokens = hold_unpack(f"{label} N={n}", instrument, layout, program, blob, ccb, qcb)
        ms, launches = counted_device_ms("unpack_tokens",
                                         lambda: unpack.unpack_tokens(instrument, layout, program, blob, ccb, qcb))
        _, plain_ms = once_ms(lambda: unpack.unpack_tokens_plain(instrument, layout, blob, ccb=ccb, qcb=qcb))
        moved = nbytes(blob, program, *(getattr(tokens, field) for field in TOKEN_FIELDS))
        entry = {"program_ints": program.numel(), "token_cols": layout.token_cols, "length_cols": layout.length_cols,
                 "plan": "columns" if columns else "block", "planned": plan == planned, "N": n, "ms": ms,
                 "plain_ms": plain_ms, "bytes": moved, "launches": held_launches(label, launches, 1)}
        entry["bound_ms"], entry["bound_by"] = bound(entry)
        entries["unpack_tokens"].append(entry)
        say(f"[wide] {label}, N={n}: byte-exact, two launches identical; kernel {ms:.4f} ms (device time over 10"
            f" calls, {launches} launch a call), plain {plain_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms (bytes)")
    from pheniqs_tpu_torch.kernels import counters

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    k4_ptxas = {instance: ptxas_report(f"phq_counters_{instance}") for instance in ("accumulate", "decoder")}
    k5_ptxas = ptxas_report("phq_pack_kernel")
    for d in WIDE_DECODERS:
        decoders = ((("pamld", 96, 16), ("mdd", 40, 8), ("naive", 0, 0)) * 22)[:d]
        instrument, arrays = k4_case(f"{d} decoders", n, decoders=decoders)
        rows, pad, forced = k4_tensors(arrays, cuda)
        k4_hold(f"K4 {d} decoders N={n}", instrument, rows, pad, forced)
        ms, launches = counted_graph_ms("counters", lambda: counters.counters(instrument, rows, pad, forced, True))
        _, args = counters.launch_arguments(instrument, rows, pad, forced, True, sms)
        entry = {"decoders": d, "N": n, "bytes": k4_bytes(instrument, n), "ms": ms,
                 "launches": held_launches(f"K4 {d} decoders", launches, len(counters.row_slices(instrument, n))),
                 "per_decoder": args["per_decoder"], "groups": args["groups"], "reads_per_block": args["tile"],
                 "shared_bytes": args["shared_bytes"],
                 "reads_a_lane": args["vec"], "ptxas": k4_ptxas["decoder" if args["per_decoder"] else "accumulate"],
                 "plain_ms": once_ms(lambda: counters.counters_plain(instrument, rows, pad, forced, True))[1],
                 "library_ms": segment_sums_ms(instrument, rows)}
        entry["bound_ms"], entry["bound_by"] = bound(entry)
        entries["counters"].append(entry)
        instrument, decisions, forced = pack_case([(a, b) for a, b, _ in decoders], n, d, cuda)
        hold_pack(f"{d} decoders N={n}", instrument, decisions, forced, True)
        plan = pack.pack_plan(instrument, True)
        ms, launches = counted_graph_ms("pack_outputs", lambda: pack.pack_outputs(instrument, decisions, forced, True))
        pentry = {"decoders": d, "N": n, "row_bytes": plan.layout["total"], "reads_per_block": plan.reads,
                  "fields": len(plan.fields), "sources": len(plan.sources), "shared_bytes": plan.block_bytes,
                  "ptxas": k5_ptxas,
                  "bytes": pack_bytes(plan, d, n, True), "ms": ms,
                  "launches": held_launches(f"K5 {d} decoders", launches, 1),
                  "plain_ms": once_ms(lambda: pack.pack_outputs_plain(instrument, decisions, forced, True))[1]}
        pentry["bound_ms"], pentry["bound_by"] = bound(pentry)
        entries["pack_outputs"].append(pentry)
        instance = "the per-decoder instance" if args["per_decoder"] else (
            f"the grouped kernel: {entry['groups']} groups, {entry['reads_per_block']} reads a block")
        say(f"[wide] {d} decoders N={n}: K4 byte-exact, two launches identical ({instance},"
            f" {entry['shared_bytes']} shared bytes), kernel"
            f" {entry['ms']:.4f} ms (device time, the replay of a CUDA graph of 10 calls), plain"
            f" {entry['plain_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms, index_add_ yardstick"
            f" {entry['library_ms']:.4f} ms; K5 ({plan.layout['total']} B a row, R = {plan.reads},"
            f" {len(plan.fields)} fields of {len(plan.sources)} sources, {plan.block_bytes} shared bytes)"
            f" byte-exact, kernel {pentry['ms']:.4f} ms (the same clock), plain {pentry['plain_ms']:.4f} ms, bound"
            f" {pentry['bound_ms']:.4f} ms")
    say(f"[wide] ptxas: K4 {json.dumps(k4_ptxas)}; K5 {json.dumps(k5_ptxas)}")
    d, m = WIDE_PACK_IN_PLACE
    instrument, decisions, forced = pack_case((("pamld", 40_000),) * d, m, d, cuda)
    hold_pack(f"{d} decoders, rows in place, N={m}", instrument, decisions, forced, True)
    plan = pack.pack_plan(instrument, True)
    if plan.staged:
        raise AssertionError(f"K5 {d} decoders: {plan.layout['total']} B rows staged")
    say(f"[wide] K5 {d} decoders ({plan.layout['total']} B a row, assembled in place), N={m}: byte-exact, two launches"
        f" identical, nothing written past the span")
    return entries


def wide_predicted(ontology, n: int = 16384) -> float:
    """The hybrid re-resolution share the bound predicts for `ontology`'s
    reads: the share of a batch of the same distribution (synthetic_batch,
    another seed) that the plain versions flag uncertain, short rows
    included."""
    import torch

    from pheniqs_tpu_torch.kernels import pamld

    instrument, observations = pamld_observations(ontology, n, seed=5)
    flagged = torch.zeros(n, dtype=torch.bool, device=observations[0][1].device)
    for dec, codes, quals, qcfail, short in observations:
        flagged |= pamld.pamld_classify_plain(dec, codes, quals, qcfail, want_uncertain=True,
                                              eps=instrument.tpq_analytic_eps, short=short)["uncertain"]
    return float(flagged.float().mean())


def fast_near_ties(label: str, ontology, n: int, threads: int) -> str:
    """The fast port (f32, no re-resolution) against the strict f64 engine
    on `n` reads of a wide flagship: every record whose cellular barcode
    (CB) differs between the two is a near tie in f64 between the two
    barcodes (pamld.tie_gaps on the read's observation, parsed from the
    FASTQ); the other differing records (a filter or the confidence
    threshold decided apart) at most WIDE_DISAGREE_LIMIT of the reads."""
    import numpy as np
    import torch

    from pheniqs_tpu_torch.benchmark import run_e2e, sam_decisions, synthesize_fastq_input
    from pheniqs_tpu_torch.device.instrument import compile_instrument
    from pheniqs_tpu_torch.iupac import encode_ascii
    from pheniqs_tpu_torch.kernels import pamld

    tag = label.replace(" ", "_").replace("=", "")
    paths = synthesize_fastq_input(os.path.join(WORK, f"fast_{tag}"), n, ontology=ontology)
    strict_sam, fast_sam = os.path.join(WORK, "wide_strict.sam"), os.path.join(WORK, "wide_fast.sam")
    run_e2e(paths, strict_sam, fidelity="strict", threads=threads, batch_size=min(16384, -(-n // threads)),
            device="cuda", ontology=ontology)
    stats = run_e2e(paths, fast_sam, fidelity="fast", threads=threads, batch_size=BATCH, device="cuda",
                    ontology=ontology)
    strict, fast = sam_decisions(strict_sam), sam_decisions(fast_sam)
    os.unlink(strict_sam)
    os.unlink(fast_sam)
    if len(strict) != n or len(fast) != n:
        raise AssertionError(f"{label} fast: record counts {len(strict)} / {len(fast)}")

    def barcode(record):
        return next((field[5:] for field in record if field.startswith("CB:Z:")), None)

    differ = [i for i in range(n) if strict[i] != fast[i]]
    apart = [i for i in differ if barcode(strict[i]) and barcode(fast[i]) and barcode(strict[i]) != barcode(fast[i])]
    other = len(differ) - len(apart)
    if other > int(n * WIDE_DISAGREE_LIMIT):
        raise AssertionError(f"{label} fast: {other} records differ other than by their cellular barcode")
    ties = "no record differs by its cellular barcode"
    if apart:
        cuda = torch.device("cuda")
        dec = compile_instrument(ontology, cuda).decoders[2]
        w = dec.width
        index = {word: k for k, word in enumerate(
            "".join("ACGT"[[1, 2, 4, 8].index(c)] for c in row) for row in dec.panel_codes_u8.cpu().numpy())}
        with open(paths[3], "rb") as stream:
            lines = stream.read().split(b"\n")
        codes = np.stack([encode_ascii(lines[4 * i + 1][:w].decode()) for i in apart]).astype(np.uint8)
        quals = np.stack([np.frombuffer(lines[4 * i + 3][:w], np.uint8) - 33 for i in apart]).astype(np.uint8)
        first = torch.tensor([index[barcode(strict[i])] for i in apart], device=cuda)
        second = torch.tensor([index[barcode(fast[i])] for i in apart], device=cuda)
        gap, window = pamld.tie_gaps(dec, torch.from_numpy(codes).to(cuda), torch.from_numpy(quals).to(cuda), first,
                                     second)
        if not bool((gap <= window).all()):
            raise AssertionError(f"{label} fast: {int((gap > window).sum())} records differ by their cellular barcode"
                                 " beyond a near tie in f64")
        ties = (f"{len(apart)} records differ by their cellular barcode, each a near tie in f64 (largest gap"
                f" {float((gap / window).max()):.3f} of the window)")
    return (f"fast against strict on {n} {label} reads: {len(differ)} records differ; {ties}; {other} otherwise (at"
            f" most {int(n * WIDE_DISAGREE_LIMIT)}); fast {stats['reads_per_s']:.0f} reads/s over {stats['wall_s']} s")


def wide_e2e(card: str, threads: int) -> dict:
    """The wide flagship (a 96-nt cellular barcode: K1's looped instance)
    through the engine: hybrid identical to strict on N_WIDE_HYBRID reads,
    its f64 re-resolution rate beside the rate the bound predicts
    (wide_predicted; RESOLVED_LIMIT does not apply: the bound flags nearly
    every confident read at this width), its kernel launches (counts set to
    0 just before the run); fast against strict on N_WIDE_FAST reads, every
    record apart a near tie (fast_near_ties); the same two on the
    WIDE_K7_PANEL variant (K7) on fewer reads; and the wide MDD instrument
    (wide_mdd_ontology: a sample barcode of 12 segments and 130 positions,
    tolerance 2, K6's wide instance) hybrid identical to strict on
    N_WIDE_MDD reads, its K6 launches counted. Returns the hybrid runs'
    launches summed."""
    from pheniqs_tpu_torch.device.flagship import wide_flagship_ontology, wide_mdd_ontology
    from pheniqs_tpu_torch.kernels import launch_counts, reset_launch_counts

    total = {name: 0 for name in KERNELS}
    runs = (("wide flagship", wide_flagship_ontology(), N_WIDE_HYBRID, N_WIDE_FAST, "wide"),
            (f"wide flagship B={WIDE_K7_PANEL}", wide_flagship_ontology(WIDE_K7_PANEL), N_WIDE_K7_HYBRID,
             N_WIDE_K7_FAST, "wide K7"),
            ("wide MDD S=12 W=130", wide_mdd_ontology(), N_WIDE_MDD, None, "wide mdd"))
    for label, ontology, n_hybrid, n_fast, path in runs:
        mdd_run = path == "wide mdd"
        predicted = None if mdd_run else wide_predicted(ontology)
        reset_launch_counts()
        stats = decisions_vs_strict(label, ontology, n_hybrid, threads, resolved_limit=RESOLVED_LIMIT if mdd_run else None)
        counts = launch_counts()
        missing = [name for name in PATH_KERNELS[path] if counts[name] <= 0]
        if missing:
            raise AssertionError(f"{label}: kernels never launched on the path: {missing}")
        rate = "" if predicted is None else f", predicted from the bound {predicted:.4%}"
        say(f"[wide] {card} | {label} hybrid: identical to strict on {n_hybrid} reads; f64 re-resolution rate"
            f" {stats['resolved_fraction']:.4%}{rate}; launches {json.dumps(counts)}")
        for name, count in counts.items():
            total[name] += count
        if n_fast is not None:
            say(f"[wide] {card} | {fast_near_ties(label, ontology, n_fast, threads)}")
    return total


def decisions_vs_strict(label: str, ontology, n: int, threads: int, fidelity: str = "hybrid", limit: int = 0,
                        keep_strict: bool = False, resolved_limit: float | None = RESOLVED_LIMIT,
                        paths: list[str] | None = None, port_sam: str | None = None, compiled: dict | None = None):
    """The port's SAM decisions against the strict f64 engine's on `n`
    reads of `ontology` (`paths`, else synthesized): hybrid identical,
    re-resolving at most `resolved_limit` of them (None: any share); fast
    (no re-resolution) differing in at most `limit` records. Both runs
    write `port_sam` (the strict one's output then moved aside), and take
    `compiled` (run_e2e's) where given. With `keep_strict`, returns (input
    paths, the strict SAM's path) and keeps that file; else the port's
    run's stats."""
    from pheniqs_tpu_torch.benchmark import run_e2e, sam_decisions, synthesize_fastq_input

    if paths is None:
        paths = synthesize_fastq_input(os.path.join(WORK, f"decisions_{label.replace(' ', '_')}"), n,
                                       ontology=ontology)
    strict_sam = os.path.join(WORK, f"strict_{label.replace(' ', '_')}.sam")
    port_sam = port_sam or os.path.join(WORK, f"{fidelity}.sam")
    # batches small enough that every strict worker classifies a share
    run_e2e(paths, port_sam, fidelity="strict", threads=threads, batch_size=min(16384, -(-n // threads)),
            device="cuda", ontology=ontology, compiled=compiled)
    os.replace(port_sam, strict_sam)
    stats = run_e2e(paths, port_sam, fidelity=fidelity, threads=threads, batch_size=BATCH, device="cuda",
                    ontology=ontology, compiled=compiled)
    strict_decisions = sam_decisions(strict_sam)
    port_decisions = sam_decisions(port_sam)
    if len(strict_decisions) != n or len(port_decisions) != n:
        raise AssertionError(f"{label}: record counts {len(strict_decisions)} / {len(port_decisions)}")
    mismatches = sum(1 for a, b in zip(strict_decisions, port_decisions) if a != b)
    if mismatches > limit:
        raise AssertionError(f"{label}: {mismatches} {fidelity} decisions differ from strict (at most {limit})")
    resolved = stats.get("resolved_fraction", 0.0)
    if resolved_limit is not None and resolved > resolved_limit:
        raise AssertionError(f"{label}: f64 re-resolution rate {resolved} above {resolved_limit}")
    say(f"[decisions] {fidelity} port against strict on {n} {label} reads: {mismatches} records differ"
        f" (at most {limit}); f64 re-resolution rate {resolved:.4%};"
        f" classified fraction {stats['classified_fraction']}")
    os.unlink(port_sam)
    if keep_strict:
        return paths, strict_sam
    os.unlink(strict_sam)
    return stats


def throughput(card: str, threads: int, whitelist: Whitelist) -> tuple[dict, list]:
    """The e2e run of each single-card path, its launch counts read with
    the counts set to 0 just before it. Returns every kernel's launches
    summed over the runs, and the flagship run's FASTQ paths."""
    from pheniqs_tpu_torch.benchmark import run_e2e, synthesize_fastq_input
    from pheniqs_tpu_torch.device.flagship import flagship_ontology, mdd_flagship_ontology
    from pheniqs_tpu_torch.kernels import launch_counts, reset_launch_counts

    runs = [
        ("flagship", flagship_ontology(), N_THROUGHPUT, "hybrid"),
        ("mdd", mdd_flagship_ontology(), N_MDD_THROUGHPUT, "hybrid"),
        ("whitelist", whitelist.ontology, N_WHITELIST_THROUGHPUT, "fast"),
    ]
    total = {name: 0 for name in KERNELS}
    inputs = {}
    for path, ontology, n, fidelity in runs:
        start = time.perf_counter()
        compiled = None
        if path == "whitelist":
            paths, out, compiled = whitelist.inputs(n), whitelist.output, whitelist.compiled
        else:
            paths = synthesize_fastq_input(os.path.join(WORK, f"throughput_{path}"), n, ontology=ontology)
            out = os.path.join(WORK, "throughput.sam")
        inputs[path] = paths
        reset_launch_counts()
        stats = run_e2e(paths, out, fidelity=fidelity, threads=threads, batch_size=BATCH, device="cuda",
                        ontology=ontology, compiled=compiled)
        counts = launch_counts()
        os.unlink(out)
        say(f"[throughput] {card} | {path} {fidelity} e2e {json.dumps(stats)}")
        say(f"[throughput] {card} | {path} kernel launches in the e2e run {json.dumps(counts)}"
            f" (the whole phase {time.perf_counter() - start:.1f} s)")
        missing = [name for name in PATH_KERNELS[path] if counts[name] <= 0]
        if missing:
            raise AssertionError(f"{path}: kernels never launched on the path: {missing}")
        if (
            stats["reads"] != n
            or stats["classified_fraction"] < 0.8
            or stats.get("resolved_fraction", 0.0) > RESOLVED_LIMIT
        ):
            raise AssertionError(f"{path} e2e output off: {stats}")
        for name, count in counts.items():
            total[name] += count
    return total, inputs["flagship"]


TP_RANK = r"""
import json, os, pickle, sys, time

import torch

sys.path.insert(0, sys.argv[1])
from pheniqs_tpu_torch.benchmark import run_e2e
from pheniqs_tpu_torch.device import tp
from pheniqs_tpu_torch.device.flagship import flagship_ontology, whitelist_flagship_ontology
from pheniqs_tpu_torch.kernels import launch_counts, reset_launch_counts

paths, out, threads, cellular, batch, fidelity, report, record, instruction = json.loads(sys.argv[2])
ontology = whitelist_flagship_ontology() if cellular == "whitelist" else flagship_ontology(cellular_barcodes=cellular)
kept = {"signature": [], "wire": [], "blob": [], "batch_s": []}
compiled = None
if int(os.environ["RANK"]) == 0:
    if instruction is not None:
        with open(instruction, "rb") as stream:
            compiled = pickle.load(stream)
    # rank 0 times each batch from its dispatch to its decisions on the
    # host, and keeps its wire rows and decision rows
    from pheniqs_tpu_torch.engine.device import TorchDeviceEngine

    dispatch, classify = TorchDeviceEngine._dispatch, TorchDeviceEngine._classify_batch_on_device
    started = []

    def kept_dispatch(self, batch, packed=None):
        started.append(time.perf_counter())
        kept["signature"].append(packed[0])
        kept["wire"].append(torch.from_numpy(packed[1].copy()))
        return dispatch(self, batch, packed)

    def kept_classify(self, batch):
        handles = self._predispatched
        results = classify(self, batch)
        kept["batch_s"].append(time.perf_counter() - started[len(kept["blob"])])
        kept["blob"].append(handles[0].clone())
        return results

    TorchDeviceEngine._dispatch, TorchDeviceEngine._classify_batch_on_device = kept_dispatch, kept_classify
    if record:
        # and the instrument it compiled, which it shares with the grid
        import dataclasses

        share = tp.share_instrument

        def kept_share(instrument, group):
            kept["instrument"] = dataclasses.replace(
                instrument, decoders=[dataclasses.replace(dec, spec=None) for dec in instrument.decoders])
            return share(instrument, group)

        tp.share_instrument = kept_share
reset_launch_counts()
stats = run_e2e(paths, out, fidelity=fidelity, threads=threads, batch_size=batch, device="cuda", ontology=ontology,
                report_url=report, compiled=compiled)
counts = launch_counts()
if record:
    torch.save(kept, record)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "pheniqs_tpu"))
print(json.dumps({"rank": int(os.environ["RANK"]), "stats": stats, "counts": counts, "loaded": loaded,
                  "collective_s": tp.collective_seconds, "header_s": tp.header_seconds, "batch_s": kept["batch_s"]}))
"""


def tp_role(rank: int, panel: int) -> str:
    """A grid rank's role in PATH_KERNELS: rank 0, another row's leader
    (column 0), or a panel follower."""
    return "tp leader" if rank == 0 else "tp row leader" if rank % panel == 0 else "tp follower"


def rank_run(shape: str, paths, out: str, threads: int, cellular=K7_PANEL, fidelity: str = "hybrid",
             nccl: bool = False, report: str | None = None, record: str | None = None,
             instruction: str | None = None) -> tuple[list, float]:
    """run_e2e on every rank of PHENIQS_TP=`shape` (threshold TP_THRESHOLD),
    one process a rank, on the flagship with a `cellular`-barcode panel or
    the whitelist flagship: the ranks share the first card (gloo) or, with
    `nccl`, each has its own. The rendezvous store is held here on a port
    bound once (TORCHELASTIC_USE_AGENT_STORE, as torchrun's agent holds
    it), and every rank still running is killed when one fails. Each rank
    sets its launch counts to 0 just before its run. Rank 0 writes
    `report`, times each batch from its dispatch to its decisions on the
    host, and with `record` keeps each batch's wire rows and decision rows
    there, and the instrument it compiled (on the CPU); with `instruction`,
    a pickled compiled instruction, rank 0 runs it (run_e2e's `compiled`).
    Returns each rank's line (its group line added) and the seconds of the
    ranks' processes."""
    import torch

    reads, panel = (int(x) for x in shape.split(":"))
    ranks = reads * panel
    store = torch.distributed.TCPStore("localhost", 0, world_size=ranks, is_master=True, wait_for_workers=False)
    argument = json.dumps([paths, out, threads, cellular, BATCH, fidelity, report, record, instruction])
    env = dict(os.environ, PHENIQS_TP=shape, PHENIQS_TP_THRESHOLD=str(TP_THRESHOLD), WORLD_SIZE=str(ranks),
               LOCAL_WORLD_SIZE=str(ranks), MASTER_ADDR="localhost", MASTER_PORT=str(store.port),
               TORCHELASTIC_USE_AGENT_STORE="True")
    if not nccl:
        first = os.environ.get("CUDA_VISIBLE_DEVICES", str(torch.cuda.current_device())).split(",")[0]
        env["CUDA_VISIBLE_DEVICES"] = first
    start = time.perf_counter()
    logs = [(open(os.path.join(WORK, f"rank{rank}.out"), "w+"), open(os.path.join(WORK, f"rank{rank}.err"), "w+"))
            for rank in range(ranks)]
    procs = [
        subprocess.Popen([sys.executable, "-c", TP_RANK, HERE, argument],
                         env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)), stdout=stdout, stderr=stderr, text=True)
        for rank, (stdout, stderr) in enumerate(logs)
    ]
    deadline = time.monotonic() + 900
    try:
        while any(proc.poll() is None for proc in procs):
            if any(proc.returncode for proc in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        del store
    seconds = time.perf_counter() - start
    lines = []
    for rank, (proc, (stdout, stderr)) in enumerate(zip(procs, logs)):
        stdout.seek(0)
        stderr.seek(0)
        text, errors = stdout.read(), stderr.read()
        stdout.close()
        stderr.close()
        if proc.returncode != 0:
            raise AssertionError(f"PHENIQS_TP={shape} rank {rank} exited {proc.returncode}:\n{errors[-4000:]}")
        line = json.loads(text.strip().splitlines()[-1])
        line["group"] = next(row for row in errors.splitlines() if "PHENIQS_TP rank" in row).strip()
        lines.append(line)
    return lines, seconds


def tp_launches(card: str, shape: str, lines: list) -> dict:
    """Each rank's launches against its role's kernels (PATH_KERNELS), no
    module of JAX loaded on any rank; prints each rank's launches and
    collective seconds. Returns the launches summed over the ranks."""
    panel = int(shape.split(":")[1])
    total = {name: 0 for name in KERNELS}
    for line in lines:
        missing = [name for name in PATH_KERNELS[tp_role(line["rank"], panel)] if line["counts"][name] <= 0]
        if missing or line["loaded"]:
            raise AssertionError(f"PHENIQS_TP={shape} rank {line['rank']} ({tp_role(line['rank'], panel)}): kernels"
                                 f" never launched {missing}; loaded {line['loaded']}")
        for name, count in line["counts"].items():
            total[name] += count
        say(f"[tp] {card} | {line['group']} ({tp_role(line['rank'], panel)}): launches {json.dumps(line['counts'])};"
            f" {line['collective_s']:.3f} s in the grid's collectives, {line['header_s']:.3f} s waiting on batch"
            " headers")
    return total


def tp_run(card: str, paths, strict_sam: str, threads: int, shape: str = "1:2", nccl: bool = False,
           report: str | None = None) -> dict:
    """PHENIQS_TP=`shape` through run_e2e (rank_run), hybrid on the
    K7_PANEL variant's reads with its panel sharded (TP_THRESHOLD): rank
    0's SAM must equal `strict_sam`'s decisions, and each rank launch its
    role's kernels. Returns the launches summed over the ranks."""
    from pheniqs_tpu_torch.benchmark import sam_decisions

    out = os.path.join(WORK, "tp.sam")
    lines, seconds = rank_run(shape, paths, out, threads, nccl=nccl, report=report)
    mode = "NCCL, a card per rank" if nccl else "gloo, ranks sharing one card"
    strict = sam_decisions(strict_sam)
    mismatches = sum(1 for a, b in zip(strict, sam_decisions(out)) if a != b)
    os.unlink(out)
    leader = lines[0]["stats"]
    if leader["reads"] != len(strict) or mismatches:
        raise AssertionError(f"PHENIQS_TP={shape} ({mode}): {mismatches} records differ from strict; {leader}")
    total = tp_launches(card, shape, lines)
    say(f"[tp] {card} | PHENIQS_TP={shape} ({mode}), threshold {TP_THRESHOLD}, B={K7_PANEL}: hybrid identical"
        f" to strict on {len(strict)} reads; K8 launches per rank"
        f" {[line['counts']['pamld_panel_sharded'] for line in lines]}; rank 0 batch seconds {lines[0]['batch_s']};"
        f" rank 0 e2e {json.dumps(leader)}; {seconds:.1f} s for the ranks' processes")
    return total


#: the grid phase's whitelist reads: two batches
N_GRID_WHITELIST = 2 * BATCH


def grid_vs_one_row(label: str, record: str, reads: int, panel: int) -> dict:
    """The decision rows of a PHENIQS_TP=R:P run, kept in `record` with its
    rank 0's instrument, against the 1:P decode of the same batches: one
    DecodeStep on the card holding all P shards of each sharded panel,
    whose merge reduces the same stacked partials in the same shard order
    as the 1:P ranks' (tests/test_torch_tp.py holds the two byte-equal).
    Byte-equal where every row's K1/K8 plans (at N / R reads) are the 1:P
    decode's (at N), else held by blob_apart (decoded indices bit-equal,
    qcfail apart only where the two confidences straddle the threshold
    within EDGE_ULPS ulps). Returns the rows apart, the plans and the 1:P
    step's seconds a batch in this process (host clock around a
    synchronized call, after one call to warm up)."""
    import dataclasses

    import torch

    from pheniqs_tpu_torch.device.instrument import analytic_tpq_epsilon, instruments_on
    from pheniqs_tpu_torch.device.step import DecodeStep
    from pheniqs_tpu_torch.device.tp import shard_panel, sharded_positions

    kept = torch.load(record, weights_only=False)
    card = torch.device("cuda", torch.cuda.current_device())
    instrument = instruments_on(kept["instrument"], [card])[0]
    instrument = dataclasses.replace(instrument, tpq_analytic_eps=analytic_tpq_epsilon(card))
    shards = {k: [shard_panel(instrument.decoders[k], column, panel) for column in range(panel)]
              for k in sharded_positions(instrument, TP_THRESHOLD)}
    apart, plans, seconds = [], [], []
    for k, (signature, wire_rows) in enumerate(zip(kept["signature"], kept["wire"])):
        n, widths, qual_bits = signature
        pair = {"grid": pamld_plans(instrument, n // reads, panel), "one row": pamld_plans(instrument, n, panel)}
        plans.append({key: {str(d): v for d, v in value.items()} for key, value in pair.items()})
        step = DecodeStep(instrument, list(widths), qual_bits, want_uncertain=False, panel_shards=shards)
        rows = wire_rows.to(card)
        with torch.no_grad():
            if k == 0:
                step(rows)
            torch.cuda.synchronize()
            start = time.perf_counter()
            theirs, _ = step(rows)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - start)
            tokens = step.run_to("unpack", rows)
        mine = kept["blob"][k].to(card)
        if pair["grid"] == pair["one row"]:
            if not torch.equal(mine, theirs):
                raise AssertionError(f"{label}: batch {k}'s decision rows differ from 1:{panel}'s under the same plans")
            apart.append(0)
        else:
            apart.append(blob_apart(f"{label} batch {k}", instrument, step, tokens, mine, theirs,
                                    want_uncertain=False))
    return {"rows_apart": apart, "plans": plans, "one_row_step_s": seconds}


def grid(card: str, threads: int, whitelist: Whitelist, tp_paths, tp_strict: str, one_row_report: str,
         nccl: bool = False) -> dict:
    """The (reads, panel) grid: PHENIQS_TP=2:2 as four processes sharing
    the first card (gloo; with `nccl`, a card each), hybrid on the
    K7_PANEL variant's reads, identical to strict, each rank launching its
    role's kernels, the report that of the 1:2 run (`one_row_report`:
    integers exact, floats within rtol 1e-6); then the whitelist fast on
    N_GRID_WHITELIST reads at 2:2, held batch by batch to the 1:2 decode
    of the same batches (grid_vs_one_row), with rank 0's batch seconds and
    each rank's collective seconds. Returns the launches summed over the
    ranks of every run."""
    from pheniqs_tpu_torch.benchmark import sam_decisions

    start = time.perf_counter()
    report = os.path.join(WORK, "grid_report.json")
    total = tp_run(card, tp_paths, tp_strict, threads, shape="2:2", nccl=nccl, report=report)
    with open(report) as mine, open(one_row_report) as theirs:
        report_apart("PHENIQS_TP=2:2", json.load(mine), json.load(theirs))
    say(f"[grid] {card} | PHENIQS_TP=2:2 report equal to 1:2's (integers exact, floats within rtol 1e-6)")
    if nccl:
        return total
    paths, out, record = whitelist.inputs(N_GRID_WHITELIST), whitelist.output, os.path.join(WORK, "grid.pt")
    lines, seconds = rank_run("2:2", paths, out, threads, cellular="whitelist", fidelity="fast", record=record,
                              instruction=whitelist.instruction)
    records = sam_decisions(out)
    os.unlink(out)
    for name, count in tp_launches(card, "2:2", lines).items():
        total[name] += count
    leader = lines[0]
    if leader["stats"]["reads"] != N_GRID_WHITELIST or len(records) != N_GRID_WHITELIST:
        raise AssertionError(f"whitelist at PHENIQS_TP=2:2: {len(records)} records; {leader['stats']}")
    say(f"[grid] {card} | whitelist fast PHENIQS_TP=2:2: rank 0 batch seconds (dispatch to decisions on the"
        f" host) {leader['batch_s']}; collective seconds by rank {[round(line['collective_s'], 3) for line in lines]},"
        f" header seconds by rank {[round(line['header_s'], 3) for line in lines]}; rank 0 e2e"
        f" {json.dumps(leader['stats'])}; {seconds:.1f} s for the ranks' processes")
    held = grid_vs_one_row("whitelist PHENIQS_TP=2:2", record, 2, 2)
    os.unlink(record)
    say(f"[grid] {card} | whitelist fast 2:2 against the 1:2 decode of the same {N_GRID_WHITELIST} reads:"
        f" {json.dumps(held)}; the phase took {time.perf_counter() - start:.1f} s")
    return total


#: reads of the two-pass prior workflow
N_PRIOR = 50_000


def prior_workflow(card: str, threads: int) -> dict:
    """The two-pass PAMLD workflow on the card: pass 1 a hybrid flagship run
    that writes its report; the port's tools/prior folds the report's
    estimated noise and concentrations into the configuration; pass 2
    hybrid on the adjusted configuration (its concentrations no longer
    uniform) identical to strict on it. Returns the launches of pass 2
    (counts set to 0 just before it)."""
    import contextlib
    import io

    from pheniqs_tpu_torch.benchmark import instruction, run_e2e, sam_decisions, synthesize_fastq_input
    from pheniqs_tpu_torch.device.flagship import flagship_ontology
    from pheniqs_tpu_torch.kernels import launch_counts, reset_launch_counts
    from pheniqs_tpu_torch.tools import prior

    start = time.perf_counter()
    ontology = flagship_ontology()
    paths = synthesize_fastq_input(os.path.join(WORK, "prior"), N_PRIOR, ontology=ontology)
    report, configuration = os.path.join(WORK, "prior_report.json"), os.path.join(WORK, "prior_job.json")
    out = os.path.join(WORK, "prior.sam")
    run_e2e(paths, out, fidelity="hybrid", threads=threads, batch_size=BATCH, device="cuda", ontology=ontology,
            report_url=report)
    with open(configuration, "w") as stream:
        json.dump(instruction(paths, "/dev/null", ontology), stream)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        if prior.main(["--configuration", configuration, "--report", report]) != 0:
            raise AssertionError("tools/prior did not exit 0")
    adjusted = json.loads(printed.getvalue())
    concentrations = {  # distinct values a decoder (cellular is a list of decoders)
        kind: [len({barcode["concentration"] for barcode in decoder["codec"].values()})
               for decoder in (adjusted[kind] if isinstance(adjusted[kind], list) else [adjusted[kind]])]
        for kind in ("sample", "cellular")
    }
    if min(min(counts) for counts in concentrations.values()) < 2:
        raise AssertionError(f"prior: the adjusted concentrations are uniform {concentrations}")
    strict_out = os.path.join(WORK, "prior_strict.sam")
    run_e2e(paths, strict_out, fidelity="strict", threads=threads, batch_size=min(16384, -(-N_PRIOR // threads)),
            device="cuda", ontology=adjusted)
    reset_launch_counts()
    stats = run_e2e(paths, out, fidelity="hybrid", threads=threads, batch_size=BATCH, device="cuda",
                    ontology=adjusted)
    counts = launch_counts()
    strict = sam_decisions(strict_out)
    mismatches = sum(1 for a, b in zip(strict, sam_decisions(out)) if a != b)
    os.unlink(out)
    os.unlink(strict_out)
    missing = [name for name in PATH_KERNELS["flagship"] if counts[name] <= 0]
    if len(strict) != N_PRIOR or mismatches or missing:
        raise AssertionError(f"prior pass 2: {mismatches} records differ from strict; kernels never launched"
                             f" {missing}; {stats}")
    say(f"[prior] {card} | pass 1 hybrid wrote its report; tools/prior adjusted noise"
        f" {adjusted['sample']['noise']} (sample), distinct concentrations {json.dumps(concentrations)}; pass 2"
        f" hybrid identical to strict on {N_PRIOR} reads, launches {json.dumps(counts)};"
        f" {time.perf_counter() - start:.1f} s")
    return counts


def tools(card: str, threads: int, flagship_paths) -> None:
    """The port's measurement tools (pheniqs_tpu_torch/tools/) on the card:
    host_pipeline's three rungs over the throughput phase's flagship FASTQ;
    profile_step's ladder (its command) on the flagship at N_KERNEL with its
    batch-size sweep and on the MDD flagship at N_KERNEL, each full rung held
    byte for byte to a DecodeStep built apart (the tool exits non-zero
    otherwise); and
    panel_memory at PANEL_SIZES, the growth of memory_allocated while each
    panel is built held to its resident_bytes within the allocator's
    rounding (panel_memory.allocator_slack), the bytes requested exactly."""
    import math

    import numpy as np
    import torch

    from pheniqs_tpu_torch.tools import host_pipeline, panel_memory, profile_step

    rows = []
    out = os.path.join(WORK, "host_pipeline.sam")
    for row in host_pipeline.ladder(flagship_paths, out, threads, BATCH, "cuda"):
        say(f"[tools] {card} | host_pipeline {json.dumps(row)}")
        if row["reads"] != N_THROUGHPUT or not row["reads_per_s"] > 0:
            raise AssertionError(f"host_pipeline {row['stage']}: {row}")
        rows.append(row)
    os.unlink(out)
    say(f"[tools] {card} | {json.dumps(host_pipeline.ceiling(rows))}")

    for instrument, sweep in (("flagship", profile_step.SWEEP), ("mdd", ())):
        # in a process of its own, as a user runs it: in this one, after the
        # e2e phases, torch.profiler dropped device events (an unpack rung
        # of 0 launches, the full step at 0.21 ms of device time, not 0.35)
        command = [sys.executable, "-m", "pheniqs_tpu_torch.tools.profile_step", "--instrument", instrument,
                   "--batch", str(N_KERNEL), "--sweep", ",".join(map(str, sweep)), "--device", "cuda"]
        result = subprocess.run(command, cwd=HERE, capture_output=True, text=True, timeout=900)
        if result.returncode != 0:
            raise AssertionError(f"{' '.join(command[1:])} exited {result.returncode}:\n{result.stderr[-4000:]}")
        rows = [json.loads(line) for line in result.stdout.splitlines()]
        if [(row["variant"], row["batch"]) for row in rows] != [
            *((name, N_KERNEL) for name in profile_step.RUNGS), *(("full", n) for n in sweep if n != N_KERNEL)
        ]:
            raise AssertionError(f"profile_step {instrument}: rows {rows}")
        for row in rows:
            say(f"[tools] {card} | profile_step {json.dumps(row)}")
            timed = (row["latency_ms"], row["pipelined_ms"], row["device_ms"])
            if not all(math.isfinite(t) and t > 0 for t in timed) or row["launches"] <= 0:
                raise AssertionError(f"profile_step {instrument} {row['variant']} N={row['batch']}: {row}")
    say(f"[tools] {card} | profile_step: every full rung (flagship at {N_KERNEL} and the sweep"
        f" {list(profile_step.SWEEP)}, MDD flagship at {N_KERNEL}) the same blob and counter bytes as"
        " DecodeStep.forward on the same buffers")

    rng = np.random.default_rng(3)
    for b in PANEL_SIZES:
        row = panel_memory.measure(b, 16, N_KERNEL, 3, torch.device("cuda"), rng)
        say(f"[tools] {card} | panel_memory {json.dumps(row)}")
        over = row["allocated_growth"] - row["resident_bytes"]
        slack = panel_memory.allocator_slack(row["resident"])
        requested = row["requested_growth"]
        if not 0 <= over < slack or requested not in (None, row["resident_bytes"]):
            raise AssertionError(f"panel_memory B={b}: memory_allocated grew {row['allocated_growth']} B"
                                 f" (requested {requested}) while the panel was built, resident_bytes"
                                 f" {row['resident_bytes']} (slack {slack} B)")
        if not row["latency_s"] > 0 or row["decoded_fraction"] < 0.5:
            raise AssertionError(f"panel_memory B={b}: {row}")
        say(f"[tools] {card} | panel_memory B={b}: memory_allocated grew {row['allocated_growth']} B while the"
            f" panel was built, resident_bytes {row['resident_bytes']} (requested {requested} B; allowed over:"
            f" {slack} B of the allocator's rounding)")


#: reads of the reads phase's e2e rate runs (hybrid flagship at R = 1 and 2)
N_READS_E2E = 1_000_000
#: batches of the whitelist fast e2e rate over several cards: past the
#: cold start, a steady window of a dozen batches
MULTI_CARD_BATCHES = 16


def reads_axis() -> list[str]:
    """The reads phase's two slices: one on each of two cards where there
    are two, else both on the first card (two streams)."""
    import torch

    return ["cuda:0", "cuda:1"] if torch.cuda.device_count() >= 2 else ["cuda:0", "cuda:0"]


def pamld_plans(instrument, n: int, panel: int = 1) -> dict:
    """{decoder position: slices of the tile loop's plan} of each PAMLD
    decoder at `n` reads on the instrument's card (kernels/pamld.py:
    plan_for); with `panel` > 1, a panel past TP_THRESHOLD over its shard of
    ceil(B / panel) barcodes, as K8 plans it."""
    from pheniqs_tpu_torch.device.tp import shard_width
    from pheniqs_tpu_torch.kernels import pamld

    plans = {}
    for k, dec in enumerate(instrument.decoders):
        if dec.algorithm == "pamld" and dec.plans:
            b = shard_width(dec.barcode_count, panel) if dec.barcode_count > TP_THRESHOLD else dec.barcode_count
            plans[k] = pamld.plan_for(n, b, sum(dec.segment_widths), instrument.device).slices
    return plans


def blob_apart(label: str, instrument, step, tokens, mine, theirs, want_uncertain: bool = True) -> int:
    """The decision blob of the slices (`mine`) against the one-card one
    (`theirs`) where a slice's K1/K7 plan differs from the one-card plan
    (the rule of pamld.against_one_launch, row by row): decoded indices
    bit-equal on every row; each PAMLD confidence within 2*gamma(B+2) + 8u
    relative; qcfail bits and the uncertain byte apart only on rows where
    some PAMLD decoder's two confidences straddle ct or an edge of its
    uncertain margin, widened by EDGE_ULPS ulps. Without `want_uncertain`
    (a fast blob) there is no uncertain byte, and only ct is an edge.
    Returns the rows apart."""
    import torch

    from pheniqs_tpu_torch.device import wire
    from pheniqs_tpu_torch.kernels import pamld

    layout = wire.d2h_layout(instrument, want_uncertain)
    a, b = mine.view(-1, layout["total"]), theirs.view(-1, layout["total"])
    ints = slice(0, layout["int_bytes"])
    if not torch.equal(a[:, ints], b[:, ints]):
        raise AssertionError(f"{label}: decoded indices of the slices differ from one card's")
    floats = slice(layout["float_offset"], layout["float_offset"] + layout["float_bytes"])
    conf_a = a[:, floats].contiguous().view(torch.float32).double()
    conf_b = b[:, floats].contiguous().view(torch.float32).double()
    qc = slice(layout["qcfail_offset"], layout["qcfail_offset"] + layout["qcfail_bytes"])
    differs = (a[:, qc] != b[:, qc]).any(dim=1)
    if want_uncertain:
        u = layout["uncertain_offset"]
        differs |= a[:, u] != b[:, u]
    at_edge = torch.zeros_like(differs)
    column = {k: c for c, k in enumerate(layout["confidence_positions"])}
    slot = 0
    for k, dec in enumerate(instrument.decoders):
        if dec.algorithm not in ("pamld", "mdd") or not dec.plans:
            continue
        _, quals, _, _ = tokens.observation(step.layout, slot)
        slot += 1
        if dec.algorithm != "pamld":
            continue
        x, y = conf_a[:, column[k]], conf_b[:, column[k]]
        relative = float(((x - y).abs() / torch.maximum(x.abs(), y.abs()).clamp(min=1e-300)).max())
        tolerance = 2.0 * pamld.gamma(dec.barcode_count + 2) + 8.0 * pamld.U32
        if relative > tolerance:
            raise AssertionError(f"{label}: decoder {k} confidences {relative:.3e} apart (at most {tolerance:.3e})")
        ct = dec.confidence_threshold
        rel_eps, _ = pamld._uncertain_margins(dec, quals.shape[1], instrument.tpq_analytic_eps,
                                              quals.sum(dim=1).to(torch.float32))
        rel_eps = rel_eps.double()
        edges = torch.stack([torch.full_like(x, ct), ct - (rel_eps * ct + 4.0 * pamld.U32),
                             (ct + 4.0 * pamld.U32) / (1.0 - rel_eps)])
        if not want_uncertain:
            edges = edges[:1]
        ulps = pamld.EDGE_ULPS * pamld.U32 * max(ct, 1e-30)
        at_edge |= ((edges >= torch.minimum(x, y) - ulps) & (edges <= torch.maximum(x, y) + ulps)).any(dim=0)
    unexplained = int((differs & ~at_edge).sum())
    if unexplained:
        raise AssertionError(f"{label}: qcfail/uncertain of the slices differ from one card's on {unexplained} rows"
                             f" not within {pamld.EDGE_ULPS} ulps of ct or its margin")
    return int(differs.sum())


def sharded_vs_one_card(label: str, ontology, n: int, devices, seed: int, instrument=None, panels=None,
                        launches: bool = True) -> dict:
    """ShardedDecodeStep over `devices` against the one-card DecodeStep on
    the same j4 blob of `n` reads on the first card: the decision blob byte
    for byte where every slice's K1/K7 plan is the one-card plan, else held
    as blob_apart says; the counters' integer columns exact (on a blob
    with rows apart, each column within that many rows), the confidence
    sums within rtol 1e-5 (plus the rows apart). With `launches`, each
    slice's kernel launches (the wrappers' counts), which are the
    one-card step's plus two for each PAMLD decoder a slice runs sliced
    and one card in one launch. Returns the report."""
    import numpy as np
    import torch

    from pheniqs_tpu_torch.device import wire
    from pheniqs_tpu_torch.device.instrument import compile_instrument, instruments_on
    from pheniqs_tpu_torch.device.step import DecodeStep, ShardedDecodeStep, pad_rows
    from pheniqs_tpu_torch.kernels import launch_counts

    first = torch.device(devices[0])
    if instrument is None:
        instrument = compile_instrument(ontology, first)
    widths, blob_np, ccb_np, qcb_np = flagship_blob(ontology, instrument, n, seed, panels=panels)
    blob, ccb, qcb = (torch.from_numpy(x).to(first) for x in (blob_np, ccb_np, qcb_np))
    one = DecodeStep(instrument, widths, wire.JOINT4, want_uncertain=True)
    sharded = ShardedDecodeStep(instruments_on(instrument, devices), widths, wire.JOINT4, want_uncertain=True)
    with torch.no_grad():
        want_blob, want_flat = one(blob, ccb, qcb)
        got_blob, got_flat = sharded(blob, ccb, qcb)
        tokens = one.run_to("unpack", blob, ccb, qcb)
    padded = pad_rows(blob, sharded.size)
    share = padded.shape[0] // sharded.size
    plans = {"one card": pamld_plans(instrument, n), "each slice": pamld_plans(instrument, share)}
    same = plans["one card"] == plans["each slice"]
    if same:
        if not torch.equal(got_blob, want_blob):
            raise AssertionError(f"{label}: the slices' decision blob differs from one card's under the same plans")
        apart = 0
    else:
        apart = blob_apart(label, instrument, one, tokens, got_blob, want_blob)
    mine, theirs = got_flat.cpu().numpy(), want_flat.cpu().numpy().astype(np.float64)
    offset = 0
    for _, name, size in wire.counter_layout(instrument):
        x, y = mine[offset : offset + size], theirs[offset : offset + size]
        offset += size
        if name in ("accumulated_confidence", "accumulated_pf_confidence"):
            if not (np.abs(x - y) <= 1e-5 * np.abs(y) + apart).all():
                raise AssertionError(f"{label}: counter {name} of the slices off one card's beyond rtol 1e-5")
        elif not (np.abs(x - y) <= apart).all():
            raise AssertionError(f"{label}: counter {name} of the slices differs from one card's"
                                 f" ({apart} rows apart)")
    report = {"devices": [str(torch.device(d)) for d in devices], "reads": n, "slice_reads": share,
              "plans": {key: {str(k): v for k, v in value.items()} for key, value in plans.items()},
              "blob": "byte-equal" if same else f"held by plan, {apart} rows apart", "counters": "held"}
    if launches:
        # counted by the kernels' wrappers, not torch.profiler, which drops
        # device events in this process after the e2e phases (ROADMAP C.3)
        def counted(fn) -> int:
            before = sum(launch_counts().values())
            fn()
            return sum(launch_counts().values()) - before

        report["one_card_kernel_launches"] = counted(lambda: one(blob, ccb, qcb))
        per_card = []
        for r, (start, stop) in enumerate(sharded.bounds(padded.shape[0])):
            device = sharded.devices[r]
            piece = padded[start:stop].to(device)
            books = [t.to(device) for t in (ccb, qcb)]
            with sharded.on(r):
                per_card.append(counted(lambda: sharded.steps[r](piece, *books)))
        expected = report["one_card_kernel_launches"] + sum(
            2 * ((plans["each slice"][k] > 1) - (plans["one card"][k] > 1)) for k in plans["one card"]
        )
        if any(count != expected for count in per_card):
            raise AssertionError(f"{label}: kernel launches a slice {per_card}, expected {expected}"
                                 f" (one card {report['one_card_kernel_launches']}, plans {plans})")
        report["slice_kernel_launches"] = per_card
    return report


def report_apart(label: str, mine, theirs, where: str = ""):
    """Raise unless two reports agree: every integer equal, every float
    within rtol 1e-6 (the slices' counter vectors add in float64 before
    the accumulators: tests/test_torch_distributed.py's rule)."""
    if type(mine) is not type(theirs):
        raise AssertionError(f"{label}: report{where} is {type(mine).__name__}, one card's {type(theirs).__name__}")
    if isinstance(mine, dict):
        if set(mine) != set(theirs):
            raise AssertionError(f"{label}: report{where} keys {sorted(set(mine) ^ set(theirs))} differ")
        for key in mine:
            report_apart(label, mine[key], theirs[key], f"{where}/{key}")
    elif isinstance(mine, list):
        if len(mine) != len(theirs):
            raise AssertionError(f"{label}: report{where} has {len(mine)} entries, one card's {len(theirs)}")
        for k, (a, b) in enumerate(zip(mine, theirs)):
            report_apart(label, a, b, f"{where}[{k}]")
    elif isinstance(mine, float):
        if not abs(mine - theirs) <= 1e-6 * abs(theirs):
            raise AssertionError(f"{label}: report{where} {mine!r} off one card's {theirs!r} beyond rtol 1e-6")
    elif mine != theirs:
        raise AssertionError(f"{label}: report{where} {mine!r}, one card's {theirs!r}")


def reads(card: str, threads: int, whitelist: Whitelist, decided) -> dict:
    """The reads phase: ShardedDecodeStep (two slices, reads_axis) against
    the one-card step at N_KERNEL on the flagship, the MDD flagship and
    the whitelist, each slice's plans and kernel launches beside one
    card's (the flagship's one card: 5, 9 device launches); the engine
    over two slices, hybrid on `decided` (input paths and strict SAM of
    flagship reads) identical to strict; hybrid on N_READS_E2E flagship
    reads at R = 1 and R = 2 (and, over two cards, fast too): the same
    records and the same report (integers exact, floats within rtol
    1e-6), their rates side by side; multichip_bench's device-step line
    at R = 1 and R = 2; over two or more cards, multi_card_rates. Returns
    the kernel launches of the engine runs (counts set to 0 before
    each)."""
    import torch

    from pheniqs_tpu_torch.benchmark import run_e2e, sam_decisions, synthesize_fastq_input
    from pheniqs_tpu_torch.device.flagship import flagship_ontology, mdd_flagship_ontology
    from pheniqs_tpu_torch.kernels import launch_counts, reset_launch_counts
    from pheniqs_tpu_torch.tools import multichip_bench

    devices = reads_axis()
    for label, ontology, extra in (
        ("flagship", flagship_ontology(), {}),
        ("mdd flagship", mdd_flagship_ontology(), {}),
        ("whitelist flagship", whitelist.ontology, {"instrument": whitelist.instrument, "panels": whitelist.panels}),
    ):
        report = sharded_vs_one_card(label, ontology, N_KERNEL, devices, seed=77, **extra)
        if label == "flagship" and report["one_card_kernel_launches"] != 5:
            raise AssertionError(f"flagship: {report['one_card_kernel_launches']} kernel launches a batch on one"
                                 " card, not 5 (K3, K1 x2, K4, K5: 9 device launches with the memsets)")
        say(f"[reads] {card} | {label} ShardedDecodeStep against one card {json.dumps(report)}")

    total = {name: 0 for name in KERNELS}
    paths, strict_sam = decided
    out = os.path.join(WORK, "reads.sam")
    reset_launch_counts()
    stats = run_e2e(paths, out, fidelity="hybrid", threads=threads, batch_size=BATCH, device="cuda",
                    devices=devices)
    counts = launch_counts()
    strict = sam_decisions(strict_sam)
    mismatches = sum(1 for x, y in zip(strict, sam_decisions(out)) if x != y)
    if stats["devices"] != 2 or stats["reads"] != len(strict) or mismatches:
        raise AssertionError(f"reads: hybrid over {devices}: {mismatches} records differ from strict; {stats}")
    missing = [name for name in PATH_KERNELS["flagship"] if counts[name] <= 0]
    if missing:
        raise AssertionError(f"reads: kernels never launched over two slices: {missing}")
    for name, count in counts.items():
        total[name] += count
    say(f"[reads] {card} | hybrid over {devices} identical to strict on {len(strict)} flagship reads;"
        f" launches {json.dumps(counts)}")

    paths = synthesize_fastq_input(os.path.join(WORK, "reads_flagship"), N_READS_E2E, ontology=flagship_ontology())
    fidelities = ("hybrid", "fast") if devices[0] != devices[1] else ("hybrid",)
    for fidelity in fidelities:
        records, reports = {}, {}
        for axis in (devices[:1], devices):
            report_url = os.path.join(WORK, "reads_report.json")
            reset_launch_counts()
            stats = run_e2e(paths, out, fidelity=fidelity, threads=threads, batch_size=BATCH, device="cuda",
                            devices=axis, report_url=report_url)
            counts = launch_counts()
            records[len(axis)] = sam_decisions(out)
            with open(report_url) as stream:
                reports[len(axis)] = json.load(stream)
            for name, count in counts.items():
                total[name] += count
            if stats["reads"] != N_READS_E2E or stats.get("resolved_fraction", 0.0) > RESOLVED_LIMIT:
                raise AssertionError(f"reads: {fidelity} at R = {len(axis)} off: {stats}")
            say(f"[reads] {card} | flagship {fidelity} e2e at R = {len(axis)} over {axis}: wall"
                f" {stats['reads_per_s']} reads/s, steady {stats.get('steady_reads_per_s')} reads/s"
                f" {json.dumps(stats)}; launches {json.dumps(counts)}")
        differ = sum(1 for x, y in zip(records[1], records[2]) if x != y)
        if differ or len(records[1]) != len(records[2]):
            raise AssertionError(f"reads: {differ} {fidelity} records at R = 2 differ from R = 1's")
        report_apart(f"reads: {fidelity} at R = 2", reports[2], reports[1])
        say(f"[reads] {card} | {fidelity} records at R = 2 over {devices} identical to R = 1 on {N_READS_E2E}"
            " reads; the report's integers equal, its floats within rtol 1e-6")
    os.unlink(out)

    for count in (1, 2):
        row = multichip_bench.run_device_step(count, N_KERNEL, reps=20)
        if row["n_devices"] != count or not row["step_ms_median"] > 0:
            raise AssertionError(f"multichip_bench --device-step at R = {count}: {row}")
        say(f"[reads] {card} | multichip_bench {json.dumps(row)}")
    if torch.cuda.device_count() >= 2:
        multi_card_rates(card, threads)
    return total


def multi_card_rates(card: str, threads: int):
    """On a host with two or more cards: multichip_bench's device step on
    the whitelist (K7 over R cards, N_KERNEL reads from pinned host rows
    to pinned host buffers, as the engine runs it; 3 calls) and its e2e
    line for the whitelist fast, MULTI_CARD_BATCHES batches of BATCH
    reads, each at R = 1 and R = 2 (and 4 where there are four cards):
    the rate of the device-bound path over several cards."""
    import torch

    from pheniqs_tpu_torch.tools import multichip_bench

    cards = torch.cuda.device_count()
    for count in (1, 2, 4) if cards >= 4 else (1, 2):
        row = multichip_bench.run_device_step(count, N_KERNEL, reps=3, path="whitelist")
        if row["n_devices"] != count or row["round_robin"] or not row["step_ms_median"] > 0:
            raise AssertionError(f"multichip_bench --device-step whitelist at R = {count}: {row}")
        say(f"[reads] {card} | multichip_bench {json.dumps(row)}")
    reads = MULTI_CARD_BATCHES * BATCH
    for count in (1, 2, 4) if cards >= 4 else (1, 2):
        row = multichip_bench.run_bench(reads=reads, batch_size=BATCH, threads=threads, fidelity="fast",
                                        bench_dir=WORK, devices=count, path="whitelist")
        if row["devices_per_host"] != count or row["reads"] != reads:
            raise AssertionError(f"multichip_bench whitelist fast at R = {count}: {row}")
        say(f"[reads] {card} | multichip_bench {json.dumps(row)}")


def standalone_check():
    """The port stands alone: after every phase, sys.modules holds no jax
    and no module of the JAX package."""
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "pheniqs_tpu"))
    if loaded:
        raise AssertionError(f"the port imported {loaded}")
    port = sum(1 for m in sys.modules if m.split(".")[0] == "pheniqs_tpu_torch")
    say(f"[standalone] sys.modules holds no jax and no pheniqs_tpu module ({port} modules of pheniqs_tpu_torch)")


def nccl_only(card: str, threads: int) -> int:
    """--nccl: on a host with two or more cards, the PHENIQS_TP runs over
    NCCL (1:2; 1:4 and the 2:2 grid, its report against 1:2's, where there
    are four cards) against their strict reference, then the reads phase over cuda:0 and cuda:1 (reads: the
    three instruments' ShardedDecodeStep against one card, the engine
    against strict and R = 2 against R = 1, multi_card_rates), and nothing
    else."""
    import torch

    from pheniqs_tpu_torch.device.flagship import flagship_ontology

    cards = torch.cuda.device_count()
    if cards < 2:
        raise SystemExit(f"chip_smoke --nccl: needs two cards, this host has {cards}")
    paths, strict_sam = decisions_vs_strict(f"B={K7_PANEL} flagship", flagship_ontology(cellular_barcodes=K7_PANEL),
                                            N_K7_DECISIONS, threads, keep_strict=True)
    one_row_report = os.path.join(WORK, "tp_report.json")
    tp_run(card, paths, strict_sam, threads, nccl=True, report=one_row_report)
    if cards >= 4:
        tp_run(card, paths, strict_sam, threads, shape="1:4", nccl=True)
        grid(card, threads, None, paths, strict_sam, one_row_report, nccl=True)
    decided = decisions_vs_strict("flagship", flagship_ontology(), N_K7_DECISIONS, threads, keep_strict=True)
    reads(card, threads, Whitelist(), decided)
    return 0


#: batch sizes of the plan's one-launch-or-slices sweep (slice_rule_times):
#: the CLI's default batch (16384), the TP phase's 20,000 reads, and
#: 0.24-1.94 waves of the one-launch instance's 528 slots (4 blocks/SM)
RULE_READS = (16384, 20000, 32768, 65536, 98304, 131072, 196608, 262144)
#: batch sizes at which a K8 shard of 2048 barcodes (PHENIQS_TP=1:2 over a
#: 4096-barcode panel) is timed as planned and in whole tiles
RULE_SHARD_READS = (16384, 20000)


def slice_rule_times(takes_plan: bool) -> dict:
    """What the tile loop's plan chooses between on a panel of one tile, as
    the package imported from the tree plans it, device time of one call
    (every launch it makes): K1 on the flagship's 96- and 384-barcode
    panels at each batch size of RULE_READS (`plan`) and, where the tree
    takes a plan (`takes_plan`: _classify_launches' `plan`), forced to one
    launch (`one`) and to the slices below a tile (`sliced`,
    pamld.sliced_plan); and one shard of 2048 barcodes of a 4096-barcode
    cellular panel (K8 stages A and B and the shard's merge, as
    PHENIQS_TP=1:2 runs it) at RULE_SHARD_READS, as planned and, where the
    tree cuts below a tile, in whole tiles (one slice, the plan before the
    unit). Returns {"K1 B=b N=n plan|one|sliced": ms, "K8 2048 N=n
    plan|whole": ms}."""
    import dataclasses

    from pheniqs_tpu_torch.device import tp
    from pheniqs_tpu_torch.device.flagship import flagship_ontology
    from pheniqs_tpu_torch.kernels import pamld

    times = {}
    instrument, observations = pamld_observations(flagship_ontology(), max(RULE_READS), seed=16384)
    for dec, codes, quals, qcfail, short in observations:
        b = dec.barcode_count
        for n in RULE_READS:
            args = (dec, codes[:n], quals[:n], qcfail[:n], short[:n], instrument.tpq_constants, True,
                    instrument.tpq_analytic_eps, None)
            times[f"K1 B={b} N={n} plan"] = device_ms(lambda: pamld._classify_launches(*args))
            if takes_plan:
                sliced = pamld.sliced_plan(n, b, codes.shape[1], codes.device)
                times[f"K1 B={b} N={n} one"] = device_ms(
                    lambda: pamld._classify_launches(*args, plan=dataclasses.replace(sliced, slices=1)))
                times[f"K1 B={b} N={n} sliced"] = device_ms(lambda: pamld._classify_launches(*args, plan=sliced))
                say(f"[times] K1 B={b} N={n}: as planned {times[f'K1 B={b} N={n} plan']:.4f} ms"
                    f" ({pamld.plan_for(n, b, codes.shape[1], codes.device).slices} slices), one launch"
                    f" {times[f'K1 B={b} N={n} one']:.4f} ms, {sliced.slices} slices of {sliced.cut} barcodes"
                    f" {times[f'K1 B={b} N={n} sliced']:.4f} ms")
    instrument, observations = pamld_observations(flagship_ontology(cellular_barcodes=K7_PANEL),
                                                  max(RULE_SHARD_READS), seed=K7_PANEL)
    dec, codes, quals, qcfail, short = observations[1]
    shard = [tp.shard_panel(dec, 0, 2)]
    kwargs = dict(tpq_constants=instrument.tpq_constants, want_uncertain=True, eps=instrument.tpq_analytic_eps)
    planned = pamld.plan_for
    for n in RULE_SHARD_READS:
        def call():
            return pamld.pamld_classify_sharded(dec, shard, codes[:n], quals[:n], None, finish=False,
                                                short=short[:n], **kwargs)

        times[f"K8 {shard[0].count} N={n} plan"] = device_ms(call)
        if takes_plan:
            loop = pamld.tile_loop(codes.shape[1], codes.device)
            # the plan before the unit: slices of whole tiles only
            pamld.plan_for = lambda n, barcodes, w, device: pamld.slice_plan(
                n, barcodes, loop.tile, loop.reads_per_block, loop.slots, loop.tile)
            try:
                times[f"K8 {shard[0].count} N={n} whole"] = device_ms(call)
            finally:
                pamld.plan_for = planned
            say(f"[times] K8 shard of {shard[0].count} N={n}: as planned"
                f" ({planned(n, shard[0].count, codes.shape[1], codes.device).slices} slices)"
                f" {times[f'K8 {shard[0].count} N={n} plan']:.4f} ms, whole tiles (1 slice)"
                f" {times[f'K8 {shard[0].count} N={n} whole']:.4f} ms")
    return times


def variant_library(source: str, define: str | None = None, swap: tuple[str, str] | None = None):
    """A diagnostic copy of one kernel source of the imported tree, built
    alone and loaded (argtypes as the package's): with `define` set, or
    with the text `swap[0]` replaced by `swap[1]` (a copy written into
    WORK); None where the source has no such macro or text (another
    commit)."""
    return variant_libraries({define or swap[0]: (source, define, swap)})[define or swap[0]]


def variant_libraries(variants: dict) -> dict:
    """variant_library for each of `variants` (name -> (source, define,
    swap)), their nvcc processes started together. Returns name ->
    library or None."""
    import ctypes
    import hashlib

    from pheniqs_tpu_torch.kernels import build

    os.makedirs(WORK, exist_ok=True)
    builds = {}
    for name, (source, define, swap) in variants.items():
        path = build.CSRC / source
        text = path.read_text()
        if (define.split("=")[0] if define else swap[0]) not in text:
            builds[name] = None
            continue
        stem = hashlib.sha256(f"{source} {define} {swap}".encode()).hexdigest()[:12]
        flags = [f"-D{define}"] if define else []
        if swap:
            path = os.path.join(WORK, f"{stem}.cu")
            with open(path, "w") as stream:
                stream.write(text.replace(swap[0], swap[1], 1))
        target = os.path.join(WORK, f"{stem}.so")
        builds[name] = (target, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, *flags, f"-I{build.CSRC}", "-shared", "-o", target, str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libraries = {}
    for name, started in builds.items():
        if started is None:
            libraries[name] = None
            continue
        target, process = started
        output, _ = process.communicate()
        if process.returncode != 0:
            raise RuntimeError(f"variant {name} did not build:\n{output[-4000:]}")
        lib = ctypes.CDLL(target)
        for entry, argtypes in build.SIGNATURES.items():
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = list(argtypes)
                getattr(lib, entry).restype = ctypes.c_int
        libraries[name] = lib
    return libraries


@contextlib.contextmanager
def kernels_from(lib):
    """The wrappers launch from `lib` (a variant_library) inside the
    block: kernels.build.library swapped for it."""
    from pheniqs_tpu_torch.kernels import build

    library = build.library
    build.library = lambda: lib
    try:
        yield
    finally:
        build.library = library


def step_rows(ontology, instrument, n: int, seed: int, panels=None):
    """The decision rows the decode step of `instrument` hands K4 and K5
    on a j4 batch of `n` reads (flagship_blob): K3, then each decoder's
    classify kernel, chained as the step chains them. Returns (Decisions,
    tokens)."""
    import torch

    from pheniqs_tpu_torch.device import wire
    from pheniqs_tpu_torch.device.step import DecodeStep
    from pheniqs_tpu_torch.kernels import Decisions, mdd, pamld, unpack

    cuda = torch.device("cuda")
    widths, *arrays = flagship_blob(ontology, instrument, n, seed=seed, panels=panels)
    blob, ccb, qcb = (torch.from_numpy(x).to(cuda) for x in arrays)
    layout = DecodeStep(instrument, widths, wire.JOINT4, want_uncertain=True).layout
    program = torch.from_numpy(layout.program).to(cuda)
    tokens = unpack.unpack_tokens(instrument, layout, program, blob, ccb, qcb)
    decisions = Decisions.zeros(len(instrument.decoders), n, cuda)
    qcfail = tokens.qcfail
    slot = 0
    for k, dec in enumerate(instrument.decoders):
        row = decisions.row(k)
        if dec.algorithm in ("pamld", "mdd") and dec.plans:
            codes, quals, lengths, short_rows = tokens.observation(layout, slot)
            slot += 1
            if dec.algorithm == "mdd":
                mdd.mdd_classify(dec, codes, quals, lengths, qcfail, out=row)
            else:
                pamld.pamld_classify(dec, codes, quals, qcfail, tpq_constants=instrument.tpq_constants,
                                     want_uncertain=True, eps=instrument.tpq_analytic_eps, short=short_rows, out=row)
        else:
            row["qcfail"].copy_(qcfail)
        qcfail = row["qcfail"]
    return decisions, tokens


def wide_times() -> dict:
    """--times' wide K1/K7/K8 rows at N_KERNEL reads of the wide phase's
    inputs (the same ontologies and seeds), CUDA events over 5 calls of
    every launch a call makes (the looped instance's state launch too),
    and each call's device time by kernel (kernel_breakdown): K1 at each
    (W, B) of WIDE_TIMED as planned and, where the tree takes a plan,
    forced to one launch (`one`) and to the slices (`sliced`,
    pamld.sliced_plan); K7 at 96 x WIDE_K7_PANEL and K8 over two shards of
    that panel in one process (its merges included)."""
    import dataclasses
    import inspect

    from pheniqs_tpu_torch.device import tp
    from pheniqs_tpu_torch.kernels import pamld

    times = {}
    for w, b in WIDE_TIMED + ((96, WIDE_K7_PANEL),):
        instrument, observations = pamld_observations(wide_ontology(b, w), N_KERNEL, seed=w + b)
        dec, codes, quals, qcfail, short = observations[1]
        kwargs = dict(tpq_constants=instrument.tpq_constants, want_uncertain=True, eps=instrument.tpq_analytic_eps,
                      short=short)
        label = f"K{7 if b > pamld.LARGE_PANEL_B else 1} W={w} B={b}"
        calls = {label: lambda: pamld.pamld_classify(dec, codes, quals, qcfail, **kwargs)}
        if b <= pamld.LARGE_PANEL_B and "plan" in inspect.signature(pamld._classify_launches).parameters:
            args = (dec, codes, quals, qcfail, short, instrument.tpq_constants, True, instrument.tpq_analytic_eps,
                    None)
            sliced = pamld.sliced_plan(N_KERNEL, b, w, codes.device)
            calls[f"{label} one"] = lambda: pamld._classify_launches(*args, plan=dataclasses.replace(sliced, slices=1))
            calls[f"{label} sliced"] = lambda: pamld._classify_launches(*args, plan=sliced)
            say(f"[times] {label}: as planned {pamld.plan_for(N_KERNEL, b, w, codes.device).slices} slices;"
                f" sliced {sliced.slices} slices of {sliced.cut} barcodes")
        if b > pamld.LARGE_PANEL_B:
            shards = [tp.shard_panel(dec, rank, 2) for rank in range(2)]
            calls[f"K8 W={w} B={b} P=2"] = lambda: pamld.pamld_classify_sharded(dec, shards, codes, quals, qcfail,
                                                                                **kwargs)
        for label, call in calls.items():
            times[label] = event_ms(call, reps=5)
            times[f"{label} by kernel"] = kernel_breakdown(call, reps=3)
            say(f"[times] {label} N={N_KERNEL}: {times[label]:.4f} ms; by kernel"
                f" {json.dumps(times[f'{label} by kernel'])}")
    return times


def unpack_mdd_times() -> dict:
    """--times' K3, K6, K4 and K5 readings, device time of one call: K3 on
    the flagship's and the MDD flagship's j4 blobs and K6 on the MDD
    flagship and on its tolerance-2, qmt-20, 10 %-short variant, each at
    N_KERNEL and 16384 reads; where the tree has them, K3 without its token
    stores (PHQ_UNPACK_NO_TOKEN_STORES) and K6 without its scan
    (PHQ_MDD_NO_SCAN: the key-table phase alone), built as diagnostic
    copies; K4 and K5 on the flagship step's rows at N_KERNEL; and K5 and
    its bound on random rows of the flagship's, the MDD flagship's, the fast
    whitelist's and a 9-decoder layout at N_KERNEL and of the flagship's at
    16384."""
    import torch

    from pheniqs_tpu_torch.device import wire
    from pheniqs_tpu_torch.device.flagship import flagship_ontology, mdd_flagship_ontology
    from pheniqs_tpu_torch.device.instrument import compile_instrument
    from pheniqs_tpu_torch.device.step import DecodeStep
    from pheniqs_tpu_torch.kernels import mdd, pack, pamld, unpack
    from pheniqs_tpu_torch.kernels.counters import counters

    cuda = torch.device("cuda")
    stream = torch.cuda.current_stream(cuda).cuda_stream
    no_stores = variant_library("unpack_tokens.cu", "PHQ_UNPACK_NO_TOKEN_STORES")
    no_scan = variant_library("mdd.cu", "PHQ_MDD_NO_SCAN")
    tolerant = mdd_flagship_ontology()
    tolerant["sample"]["distance tolerance"] = [2, 2]
    tolerant["sample"]["quality masking threshold"] = 20
    times = {}
    for label, ontology, short in (("flagship", flagship_ontology(), 0.0), ("mdd flagship", mdd_flagship_ontology(), 0.0),
                                   ("mdd tolerance 2", tolerant, 0.1)):
        instrument = compile_instrument(ontology, cuda)
        for n in (N_KERNEL, 16384):
            widths, *arrays = flagship_blob(ontology, instrument, n, seed=96, short=short)
            blob, ccb, qcb = (torch.from_numpy(x).to(cuda) for x in arrays)
            layout = DecodeStep(instrument, widths, wire.JOINT4, want_uncertain=True).layout
            program = torch.from_numpy(layout.program).to(cuda)
            if short == 0.0:
                times[f"K3 {label} N={n}"] = device_ms(
                    lambda: unpack.unpack_tokens(instrument, layout, program, blob, ccb, qcb))
                if no_stores is not None:
                    times[f"K3 {label} N={n} without token stores"] = device_ms(
                        lambda: unpack._launch(no_stores, layout, program, blob, ccb, qcb, stream))
            tokens = unpack.unpack_tokens(instrument, layout, program, blob, ccb, qcb)
            dec = instrument.decoders[0]
            if dec.algorithm == "mdd":
                codes, quals, lengths, _ = tokens.observation(layout, 0)
                out = pamld.empty_result(n, cuda)
                times[f"K6 {label} N={n}"] = device_ms(
                    lambda: mdd.mdd_classify(dec, codes, quals, lengths, tokens.qcfail, out=out))
                if no_scan is not None:
                    times[f"K6 {label} N={n} key table alone"] = device_ms(
                        lambda: mdd._launch(no_scan, dec, codes, quals, lengths, tokens.qcfail, out, stream))
            if label == "flagship" and n == N_KERNEL:
                decisions, tokens = step_rows(ontology, instrument, n, seed=96)
                times["K4 flagship"] = device_ms(
                    lambda: counters(instrument, decisions, tokens.pad, tokens.forced, True))
                times["K5 flagship"] = device_ms(
                    lambda: pack.pack_outputs(instrument, decisions, tokens.forced, True))
    # K5 on the layouts of the other paths, on 9 decoders and at the CLI's
    # batch, on random rows (its work does not depend on the values), with
    # its bound where the tree has a plan
    for label, layout, n in (("flagship", 0, N_KERNEL), ("MDD flagship", 2, N_KERNEL), ("whitelist fast", 3, N_KERNEL),
                             ("9 decoders", 6, N_KERNEL), ("flagship", 0, 16384)):
        _, decoders, hybrid = PACK_LAYOUTS[layout]
        instrument, decisions, forced = pack_case(decoders, n, seed=layout, device=cuda)
        times[f"K5 {label} N={n} random rows"] = device_ms(
            lambda: pack.pack_outputs(instrument, decisions, forced, hybrid))
        if hasattr(pack, "pack_plan"):
            plan = pack.pack_plan(instrument, hybrid)
            times[f"K5 {label} N={n} bound"] = bound({"bytes": pack_bytes(plan, len(decoders), n, hybrid)})[0]
    for key, value in times.items():
        say(f"[times] {key}: {value:.4f} ms")
    shutil.rmtree(WORK, ignore_errors=True)
    return times


#: --times' sections, in the order they run (kernel_times)
TIME_SECTIONS = ("pamld", "steps", "whitelist", "wide", "unpack_mdd", "wide_unpack_mdd", "rules", "epilogue")

#: --times' K4 decoders beside WIDE_DECODERS' (epilogue_times)
EPILOGUE_K4 = {
    "flagship": K4_FLAGSHIP,
    "mdd flagship": (("mdd", 96, 16), ("pamld", 384, 16), ("naive", 0, 0)),
    "whitelist": (("pamld", 96, 16), ("pamld", 737_280, 16), ("naive", 0, 0)),
}
#: --times' K5 layouts (PACK_LAYOUTS' positions): the three paths' and
#: WIDE_DECODERS'
EPILOGUE_K5 = {"flagship": 0, "MDD flagship": 2, "whitelist fast": 3, "33 decoders": 8, "64 decoders": 9}
#: --times' decoder counts where K4 runs under both instances, each on two
#: patterns of decoders whose histograms all fit SHARED_LIMIT
EPILOGUE_INSTANCES = (3, 4, 6, 8, 9, 12, 16, 24, 33)
EPILOGUE_PATTERNS = {"flagship decoders": K4_FLAGSHIP,
                     "wide decoders": (("pamld", 96, 16), ("mdd", 40, 8), ("naive", 0, 0))}
#: --times' probes: diagnostic copies of K4's and K5's sources, each with
#: one part taken out or one setting changed (variant_libraries' swaps)
EPILOGUE_PROBES = {
    "K4 without flush": ("counters.cu", None, ("  for (int d = first; d < stop; ++d) {\n    const int* entry",
                                                "  for (int d = stop; d < stop; ++d) {\n    const int* entry")),
    "K4 flags only": ("counters.cu", None, ("for (int c = t / 32; c < (stop - first) * chunks;",
                                             "for (int c = t / 32; c < 0;")),
    "K4 4 blocks an SM": ("counters.cu", None, ("#define PHQ_COUNTER_BLOCKS_PER_SM 3",
                                                 "#define PHQ_COUNTER_BLOCKS_PER_SM 4")),
    "K5 without fields": ("pack.cu", None, ("  if (n_fields > warps) {\n    int4* copy",
                                             "  n_fields = 0;\n  if (n_fields > warps) {\n    int4* copy")),
    "K5 4 rows at a time": ("pack.cu", None, ("#define PHQ_PACK_ROWS 8", "#define PHQ_PACK_ROWS 4")),
}


def epilogue_times() -> dict:
    """--times' K4 and K5 rows at N_KERNEL reads by device time alone
    (graph_ms: CUDA events around 3 replays of a CUDA graph of 10 calls)
    and by torch.profiler (device_ms), each beside its bound: K4 on the
    flagship's, the MDD flagship's and the whitelist's decoders (737,281
    bins) and at WIDE_DECODERS (k4_case rows), K4 and K5 on the whitelist
    step's own rows (step_rows: K7's decisions on a batch of its panel) in
    hybrid and in fast mode, and K5 on random rows of EPILOGUE_K5's layouts
    (pack_case). On a tree whose K4 takes a plan (counters.CounterPlan):
    K4 under both instances at EPILOGUE_INSTANCES decoders of each of
    EPILOGUE_PATTERNS, the grouped kernel where the plan is per-decoder,
    at 1, 2 and 4 blocks an SM (counters.WAVES) and built as
    EPILOGUE_PROBES' copies, and K5 as its probes and at 128 reads a
    block (pack.MAX_BLOCK_READS); each probe as it stands: the rows it
    leaves are not held."""
    import dataclasses

    import torch

    from pheniqs_tpu_torch.kernels import counters, pack
    from pheniqs_tpu_torch.tools.profile_step import graph_ms

    cuda = torch.device("cuda")
    times = {}
    planned = hasattr(counters, "CounterPlan")
    probes = variant_libraries(EPILOGUE_PROBES) if planned else {}
    k4 = dict(EPILOGUE_K4, **{f"{d} decoders": ((("pamld", 96, 16), ("mdd", 40, 8), ("naive", 0, 0)) * 22)[:d]
                               for d in WIDE_DECODERS})
    for label, decoders in k4.items():
        instrument, arrays = k4_case(label, N_KERNEL, decoders=decoders)
        rows, pad, forced = k4_tensors(arrays, cuda)

        def call(**kwargs):
            return counters._launch(instrument, rows, pad, forced, True, **kwargs)

        times[f"K4 {label}"] = graph_ms(call)[0]
        times[f"K4 {label} profiler"] = device_ms(call)
        times[f"K4 {label} bound"] = bound({"bytes": k4_bytes(instrument, N_KERNEL)})[0]
        if not planned:
            continue
        plan = counters.counter_plan(instrument)
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        times[f"K4 {label} plan"] = {"groups": len(plan.groups), "tile": plan.tile(N_KERNEL, sms),
                                     "per_decoder": plan.per_decoder}
        grouped = dataclasses.replace(plan, per_decoder=False)
        if plan.per_decoder:
            times[f"K4 {label} grouped"] = graph_ms(lambda: call(plan=grouped))[0]
        waves = counters.WAVES
        try:
            for blocks in (1, 2, 4):
                counters.WAVES = blocks
                times[f"K4 {label} grouped, waves {blocks}"] = graph_ms(lambda: call(plan=grouped))[0]
            for name in ("K4 without flush", "K4 flags only", "K4 4 blocks an SM"):
                counters.WAVES = 4 if name == "K4 4 blocks an SM" else waves
                with kernels_from(probes[name]):
                    times[f"{name}, {label}"] = graph_ms(lambda: call(plan=grouped))[0]
        finally:
            counters.WAVES = waves
    if planned:
        for pattern, unit in EPILOGUE_PATTERNS.items():
            for d in EPILOGUE_INSTANCES:
                instrument, arrays = k4_case(pattern, N_KERNEL, decoders=(unit * 11)[:d])
                rows, pad, forced = k4_tensors(arrays, cuda)
                plan = counters.counter_plan(instrument)
                for per_decoder in (True, False):
                    other = dataclasses.replace(plan, per_decoder=per_decoder)
                    times[f"K4 {d} {pattern} {'per-decoder' if per_decoder else 'grouped'}"] = graph_ms(
                        lambda: counters._launch(instrument, rows, pad, forced, True, plan=other))[0]
                times[f"K4 {d} {pattern} planned"] = "per-decoder" if plan.per_decoder else "grouped"
    whitelist = Whitelist()
    decisions, tokens = step_rows(whitelist.ontology, whitelist.instrument, N_KERNEL, seed=737,
                                  panels=whitelist.panels)
    for mode, hybrid in (("hybrid", True), ("fast", False)):
        def counted():
            return counters.counters(whitelist.instrument, decisions, tokens.pad, tokens.forced, hybrid)

        def packed():
            return pack.pack_outputs(whitelist.instrument, decisions, tokens.forced, hybrid)

        times[f"K4 whitelist step rows, {mode}"] = graph_ms(counted)[0]
        times[f"K4 whitelist step rows, {mode}, profiler"] = device_ms(counted)
        times[f"K5 whitelist step rows, {mode}"] = graph_ms(packed)[0]
    valid = ~tokens.pad & ~counters.uncertain_any(whitelist.instrument, decisions, tokens.forced, True)
    times["whitelist step rows, valid share in hybrid"] = f"{float(valid.float().mean()):.6f}"
    for label, layout in EPILOGUE_K5.items():
        _, decoders, hybrid = PACK_LAYOUTS[layout]
        instrument, decisions, forced = pack_case(decoders, N_KERNEL, seed=layout, device=cuda)
        plan = pack.pack_plan(instrument, hybrid)

        def call():
            return pack.pack_outputs(instrument, decisions, forced, hybrid)

        times[f"K5 {label}"] = graph_ms(call)[0]
        times[f"K5 {label} profiler"] = device_ms(call)
        times[f"K5 {label} bound"] = bound({"bytes": pack_bytes(plan, len(decoders), N_KERNEL, hybrid)})[0]
        if not planned:
            continue
        for name in ("K5 without fields", "K5 4 rows at a time"):
            with kernels_from(probes[name]):
                times[f"{name}, {label}"] = graph_ms(call)[0]
        reads = pack.MAX_BLOCK_READS
        try:
            pack.MAX_BLOCK_READS = 128
            half, _, _ = pack_case(decoders, N_KERNEL, seed=layout, device=cuda)
            times[f"K5 {label} 128 reads a block"] = graph_ms(lambda: pack.pack_outputs(half, decisions, forced,
                                                                                      hybrid))[0]
        finally:
            pack.MAX_BLOCK_READS = reads
    for key, value in times.items():
        say(f"[times] {key}: {value if isinstance(value, (dict, str)) else f'{value:.4f} ms'}")
    shutil.rmtree(WORK, ignore_errors=True)
    return times


def wide_unpack_mdd_times() -> dict:
    """--times' K3 and K6 rows past the block plan and past 64 positions,
    at N_KERNEL reads of the wide phase's inputs (the same helpers and
    seeds): K3 on each program of
    WIDE_PROGRAM_PLANS and on the 2048 length columns of lengths_blob as
    the tree plans them and, where the tree has a column plan, under the
    column plan and (where it stages the layout whole) the block plan;
    K6 at the wide phase's two rows (WIDE_MDD's first and last: S = 9,
    W = 80 and S = 12, W = 130; tolerance 2, qmt 5, 20 % short); device
    time over 10 calls (device_ms)."""
    import torch

    from pheniqs_tpu_torch.kernels import mdd, pamld, unpack

    cuda = torch.device("cuda")
    times = {}
    cases = [(program_blob(N_KERNEL, count), "program") for count in WIDE_PROGRAM_PLANS]
    for (instrument, layout, program, blob, ccb, qcb), kind in cases + [(lengths_blob(N_KERNEL), "lengths")]:
        label = f"K3 {program.numel()} ints" + (f" {layout.length_cols} length columns" if kind == "lengths" else "")

        def call():
            return unpack.unpack_tokens(instrument, layout, program, blob, ccb, qcb)

        times[label] = device_ms(call)
        if hasattr(unpack, "column_plan"):
            times[f"{label} planned"] = plan_name(unpack.unpack_plan(layout, blob.shape[1]))
            for columns in (False, True):
                if columns or unpack.block_plan(layout, blob.shape[1]).shared_bytes <= unpack.SHARED_BYTES:
                    forced_plan(layout, blob.shape[1], columns)
                    times[f"{label} {'column' if columns else 'block'} plan"] = device_ms(call)
            layout.block_plans.clear()
    for widths, barcodes in (WIDE_MDD[0], WIDE_MDD[-1]):
        dec, codes, quals, lengths, qcfail = mdd_synthetic(widths, barcodes, N_KERNEL, 2, 5, 0.2, seed=barcodes,
                                                           error_rate=0.5 / sum(widths))
        out = pamld.empty_result(N_KERNEL, cuda)
        times[f"K6 S={len(widths)} W={sum(widths)} B={barcodes}"] = device_ms(
            lambda: mdd.mdd_classify(dec, codes, quals, lengths, qcfail, out=out))
    for key, value in times.items():
        say(f"[times] {key}: {value if isinstance(value, str) else f'{value:.4f} ms'}")
    return times


def kernel_times(card: str, tree: str, sections=TIME_SECTIONS):
    """--times: with the package imported from `tree`, at N_KERNEL reads,
    the device time of one pamld_classify call (every launch it makes) on
    the flagship's 96- and 384-barcode panels (K1), on a 1024-barcode
    cellular panel (K1) and on a K7_PANEL one (K7); the flagship's and the
    MDD flagship's whole decode step and its device launches a batch; and,
    one call each with CUDA events,
    K7 and K8 at P = 2 and 4 on a synthetic panel of the whitelist's size
    (random codes from a seed); the wide K1/K7/K8 rows (wide_times); K3,
    K6, K4 and K5 (unpack_mdd_times); the
    plan's choice on panels of one tile (slice_rule_times); and, where the
    tree takes a plan, K1's slice unit (slice_cut_sweep); K3's and K6's
    rows past the block plan and past 64 positions
    (wide_unpack_mdd_times). The steps are also timed with CUDA events over 10
    and, three times, over 200 back-to-back calls: their launches, not the
    card, bound them. `sections` (of TIME_SECTIONS) picks what runs. Two
    trees are compared in one call (parent, change, change, parent). One
    JSON line."""
    import dataclasses
    import inspect

    import numpy as np
    import torch

    from pheniqs_tpu_torch.device import tp, wire
    from pheniqs_tpu_torch.device.flagship import flagship_ontology, mdd_flagship_ontology
    from pheniqs_tpu_torch.device.instrument import LARGE_PANEL_B, _panel_matrices, compile_instrument
    from pheniqs_tpu_torch.device.step import DecodeStep
    from pheniqs_tpu_torch.kernels import pamld

    times = {}
    for cellular in (384, LARGE_PANEL_B, K7_PANEL) if "pamld" in sections else ():
        instrument, observations = pamld_observations(flagship_ontology(cellular_barcodes=cellular), N_KERNEL,
                                                      seed=cellular)
        for dec, codes, quals, qcfail, short in observations:
            if f"B={dec.barcode_count}" not in times:
                times[f"B={dec.barcode_count}"] = device_ms(lambda: pamld.pamld_classify(
                    dec, codes, quals, qcfail, tpq_constants=instrument.tpq_constants,
                    want_uncertain=True, eps=instrument.tpq_analytic_eps, short=short))
    cuda = torch.device("cuda")
    steps = (("flagship", flagship_ontology()), ("mdd flagship", mdd_flagship_ontology()))
    for label, ontology in steps if "steps" in sections else ():
        instrument = compile_instrument(ontology, cuda)
        widths, *arrays = flagship_blob(ontology, instrument, N_KERNEL, seed=96)
        blob, ccb, qcb = (torch.from_numpy(x).to(cuda) for x in arrays)
        step = DecodeStep(instrument, widths, wire.JOINT4, want_uncertain=True)
        times[f"{label} step"] = device_ms(lambda: step(blob, ccb, qcb))
        times[f"{label} step events"] = event_ms(lambda: step(blob, ccb, qcb))
        times[f"{label} step events x200"] = [event_ms(lambda: step(blob, ccb, qcb), reps=200) for _ in range(3)]
        try:
            times[f"{label} step launches"] = device_launches(lambda: step(blob, ccb, qcb))
        except RuntimeError as error:  # a measurement here: the profiler's dropped events are noted
            times[f"{label} step launches"] = str(error)
    if "whitelist" in sections:
        # K7 and K8 at the whitelist's 737,280 x 16 nt, the flagship cellular
        # decoder's parameters on a random panel
        rng = np.random.default_rng(737)
        panel = np.array([1, 2, 4, 8], np.uint8)[rng.integers(4, size=(737_280, 16))]
        instrument, observations = pamld_observations(flagship_ontology(), N_KERNEL, seed=737)
        dec, codes, _, qcfail, short = observations[1]
        wide = dataclasses.replace(dec, barcode_count=panel.shape[0], **dict(zip(
            ("panel_codes", "panel_codes_u8", "likelihood_matrix", "concentration"),
            _panel_matrices(panel, np.full(panel.shape[0], 0.95 / panel.shape[0]), cuda))))
        reads = torch.from_numpy(panel[rng.integers(panel.shape[0], size=N_KERNEL)]).to(cuda)
        errors = torch.from_numpy(rng.random((N_KERNEL, 16)) < 0.05).to(cuda)
        codes = torch.where(errors, torch.roll(reads, 1, dims=1), reads).contiguous()
        quals = torch.from_numpy(rng.integers(2, 42, size=(N_KERNEL, 16)).astype(np.uint8)).to(cuda)
        kwargs = dict(tpq_constants=instrument.tpq_constants, want_uncertain=True, eps=instrument.tpq_analytic_eps,
                      short=short)
        pamld.pamld_classify(wide, codes, quals, qcfail, **kwargs)
        times["K7 whitelist"] = once_ms(lambda: pamld.pamld_classify(wide, codes, quals, qcfail, **kwargs))[1]
        for panels in K8_PANELS:
            shards = [tp.shard_panel(wide, rank, panels) for rank in range(panels)]
            times[f"K8 P={panels} shard"] = once_ms(lambda: pamld.pamld_classify_sharded(
                wide, shards[:1], codes, quals, None, finish=False, **kwargs))[1]
    if "wide" in sections:
        times.update(wide_times())
    if "unpack_mdd" in sections:
        times.update(unpack_mdd_times())
    if "wide_unpack_mdd" in sections:
        times.update(wide_unpack_mdd_times())
    takes_plan = "plan" in inspect.signature(pamld._classify_launches).parameters
    if "rules" in sections:
        times.update(slice_rule_times(takes_plan))
        if takes_plan:
            times["cut sweep"] = slice_cut_sweep()
    if "epilogue" in sections:
        times.update(epilogue_times())
    say(json.dumps({"tree": tree, "card": card, "n": N_KERNEL, "device_ms": times}))


def main() -> int:
    parser = argparse.ArgumentParser(description="Smoke run of the port on the GPU.")
    parser.add_argument("--nccl", action="store_true",
                        help="only the PHENIQS_TP run over NCCL and the reads phase over two cards (>= 2 cards)")
    parser.add_argument("--times", metavar="TREE",
                        help="only time the tile loop (kernel_times), the package imported from TREE")
    parser.add_argument("--sections", default=",".join(TIME_SECTIONS),
                        help=f"--times' sections, comma-separated, of {','.join(TIME_SECTIONS)} (default: all)")
    args = parser.parse_args()
    sections = tuple(args.sections.split(","))
    if not set(sections) <= set(TIME_SECTIONS):
        parser.error(f"--sections: of {','.join(TIME_SECTIONS)}")
    if args.times:
        # a copy of another commit inside this checkout (.compare/ is
        # ignored by git): its kernels build into its own _build/
        tree = os.path.realpath(args.times)
        if os.path.commonpath([tree, os.path.realpath(HERE)]) != os.path.realpath(HERE):
            parser.error("--times TREE must lie inside this checkout")
        sys.path.insert(0, tree)
    import torch

    import pheniqs_tpu_torch  # noqa: F401  (fails outside a checkout)
    from pheniqs_tpu_torch.device.flagship import flagship_ontology, mdd_flagship_ontology
    from pheniqs_tpu_torch.device.instrument import LARGE_PANEL_B

    card = environment()
    if args.times:
        build_kernels()
        kernel_times(card, args.times, sections)
        return 0
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    threads = min(8, os.cpu_count() or 1)
    laps, clock = {}, [time.perf_counter()]

    def lap(name: str):
        now = time.perf_counter()
        laps[name] = round(now - clock[0], 1)
        clock[0] = now

    compiler = None
    try:
        build_kernels()
        lap("build")
        if args.nccl:
            nccl_only(card, threads)
            standalone_check()
            say(card)
            say(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
            return 0
        compiler = precompile_whitelist(threads)
        measured = kernel_checks()
        lap("kernels")
        k4_edge_checks()
        sweep = k4_threshold_sweep()
        lap("K4 edge cases and sweep")
        whitelist = Whitelist()
        plans = tile_loop_report(N_KERNEL, (96, 384, LARGE_PANEL_B, K7_PANEL, whitelist.decoder.barcode_count))
        measured["pamld_classify"]["extra"] = {"plans": {str(b): plans[b] for b in (96, 384, LARGE_PANEL_B)}}
        wide = whitelist_checks(whitelist)
        measured["pamld_chunked"] = dict(wide["pamld_chunked"], extra=plans[whitelist.decoder.barcode_count])
        k4_wide = wide["counters"]
        measured["counters"]["extra"] = {
            "peak_bytes": measured["counters"]["peak_bytes"],
            "whitelist_ms": k4_wide["ms"],
            "whitelist_plain_ms": k4_wide["plain_ms"],
            "whitelist_bound_ms": bound(k4_wide)[0],
            "whitelist_library_ms": k4_wide["library_ms"],
            "whitelist_peak_bytes": k4_wide["peak_bytes"],
            "threshold_sweep": [{"barcodes": b, "shared_ms": s, "global_ms": g} for b, s, g in sweep],
        }
        say(f"[kernels] {card} | counters at the whitelist (737,281 bins, N={N_KERNEL}): kernel"
            f" {k4_wide['ms']:.4f} ms, plain {k4_wide['plain_ms']:.4f} ms, bound {bound(k4_wide)[0]:.4f} ms"
            f" ({bound(k4_wide)[1]}), index_add_ yardstick {k4_wide['library_ms']:.4f} ms, peak allocation"
            f" {k4_wide['peak_bytes']} B")
        measured["pamld_panel_sharded"] = k8_checks(whitelist)
        lap("whitelist and K8")
        # the inputs the kernels once refused: every extended kernel against
        # its plain version, then the wide flagship through the engine
        for name, entries in wide_checks().items():
            measured[name].setdefault("extra", {})["wide"] = entries
        wide_counts = wide_e2e(card, threads)
        lap("wide")
        for name in KERNELS:
            m = measured[name]
            bound_ms, bound_by = bound(m)
            library = "none" if m["library_ms"] is None else f"{m['library_ms']:.4f} ms"
            say(f"[kernels] {card} | {name}: kernel {m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms,"
                f" bound {bound_ms:.4f} ms ({bound_by}), library call {library},"
                f" max |kernel - plain| {m['max_abs_err']:.3e}")
        b, ms, plain_ms = measured["chunked_4096"]
        say(f"[kernels] {card} | pamld_chunked B={b} N={N_KERNEL}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        whitelist.compiled = precompiled(compiler)
        decided = decisions_vs_strict("flagship", flagship_ontology(), N_DECISIONS, threads, keep_strict=True)
        decisions_vs_strict("mdd flagship", mdd_flagship_ontology(), N_DECISIONS, threads)
        tp_paths, tp_strict = decisions_vs_strict(
            f"B={K7_PANEL} flagship", flagship_ontology(cellular_barcodes=K7_PANEL), N_K7_DECISIONS, threads,
            keep_strict=True,
        )
        decisions_vs_strict("whitelist flagship", whitelist.ontology, N_WHITELIST_STRICT, threads,
                            fidelity="fast", limit=WHITELIST_FAST_LIMIT, paths=whitelist.inputs(N_WHITELIST_STRICT),
                            port_sam=whitelist.output, compiled=whitelist.compiled)
        lap("decisions")
        counts, flagship_paths = throughput(card, threads, whitelist)
        lap("throughput")
        one_row_report = os.path.join(WORK, "tp_report.json")
        for name, count in tp_run(card, tp_paths, tp_strict, threads, report=one_row_report).items():
            counts[name] += count
        for name, count in wide_counts.items():
            counts[name] += count
        missing = [name for name, count in counts.items() if count <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on any path: {missing}")
        if torch.cuda.device_count() >= 2:
            tp_run(card, tp_paths, tp_strict, threads, nccl=True)
        else:
            say("[tp] one card: the PHENIQS_TP run over NCCL needs two (python3 chip_smoke.py --nccl on such a host)")
        lap("tp")
        for name, count in grid(card, threads, whitelist, tp_paths, tp_strict, one_row_report).items():
            counts[name] += count
        lap("grid")
        for name, count in prior_workflow(card, threads).items():
            counts[name] += count
        lap("prior")
        for name, count in reads(card, threads, whitelist, decided).items():
            counts[name] += count
        lap("reads")
        for label, key in (("flagship", "step"), ("mdd flagship", "mdd_step")):
            step = measured[key]
            say(f"[throughput] {card} | {label} decode step N={N_KERNEL}, CUDA events:"
                f" kernels {step['event_ms']:.4f} ms ({N_KERNEL / step['event_ms'] * 1e3:.0f} reads/s),"
                f" plain {step['plain_event_ms']:.4f} ms; device time: kernels {step['ms']:.4f} ms,"
                f" plain {step['plain_ms']:.4f} ms")
        tools(card, threads, flagship_paths)
        lap("tools")
    finally:
        if compiler is not None and compiler.poll() is None:
            compiler.kill()
            compiler.wait()
        shutil.rmtree(WORK, ignore_errors=True)

    standalone_check()
    say(f"[time] seconds by phase: {json.dumps(laps)}")
    say(card)
    say(json.dumps({
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": counts[name],
                "max_abs_err": measured[name]["max_abs_err"],
                "ms": measured[name]["ms"],
                "plain_ms": measured[name]["plain_ms"],
                "bound_ms": bound(measured[name])[0],
                "bound_by": bound(measured[name])[1],
                "library_ms": measured[name]["library_ms"],
                **measured[name].get("extra", {}),
            }
            for name, (source, replaces) in KERNELS.items()
        ]
    }))
    say(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
