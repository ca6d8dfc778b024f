"""K4: the per-barcode statistics counters (csrc/counters.cu).

``counters`` reduces the stacked per-read decisions of every decoder to
the flat counter vector in ``device.wire.counter_layout`` order, over
the rows valid = !pad && !uncertain_any. Every column is summed in
integers, so the result does not depend on the order of the adds: the
six integer columns as they are, the two confidence columns in 64-bit
fixed point (q = rint(c * 2^40), converted once as float(sum) * 2^-40).
On CUDA that is one accumulate kernel (over tiles of reads x groups of
decoders, ``counter_plan``; on an instrument whose histograms are all
shared and small together, over reads x decoders:
``CounterPlan.per_decoder``)
and one finalize kernel per launch, whatever the number of decoders; on
the CPU the plain version below does the same arithmetic with int64
``index_add_``, so the kernel equals it byte for byte. Both agree with
``pheniqs_tpu.device.step._counters`` (f32 one-hot contraction): integer
columns exactly, confidence sums within N * 2^-41 + 1/2 ulp of the true
sum.

A launch sums at most ``slice_rows`` rows, so that its integer columns
stay exact in f32 and its fixed-point sums below 2^63. A larger batch
runs one launch per slice of rows, on either device, and the slices' f32
vectors are added in float64 (integer columns exact, each slice's
confidence sum within its own bound): the result is then float64, which
the engine adds into its int64 and float64 accumulators as it does f32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device.wire import counter_names
from . import Decisions, uncertain_mask
from .pamld import BRANCH_LOW_CONFIDENCE, BRANCH_NOISE, BRANCH_PASS

#: launches of the CUDA kernel in this process (one per batch, or per row
#: slice of a larger one: the accumulate kernel and its finalize)
launches = 0

_KIND = {"pamld": 2, "mdd": 1}
#: the fixed-point scale of the confidence sums
CONFIDENCE_SCALE = 2.0**40
#: the largest shared-memory histogram a decoder may take, in bytes (56
#: a PAMLD bin: up to 1169 barcodes); larger panels add straight into
#: global atomics. Measured by chip_smoke.py's k4_threshold_sweep on an
#: H100 80GB HBM3 at 700 W (PERF.md PR 16): shared faster at 1024
#: barcodes (0.0160 against 0.0183 ms), slower from 1536 (0.0186 against
#: 0.0157); PR 5's 192 KiB was measured on its own kernels
SHARED_LIMIT = 64 * 1024
#: the most dynamic shared memory a block may take on the H100
SHARED_MAX = 227 * 1024
#: bytes of one bin of a decoder's shared histogram: a 4-byte slot per
#: column, and for a PAMLD decoder its two fixed-point sums, each three
#: 4-byte pieces of 14 bits (csrc/counters.cu: a 64-bit shared atomic add
#: is a compare-and-swap loop)
_WIDE_BIN_BYTES = 24
#: the shared bytes the histograms of one group of decoders may take
#: together (a block sums one group over one tile of reads): every
#: decoder of the flagship paths fits one group; a decoder past it is a
#: group of its own
GROUP_BYTES = 48 * 1024
#: a tile's reads are a multiple of TILE_UNIT (a warp's chunk: two items
#: of 32 lanes x 4 reads) and at most MAX_TILE (its valid flags, a byte a
#: read, sit in shared memory beside the group's histograms, and a 14-bit
#: piece of a confidence sums at most 2^14 of them below 2^28)
TILE_UNIT = 256
MAX_TILE = 16384
#: the grid's blocks (tiles x groups) aim at WAVES blocks a multiprocessor,
#: the blocks an SM holds (csrc/counters.cu: PHQ_COUNTER_BLOCKS_PER_SM): a
#: walk bound by latency wants them all; the longer a tile, the fewer
#: blocks flush their histograms
WAVES = 3
#: the per-decoder instance (csrc/counters.cu: phq_counters_decoder, PR
#: 5's grid) runs an instrument whose histograms are all shared and take
#: at most PER_DECODER_BYTES together (_decoder_bytes); the grouped kernel
#: runs every other. A per-decoder block flushes its decoder's whole
#: histogram for every 512 reads, and builds each read's flag from the P
#: uncertain rows once a decoder; the grouped kernel flushes once a tile
#: but pays a flag pass and a barrier. Both timed at 3-33 decoders of two
#: patterns (chip_smoke.py --times, epilogue; H100 80GB HBM3 at 700 W,
#: PERF.md PR 16): the per-decoder instance faster wherever the sum is at
#: most 58,520 bytes (up to 33 decoders of 97-, 41- and 1-bin histograms:
#: 0.0663 against 0.0696-0.0701 ms at 33; 6 flagship-like decoders,
#: 46,288 bytes: 0.0229-0.0232 against 0.0235-0.0237), the grouped one
#: from 69,424 (8 flagship-like decoders: 0.0297 against 0.0305-0.0308;
#: 33: 0.0825-0.0832 against 0.1039-0.1040)
PER_DECODER_BYTES = 64 * 1024


def _decoder_bytes(row) -> int:
    """The per-decoder instance's shared histogram of one decoder-table
    row: 4 bytes a bin and column, two 8-byte fixed-point sums a PAMLD
    bin."""
    _, b1, kind, cols, _, _ = row
    return b1 * (4 * cols + (16 if kind == 2 else 0))


@dataclass(frozen=True)
class DecoderTable:
    """The kernel's per-decoder table: one row (layout offset, bins, kind,
    columns, first fixed-point sum or -1, shared-histogram bytes or 0) per
    decoder; ``total`` counters in all, ``wide`` fixed-point sums,
    ``shared_bytes`` the largest shared histogram."""

    rows: tuple[tuple[int, int, int, int, int, int], ...]
    total: int
    wide: int
    shared_bytes: int


def decoder_table(instrument) -> DecoderTable:
    rows = []
    offset = wide = 0
    for dec in instrument.decoders:
        b1 = dec.barcode_count + 1
        cols = len(counter_names(dec))
        kind = _KIND.get(dec.algorithm, 0)
        histogram = b1 * (4 * cols + (_WIDE_BIN_BYTES if kind == 2 else 0))
        rows.append((offset, b1, kind, cols, wide if kind == 2 else -1,
                     histogram if histogram <= SHARED_LIMIT else 0))
        offset += b1 * cols
        if kind == 2:
            wide += 2 * b1
    return DecoderTable(tuple(rows), offset, wide, max((row[5] for row in rows), default=0))


#: the most rows one launch may sum: n * 2^40 stays below 2^63
MAX_SLICE_ROWS = 2**23 - 1


def slice_rows(instrument) -> int:
    """The most rows of a batch one launch of K4 may sum: each integer
    column below 2^24, where f32 still holds it exactly (n rows, each
    adding at most the decoder's width of distance), and the fixed-point
    confidence sums below 2^63 (MAX_SLICE_ROWS)."""
    most = max((max(1, dec.width) for dec in instrument.decoders if dec.algorithm in _KIND), default=1)
    return min(MAX_SLICE_ROWS, (2**24 - 1) // most)


def row_slices(instrument, n: int) -> list[tuple[int, int]]:
    """(start, stop) of the row slices K4 sums one launch each."""
    step = counter_plan(instrument).slice_rows
    return [(start, min(start + step, n)) for start in range(0, n, step)] or [(0, 0)]


@dataclass(frozen=True)
class CounterPlan:
    """What the accumulate kernel takes for one instrument: the decoder
    table, the groups of decoders a block sums together ((first, stop,
    shared bytes of their histograms), in order, each decoder in one), each
    decoder's histogram offset in its group's shared memory, the decoders
    whose uncertain row counts in hybrid mode (PAMLD), the rows one
    launch may sum, and whether the per-decoder instance runs it
    (``per_decoder``: every histogram in shared memory, at most
    PER_DECODER_BYTES together). ``tile`` gives the reads a block for a
    batch."""

    table: DecoderTable
    groups: tuple[tuple[int, int, int], ...]
    smem: tuple[int, ...]
    uncertain_rows: tuple[int, ...]
    slice_rows: int
    per_decoder: bool = False

    @property
    def decoder_bytes(self) -> int:
        """The per-decoder instance's largest shared histogram."""
        return max(map(_decoder_bytes, self.table.rows), default=0)

    @property
    def flags_at(self) -> int:
        """Where the tile's valid flags start in a block's shared memory:
        past the largest group's histograms (16-byte aligned)."""
        return max((bytes_ for _, _, bytes_ in self.groups), default=0)

    def tile(self, n: int, sms: int) -> int:
        """Reads a block for an `n`-read batch on a card of `sms`
        multiprocessors: tiles x groups about WAVES blocks an SM, each
        tile a multiple of TILE_UNIT, at most MAX_TILE reads and its flags
        within SHARED_MAX beside the largest group."""
        tiles = max(1, -(-WAVES * sms // max(1, len(self.groups))))
        tile = -(-max(1, -(-n // tiles)) // TILE_UNIT) * TILE_UNIT
        return min(tile, MAX_TILE, (SHARED_MAX - self.flags_at) // TILE_UNIT * TILE_UNIT)

    def shared_bytes(self, tile: int) -> int:
        """Dynamic shared bytes of a block: the largest group's histograms
        and the tile's flags."""
        return self.flags_at + -(-tile // 16) * 16

    def ints(self) -> np.ndarray:
        """The table as the kernel takes it (csrc/counters.cu): a row of 7
        ints a decoder (the DecoderTable row and its histogram's offset in
        its group), a row of 3 a group, then the uncertain rows."""
        rows = [(*row, at) for row, at in zip(self.table.rows, self.smem)]
        flat = [x for row in rows for x in row] + [x for group in self.groups for x in group]
        return np.array(flat + list(self.uncertain_rows), dtype=np.int32)


def _group_count(sizes: list[int], cap: int) -> int:
    """Groups of consecutive histograms of `sizes` bytes, each group
    closed before it would pass `cap` (a larger one alone)."""
    count, used = 0, None
    for size in sizes:
        if used is None or used + size > cap:
            count, used = count + 1, 0
        used += size
    return count


def _groups(sizes: list[int]) -> tuple[tuple[tuple[int, int, int], ...], tuple[int, ...]]:
    """(groups, offsets): consecutive decoders cut into as few groups as
    GROUP_BYTES allows (a histogram past it alone), the cut as even as
    that count allows (the least cap giving no more groups), and each
    histogram's offset in its group."""
    if not sizes:
        return (), ()
    largest = max(sizes)
    count = _group_count(sizes, max(largest, GROUP_BYTES))
    low, high = largest, max(largest, GROUP_BYTES)
    while low < high:
        cap = (low + high) // 2
        if _group_count(sizes, cap) <= count:
            high = cap
        else:
            low = cap + 1
    groups, offsets, first, used = [], [], 0, 0
    for d, size in enumerate(sizes):
        if d > first and used + size > low:
            groups.append((first, d, used))
            first, used = d, 0
        offsets.append(used)
        used += size
    groups.append((first, len(sizes), used))
    return tuple(groups), tuple(offsets)


def counter_plan(instrument) -> CounterPlan:
    """K4's plan for `instrument`, made once and cached on it (its
    ``counter_plans``, made where the instrument lacks it) under the
    SHARED_LIMIT and GROUP_BYTES it was made with."""
    if not hasattr(instrument, "counter_plans"):
        instrument.counter_plans = {}
    key = (SHARED_LIMIT, GROUP_BYTES)
    plans = instrument.counter_plans
    if key not in plans:
        table = decoder_table(instrument)
        # each histogram 16-byte aligned: its fixed-point sums are 8-byte words
        groups, offsets = _groups([-(-row[5] // 16) * 16 for row in table.rows])
        plans[key] = CounterPlan(
            table=table, groups=groups, smem=offsets,
            uncertain_rows=tuple(k for k, dec in enumerate(instrument.decoders) if dec.algorithm == "pamld"),
            slice_rows=slice_rows(instrument),
            per_decoder=(0 < len(table.rows) and all(row[5] > 0 for row in table.rows)
                         and sum(map(_decoder_bytes, table.rows)) <= PER_DECODER_BYTES),
        )
    return plans[key]


def uncertain_any(instrument, decisions: Decisions, forced, want_uncertain: bool):
    """(N,) bool: a decoder's derived bound fired, or the wire forced it."""
    mask = uncertain_mask(instrument, want_uncertain)
    result = forced.clone() if want_uncertain else torch.zeros_like(forced)
    for k in range(len(instrument.decoders)):
        if (mask >> k) & 1:
            result |= decisions.uncertain[k]
    return result


def _bins(b1: int, index: torch.Tensor, columns: list[torch.Tensor]) -> list[torch.Tensor]:
    """(b1,) int64 sums of each (N,) int64 column keyed by `index`."""
    stacked = torch.zeros((b1, len(columns)), dtype=torch.int64, device=index.device)
    stacked.index_add_(0, index.long(), torch.stack(columns, dim=1))
    return [stacked[:, k] for k in range(len(columns))]


def _decoder_counters_plain(dec, row: dict, valid: torch.Tensor) -> list[torch.Tensor]:
    b1 = dec.barcode_count + 1
    pf = valid & ~row["qcfail"]
    columns = [valid.long(), pf.long()]
    if dec.algorithm in ("pamld", "mdd"):
        counted = valid & (row["decoded"] > 0) & (row["distance"] > 0)
        distance = torch.where(counted, row["distance"], 0).long()
        columns += [distance, torch.where(pf, distance, 0)]
    out = [s.to(torch.float32) for s in _bins(b1, row["decoded"], columns)]
    if dec.algorithm == "pamld":
        branch = row["branch"]
        passed = valid & (branch == BRANCH_PASS) & (row["confidence"] != 0)
        q = torch.where(passed, torch.round(row["confidence"] * CONFIDENCE_SCALE).long(), 0)
        sums = _bins(b1, row["decoded"], [q, torch.where(pf, q, 0)])
        out += [s.to(torch.float32) * (1.0 / CONFIDENCE_SCALE) for s in sums]
        filters = [(valid & (branch == BRANCH_LOW_CONFIDENCE)).long(), (valid & (branch == BRANCH_NOISE)).long()]
        out += [s.to(torch.float32) for s in _bins(b1, row["argmax"], filters)]
    return out


def counters_plain(instrument, decisions: Decisions, pad, forced, want_uncertain: bool):
    return _sliced(_counters_plain, instrument, decisions, pad, forced, want_uncertain)


def _counters_plain(instrument, decisions: Decisions, pad, forced, want_uncertain: bool):
    valid = ~pad & ~uncertain_any(instrument, decisions, forced, want_uncertain)
    parts = []
    for k, dec in enumerate(instrument.decoders):
        parts.extend(_decoder_counters_plain(dec, decisions.row(k), valid))
    if not parts:
        return torch.zeros(0, dtype=torch.float32, device=pad.device)
    return torch.cat(parts)


def _sliced(launch, instrument, decisions: Decisions, pad, forced, want_uncertain: bool):
    """`launch` once over a batch within slice_rows, else once per row
    slice, the slices' f32 vectors added in float64."""
    slices = row_slices(instrument, pad.shape[0])
    if len(slices) == 1:
        return launch(instrument, decisions, pad, forced, want_uncertain)
    total = None
    for start, stop in slices:
        part = launch(instrument, decisions.columns(start, stop), pad[start:stop].contiguous(),
                      forced[start:stop].contiguous(), want_uncertain).to(torch.float64)
        total = part if total is None else total + part
    return total


_SMS: dict = {}


def _multiprocessors(device) -> int:
    key = str(device)
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[key]


def _device_table(instrument, plan: CounterPlan, device) -> torch.Tensor:
    """The plan's table (CounterPlan.ints) on `device`, made once and
    cached on the instrument beside the plan (the entry holds the plan, so
    its id stays its own)."""
    plans = instrument.counter_plans
    key = (id(plan), str(device))
    if key not in plans:
        plans[key] = (plan, torch.from_numpy(plan.ints()).to(device))
    return plans[key][1]


def counters(instrument, decisions: Decisions, pad, forced, want_uncertain: bool):
    """K4: the flat (L,) counter vector of this batch (f32; float64 when
    the batch takes more than one row slice)."""
    if pad.device.type == "cpu":
        return counters_plain(instrument, decisions, pad, forced, want_uncertain)
    if pad.device.type != "cuda":
        raise ValueError(f"counters: unsupported device {pad.device}")
    rows = [getattr(decisions, f) for f in ("decoded", "argmax", "distance", "branch", "confidence", "qcfail", "uncertain")]
    if not all(t.is_contiguous() and t.device == pad.device for t in rows + [pad, forced]):
        raise ValueError("counters: the decision rows, pad and forced must be contiguous and on one device")
    return _sliced(_launch, instrument, decisions, pad, forced, want_uncertain)


def launch_arguments(instrument, decisions: Decisions, pad, forced, want_uncertain: bool, sms: int,
                     plan: CounterPlan | None = None) -> tuple[CounterPlan, dict]:
    """(plan, the kernel's integer arguments) for one launch of K4 over
    `decisions` on a card of `sms` multiprocessors: nothing walks the
    decoders (the plan is the instrument's). Four reads a lane where the
    batch is a multiple of 4 reads and every row is aligned for it."""
    plan = counter_plan(instrument) if plan is None else plan
    n = decisions.decoded.shape[1]
    tile = plan.tile(n, sms)
    words = (decisions.decoded, decisions.argmax, decisions.distance, decisions.confidence)
    flags = (decisions.branch, decisions.qcfail, decisions.uncertain, pad, forced)
    vector = n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in words) and all(t.data_ptr() % 4 == 0 for t in flags)
    return plan, {
        "n": n, "decoders": len(plan.table.rows), "groups": len(plan.groups),
        "uncertain": len(plan.uncertain_rows) if want_uncertain else 0, "total": plan.table.total,
        "wide": plan.table.wide, "tile": tile,
        "shared_bytes": plan.decoder_bytes if plan.per_decoder else plan.shared_bytes(tile),
        "flags_at": plan.flags_at, "vec": 4 if vector else 1, "per_decoder": int(plan.per_decoder),
    }


def _launch(instrument, decisions: Decisions, pad, forced, want_uncertain: bool, plan: CounterPlan | None = None):
    """One launch of K4 over at most slice_rows rows, counted; `plan`
    another than the instrument's (chip_smoke holds and times both
    instances on the same rows)."""
    global launches
    from .build import check, library

    plan, args = launch_arguments(instrument, decisions, pad, forced, want_uncertain,
                                  _multiprocessors(pad.device), plan)
    if args["total"] == 0:
        return torch.zeros(0, dtype=torch.float32, device=pad.device)
    # the fixed-point sums, then the counters (integers, made f32 in place)
    scratch = torch.empty(args["wide"] + (args["total"] + 1) // 2, dtype=torch.int64, device=pad.device)
    status = library().phq_counters(
        *(args[key] for key in ("n", "decoders", "groups", "uncertain", "total", "wide", "tile", "shared_bytes",
                                "flags_at", "vec", "per_decoder")),
        _device_table(instrument, plan, pad.device).data_ptr(),
        decisions.decoded.data_ptr(), decisions.argmax.data_ptr(), decisions.distance.data_ptr(),
        decisions.branch.data_ptr(), decisions.confidence.data_ptr(), decisions.qcfail.data_ptr(),
        pad.data_ptr(), forced.data_ptr() if want_uncertain else None, decisions.uncertain.data_ptr(),
        scratch.data_ptr(), torch.cuda.current_stream(pad.device).cuda_stream,
    )
    check(status, "counters")
    launches += 1
    return scratch[args["wide"] :].view(torch.float32)[: args["total"]]
