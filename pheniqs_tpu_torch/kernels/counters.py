"""K4: the per-barcode statistics counters (csrc/counters.cu).

``counters`` reduces the stacked per-read decisions of every decoder to
the flat counter vector in ``device.wire.counter_layout`` order, over
the rows valid = !pad && !uncertain_any. Every column is summed in
integers, so the result does not depend on the order of the adds: the
six integer columns as they are, the two confidence columns in 64-bit
fixed point (q = rint(c * 2^40), converted once as float(sum) * 2^-40).
On CUDA that is one accumulate kernel over (reads x decoders) and one
finalize kernel per launch, whatever the number of decoders; on the CPU
the plain version below does the same arithmetic with int64
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
from . import Decisions, mask_words, uncertain_mask
from .pamld import BRANCH_LOW_CONFIDENCE, BRANCH_NOISE, BRANCH_PASS

#: launches of the CUDA kernel in this process (one per batch, or per row
#: slice of a larger one: the accumulate kernel and its finalize)
launches = 0

_KIND = {"pamld": 2, "mdd": 1}
#: the fixed-point scale of the confidence sums
CONFIDENCE_SCALE = 2.0**40
#: the largest shared-memory histogram a decoder may take, in bytes;
#: larger panels add straight into global atomics. Measured by
#: chip_smoke.py's k4_threshold_sweep (csrc/counters.cu has its times):
#: shared is faster through 3072 barcodes, level at 4096, slower at 4800
SHARED_LIMIT = 192 * 1024
#: the most dynamic shared memory a block may take on the H100
SHARED_MAX = 227 * 1024
#: bytes of one bin of a decoder's shared histogram: a 4-byte slot per
#: column, and two 8-byte fixed-point sums for a PAMLD decoder
_WIDE_BIN_BYTES = 16


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
    step = slice_rows(instrument)
    return [(start, min(start + step, n)) for start in range(0, n, step)] or [(0, 0)]


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


_TABLES: dict = {}


def _device_table(table: DecoderTable, device) -> torch.Tensor:
    """The table's rows as an int32 tensor on `device`, made once."""
    key = (table.rows, str(device))
    if key not in _TABLES:
        _TABLES[key] = torch.tensor(table.rows, dtype=torch.int32).reshape(-1).to(device)
    return _TABLES[key]


def _device_mask(mask: int, decoders: int, device):
    """The uncertain mask's words (kernels.mask_words) on `device`, made
    once; None for an empty mask (no decoder's uncertain row counts)."""
    if not mask:
        return None
    key = ("uncertain", mask, decoders, str(device))
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(mask_words(mask, decoders).view(np.int32)).to(device)
    return _TABLES[key]


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


def _launch(instrument, decisions: Decisions, pad, forced, want_uncertain: bool):
    """One launch of K4 over at most slice_rows rows, counted."""
    global launches
    from .build import check, library

    d, n = decisions.decoded.shape
    table = decoder_table(instrument)
    if table.total == 0:
        return torch.zeros(0, dtype=torch.float32, device=pad.device)
    # the fixed-point sums, then the counters (integers, made f32 in place)
    scratch = torch.empty(table.wide + (table.total + 1) // 2, dtype=torch.int64, device=pad.device)
    mask = _device_mask(uncertain_mask(instrument, want_uncertain), d, pad.device)
    status = library().phq_counters(
        n, d, table.total, table.wide, table.shared_bytes, _device_table(table, pad.device).data_ptr(),
        decisions.decoded.data_ptr(), decisions.argmax.data_ptr(), decisions.distance.data_ptr(),
        decisions.branch.data_ptr(), decisions.confidence.data_ptr(), decisions.qcfail.data_ptr(),
        pad.data_ptr(), forced.data_ptr() if want_uncertain else None, decisions.uncertain.data_ptr(),
        None if mask is None else mask.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(pad.device).cuda_stream,
    )
    check(status, "counters")
    launches += 1
    return scratch[table.wide :].view(torch.float32)[: table.total]
