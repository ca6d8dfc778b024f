"""K5: the packed device->host decision blob (csrc/pack.cu).

``pack_outputs`` writes, per read and in ``device.wire.d2h_layout`` order,
the int16 (int32 for panels of 32000+ barcodes) decoded index of each
pamld/mdd decoder, the raw f32 confidence of each pamld decoder, the
chained qcfail bits and, in hybrid mode, the uncertain byte
(uncertain_any | forced), as one contiguous (N * total,) uint8 tensor.
On a CPU tensor the plain version below builds the same bytes with torch
views (the port of the pack_outputs block of
``pheniqs_tpu.device.step.make_decode_step``). ``pack_plan`` holds what
the kernel takes for one instrument: the layout, the reads a block, and
the fields of a row with the input rows each reads (its sources);
``pack_outputs_sources`` assembles the fields in torch, as the kernel
does."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device.wire import d2h_layout
from . import Decisions, uncertain_mask
from .counters import uncertain_any

#: launches of the CUDA kernel in this process
launches = 0

#: the most reads a block owns (one thread each): whole warps, a multiple
#: of 16 so every block's span of the output is 16-byte aligned
MAX_BLOCK_READS = 256
#: the shared bytes a block stages its rows in: the static limit, so no
#: launch needs the opt-in attribute
SHARED_BYTES = 48 * 1024
#: the fewest reads a block stages: past SHARED_BYTES / 32 bytes a row
#: (some 250 decoders) the rows are assembled in place
MIN_STAGED_READS = 32
#: a source's input array (csrc/pack.cu): 4-byte decoded and confidence
#: rows, then byte rows
DECODED, CONFIDENCE, QCFAIL, UNCERTAIN, FORCED = range(5)
#: a field of the row: one source's low `size` bytes stored; a qcfail
#: byte, bit j its j-th source's (value != 0); the uncertain byte, 1 where
#: any of its sources is nonzero
STORE, BITS, ANY = range(3)


@dataclass(frozen=True)
class PackPlan:
    """What K5 takes for one instrument and hybrid flag: the d2h layout
    (device.wire.d2h_layout), the bit masks of the decoders with a decoded
    index, a confidence and an uncertain row that counts, ``reads`` a
    block, whether the block stages its rows in shared memory (``staged``)
    or assembles them in place, the input rows the fields read
    (``sources``: array, row) and the row's ``fields`` in layout order
    (kind, first source, sources, byte of the row, bytes)."""

    layout: dict
    decoded_mask: int
    confidence_mask: int
    uncertain_mask: int
    reads: int
    staged: bool = True
    decoders: int = 0
    sources: tuple[tuple[int, int], ...] = ()
    fields: tuple[tuple[int, int, int, int, int], ...] = ()

    @property
    def shared_bytes(self) -> int:
        """Shared bytes of the block's assembled rows."""
        return (self.reads * self.layout["total"] + 15) // 16 * 16 if self.staged else 0

    @property
    def block_bytes(self) -> int:
        """Every shared byte a block takes: its rows and, where there are
        more fields than warps, a copy of the table (16 bytes a source and
        a field; csrc/pack.cu)."""
        if not self.staged:
            return 0
        table = 16 * (len(self.sources) + len(self.fields)) if len(self.fields) > self.reads // 32 else 0
        return self.shared_bytes + table

    def ints(self) -> np.ndarray:
        """The table as the kernel takes it: an int4 a source (array, row,
        0, 0), then an int4 a field (kind | bytes << 4, first source,
        sources, byte of the row)."""
        rows = [(array, row, 0, 0) for array, row in self.sources]
        rows += [(kind | size << 4, first, count, offset) for kind, first, count, offset, size in self.fields]
        return np.array([x for r in rows for x in r], dtype=np.int32)


def _fields(layout: dict, decoders: int, uncertain: int, want_uncertain: bool) -> tuple[tuple, tuple]:
    """(sources, fields): each field of a row in layout order, each
    decoded index and confidence stored, each qcfail byte packed from up
    to 8 decoders' rows and, in hybrid mode, the uncertain byte from the
    counted uncertain rows and the forced row; its sources consecutive."""
    size = layout["index_size"]
    fields = [(STORE, [(DECODED, k)], size * j, size) for j, k in enumerate(layout["decoded_positions"])]
    fields += [(STORE, [(CONFIDENCE, k)], layout["float_offset"] + 4 * j, 4)
               for j, k in enumerate(layout["confidence_positions"])]
    fields += [(BITS, [(QCFAIL, k) for k in range(8 * byte, min(decoders, 8 * byte + 8))],
                layout["qcfail_offset"] + byte, 1) for byte in range(layout["qcfail_bytes"])]
    if want_uncertain:
        rows = [(UNCERTAIN, k) for k in range(decoders) if (uncertain >> k) & 1] + [(FORCED, 0)]
        fields.append((ANY, rows, layout["uncertain_offset"], 1))
    sources, placed = [], []
    for kind, rows, offset, size in fields:
        placed.append((kind, len(sources), len(rows), offset, size))
        sources.extend(rows)
    return tuple(sources), tuple(placed)


def pack_plan(instrument, want_uncertain: bool) -> PackPlan:
    """K5's plan for `instrument`, made once and cached on it: the most
    reads a block, up to MAX_BLOCK_READS in whole warps, whose rows fit
    SHARED_BYTES; where not even MIN_STAGED_READS rows fit, MAX_BLOCK_READS
    rows assembled in place."""
    plans = instrument.pack_plans
    if want_uncertain not in plans:
        layout = d2h_layout(instrument, want_uncertain)
        reads = min(MAX_BLOCK_READS, SHARED_BYTES // layout["total"] // 32 * 32)
        staged = reads >= MIN_STAGED_READS
        reads = reads if staged else MAX_BLOCK_READS
        decoders = len(instrument.decoders)
        uncertain = uncertain_mask(instrument, want_uncertain)
        sources, fields = _fields(layout, decoders, uncertain, want_uncertain)
        plans[want_uncertain] = PackPlan(
            layout=layout,
            decoded_mask=sum(1 << k for k in layout["decoded_positions"]),
            confidence_mask=sum(1 << k for k in layout["confidence_positions"]),
            uncertain_mask=uncertain,
            reads=reads,
            staged=staged,
            decoders=decoders,
            sources=sources,
            fields=fields,
        )
    return plans[want_uncertain]


def _device_table(instrument, plan: PackPlan, device) -> torch.Tensor:
    """The plan's table (PackPlan.ints) on `device`, made once and cached
    on the instrument beside the plan."""
    key = (plan.layout["total"], plan.uncertain_mask, str(device))
    plans = instrument.pack_plans
    if key not in plans:
        plans[key] = torch.from_numpy(plan.ints()).to(device)
    return plans[key]


def pack_outputs_sources(plan: PackPlan, decisions: Decisions, forced) -> torch.Tensor:
    """The kernel's assembly of its plan's fields, in torch: the (N *
    total,) uint8 blob; for the tests."""
    n = decisions.decoded.shape[1]
    out = torch.zeros((n, plan.layout["total"]), dtype=torch.int64, device=decisions.decoded.device)
    arrays = {DECODED: decisions.decoded.view(torch.int32), CONFIDENCE: decisions.confidence.view(torch.int32),
              QCFAIL: decisions.qcfail, UNCERTAIN: decisions.uncertain}

    def value(source):
        array, row = plan.sources[source]
        return (forced if array == FORCED else arrays[array][row]).to(torch.int64) & 0xFFFFFFFF

    for kind, first, count, offset, size in plan.fields:
        if kind == STORE:
            for b in range(size):
                out[:, offset + b] = (value(first) >> (8 * b)) & 0xFF
        else:
            bits = [(value(first + j) != 0).to(torch.int64) << (j if kind == BITS else 0) for j in range(count)]
            out[:, offset] = torch.stack(bits).amax(0) if kind == ANY else torch.stack(bits).sum(0)
    return out.to(torch.uint8).reshape(-1)


def pack_outputs_plain(instrument, decisions: Decisions, forced, want_uncertain: bool):
    layout = d2h_layout(instrument, want_uncertain)
    n = decisions.decoded.shape[1]
    parts = []
    if layout["decoded_positions"]:
        dtype = torch.int32 if layout["wide"] else torch.int16
        ints = torch.stack(
            [decisions.decoded[k].to(dtype) for k in layout["decoded_positions"]], dim=1
        )
        parts.append(ints.view(torch.uint8).reshape(n, -1))
    if layout["confidence_positions"]:
        floats = torch.stack(
            [decisions.confidence[k] for k in layout["confidence_positions"]], dim=1
        )
        parts.append(floats.view(torch.uint8).reshape(n, -1))
    d = len(instrument.decoders)
    qc_bytes = []
    for byte in range(layout["qcfail_bytes"]):
        bits = torch.zeros(n, dtype=torch.uint8, device=decisions.qcfail.device)
        for bit in range(min(8, d - byte * 8)):
            bits |= decisions.qcfail[byte * 8 + bit].to(torch.uint8) << bit
        qc_bytes.append(bits)
    parts.append(torch.stack(qc_bytes, dim=1))
    if want_uncertain:
        unsure = uncertain_any(instrument, decisions, forced, True)
        parts.append(unsure.to(torch.uint8)[:, None])
    return torch.cat(parts, dim=1).reshape(-1)


def _check(instrument, decisions: Decisions, forced, want_uncertain: bool, out, device):
    """Raise what the kernel does not take (ValueError): rows of another shape or
    dtype than (decoders, N) int32 decoded, f32 confidence and bool qcfail
    and uncertain, a forced row (when it counts) other than (N,) bool, an
    output other than (N * total,) uint8, any of them not contiguous or
    not on `device`, or an output not 16-byte aligned (ValueError)."""
    total = pack_plan(instrument, want_uncertain).layout["total"]
    d, n = len(instrument.decoders), decisions.decoded.shape[-1]
    expected = [
        ("decoded", decisions.decoded, torch.int32, (d, n)),
        ("confidence", decisions.confidence, torch.float32, (d, n)),
        ("qcfail", decisions.qcfail, torch.bool, (d, n)),
        ("uncertain", decisions.uncertain, torch.bool, (d, n)),
        ("out", out, torch.uint8, (n * total,)),
    ]
    if want_uncertain:
        expected.append(("forced", forced, torch.bool, (n,)))
    for name, tensor, dtype, shape in expected:
        if tensor.dtype != dtype or tuple(tensor.shape) != shape:
            raise ValueError(f"pack_outputs: {name} is {tensor.dtype} {tuple(tensor.shape)}, not {dtype} {shape}")
        if not tensor.is_contiguous() or tensor.device != device:
            raise ValueError(f"pack_outputs: {name} must be contiguous and on {device}")
    if out.data_ptr() % 16:
        raise ValueError("pack_outputs: the output must be 16-byte aligned")


def _launch(lib, instrument, decisions: Decisions, forced, want_uncertain, out, stream):
    """Run the kernel (no device checks, no count)."""
    from .build import check

    plan = pack_plan(instrument, want_uncertain)
    n = decisions.decoded.shape[1]
    table = _device_table(instrument, plan, decisions.decoded.device)
    status = lib.phq_pack(
        n, plan.layout["total"], plan.reads, int(plan.staged), len(plan.sources), len(plan.fields),
        table.data_ptr(), decisions.decoded.data_ptr(), decisions.confidence.data_ptr(),
        decisions.qcfail.data_ptr(), decisions.uncertain.data_ptr(),
        forced.data_ptr() if want_uncertain else None, out.data_ptr(), stream,
    )
    check(status, "pack_outputs")
    return out


def pack_outputs(instrument, decisions: Decisions, forced, want_uncertain: bool):
    """K5: the (N * total,) uint8 decision blob of this batch."""
    device = decisions.decoded.device
    if device.type == "cpu":
        return pack_outputs_plain(instrument, decisions, forced, want_uncertain)
    if device.type != "cuda":
        raise ValueError(f"pack_outputs: unsupported device {device}")
    global launches
    from .build import library

    n = decisions.decoded.shape[-1]
    out = torch.empty(n * pack_plan(instrument, want_uncertain).layout["total"], dtype=torch.uint8, device=device)
    _check(instrument, decisions, forced, want_uncertain, out, device)
    _launch(library(), instrument, decisions, forced, want_uncertain, out, torch.cuda.current_stream(device).cuda_stream)
    launches += 1
    return out
