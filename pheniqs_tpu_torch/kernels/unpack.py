"""K3: wire unpack + decoder token extraction (csrc/unpack_tokens.cu).

``unpack_tokens`` turns the (N, bytes) uint8 wire blob into every PAMLD
and MDD decoder's fixed-width observation: (N, W) uint8 codes and qualities
(positions past the observation zeroed), per-observation-segment lengths,
a per-decoder "shorter than the token" flag, and the wire's qcfail, pad
and forced flags. On a CUDA tensor it launches the kernel; on a CPU tensor
it runs the plain version below (the torch port of
``pheniqs_tpu.device.step._unpack_h2d_blob`` followed by
``pheniqs_tpu.device.classify.apply_plans``). Naive and passthrough
decoders get no observation: the decode step discards theirs too.
``apply_plans`` runs the token extraction alone, on segments that are
already unpacked, through the same kernel.

Two plans (``unpack_plan``): where a block of 128 reads stages
everything in shared memory, two blocks an SM (``block_plan``; the
flagship, MDD flagship and whitelist layouts), a thread walks its read's
program; everywhere else (a long program, rows too wide to stage) the
column plan gives a block 32 reads, a lane each, and a chunk of decoder
slots, whose plans its warps walk from a table built once per layout
(``column_table``; ``unpack_tokens_columns`` walks it in torch, for the
tests).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..iupac import BAM_REVERSE_COMPLEMENT

from ..device.wire import JOINT4, _lane_bytes, _length_bytes, segment_offsets

#: launches of the CUDA kernel in this process
launches = 0

#: not a wire: one code byte and one quality byte per position, then a
#: 2-byte length, per segment (how ``apply_plans`` feeds the kernel)
RAW = "raw"
_WIRE_MODE = {6: 6, 2: 2, 4: 4, RAW: 8, JOINT4: 16}
_HEADER = 24
#: the reads a block of the block plan owns (one thread each); a multiple
#: of 16 keeps every block's output spans 16-byte aligned
MAX_BLOCK_READS = 128
#: the dynamic shared memory a block may take on the H100 (227 KB a block
#: by opt-in, less the kernel's 128 static bytes of codebooks)
SHARED_BYTES = 227 * 1024 - 128
#: the most the block plan may stage to be chosen: two blocks, 8 warps, an
#: SM (a block plan staging more leaves one block of 4 warps an SM, and
#: the column plan ran 3.1x faster on a 3,058-int program that did)
BLOCK_SHARED = SHARED_BYTES // 2


@dataclass
class TokenLayout:
    """Where each PAMLD or MDD decoder's observation lands in the unpack
    outputs, plus the int32 program the kernel walks (the wire layout and
    every token plan)."""

    widths: list[int]
    qual_bits: object
    slots: list[int]  # decoder positions, one slot per PAMLD or MDD decoder
    token_columns: list[tuple[int, int]]  # per slot (first column, W)
    length_columns: list[tuple[int, int]]  # per slot (first column, S)
    token_cols: int
    length_cols: int
    program: np.ndarray  # int32
    #: K3's plans by (row bytes, program ints) (unpack_plan)
    block_plans: dict = field(default_factory=dict, repr=False, compare=False)
    #: the column table (column_table) on each device, made once
    column_tables: dict = field(default_factory=dict, repr=False, compare=False)


@dataclass
class Tokens:
    codes: torch.Tensor  # (N, token_cols) uint8
    quals: torch.Tensor  # (N, token_cols) uint8
    lengths: torch.Tensor  # (N, length_cols) int32
    short: torch.Tensor  # (N, slots) bool
    qcfail: torch.Tensor  # (N,) bool
    pad: torch.Tensor  # (N,) bool
    forced: torch.Tensor  # (N,) bool

    def observation(self, layout: TokenLayout, slot: int):
        """(codes (N, W), quals (N, W), lengths (N, S), short (N,)) views of
        one decoder slot."""
        c0, w = layout.token_columns[slot]
        l0, s = layout.length_columns[slot]
        return (
            self.codes[:, c0 : c0 + w],
            self.quals[:, c0 : c0 + w],
            self.lengths[:, l0 : l0 + s],
            self.short[:, slot],
        )


def token_layout(instrument, widths: list[int], qual_bits) -> TokenLayout:
    """The unpack program for `instrument`'s PAMLD and MDD decoders on a
    wire of segment `widths` (each a multiple of 4) and quality regime
    `qual_bits` (6, 2, 4 or "j4"). An MDD decoder reads its observation
    segments side by side, with one length column each."""
    return _layout(
        [
            (position, dec)
            for position, dec in enumerate(instrument.decoders)
            if dec.algorithm in ("pamld", "mdd") and dec.plans
        ],
        widths,
        qual_bits,
    )


@dataclass(frozen=True)
class BlockPlan:
    """How K3's block plan stages a block of MAX_BLOCK_READS reads in
    shared memory for one program and wire row size (``block_plan``): the
    program, and each read's wire row, codes and qualities, lengths, short
    flags and three flags; a staged token row ``token_pitch`` bytes and a
    length row ``length_pitch`` ints (odd word counts: a warp's 32 stores
    to one column fall in 32 banks); each area's byte offset; and the
    dynamic shared bytes in all."""

    reads: int
    token_pitch: int
    length_pitch: int
    wire_at: int
    codes_at: int
    quals_at: int
    lengths_at: int
    short_at: int
    flags_at: int
    shared_bytes: int

    def ints(self) -> np.ndarray:
        """The plan as the kernel's entry takes it (csrc/unpack_tokens.cu
        PhqUnpackPlan)."""
        return np.array([getattr(self, name) for name in self.__dataclass_fields__], dtype=np.int32)


def _odd_words(size: int) -> int:
    """`size` rounded up to whole 4-byte words, an odd number of them (a
    staged row's pitch; csrc/unpack_tokens.cu phq_odd_pitch)."""
    words = (size + 3) // 4
    return 4 * (words | 1) if size else 0


def _round16(size: int) -> int:
    return (size + 15) // 16 * 16


def block_plan(layout: TokenLayout, row_bytes: int, program_ints: int | None = None) -> BlockPlan:
    """The block plan's staging of MAX_BLOCK_READS reads: the program,
    then for each read its wire row (the span may start anywhere in its
    first 16 bytes), codes and qualities, lengths, short flags and three
    flags, each area 16-byte aligned. Its shared bytes may pass what a
    block can take; unpack_plan then takes the column plan."""
    if program_ints is None:
        program_ints = layout.program.size
    reads = MAX_BLOCK_READS
    token_pitch = _odd_words(layout.token_cols)
    length_pitch = layout.length_cols | 1 if layout.length_cols else 0
    at = _round16(4 * program_ints)
    offsets = {}
    for name, size in (("wire_at", reads * row_bytes + 16), ("codes_at", reads * token_pitch),
                       ("quals_at", reads * token_pitch), ("lengths_at", 4 * reads * length_pitch),
                       ("short_at", reads * len(layout.slots)), ("flags_at", 3 * reads)):
        offsets[name] = at
        at += _round16(size)
    return BlockPlan(reads, token_pitch, length_pitch, shared_bytes=at, **offsets)


#: the column plan: the reads a block owns (a lane each), the shared bytes
#: a chunk of slots may stage for them (four blocks an SM), the most the 32
#: wire rows may take to be staged too, and the most plans of one length
#: column an item walks
COLUMN_READS = 32
CHUNK_SHARED = 54 * 1024
WIRE_SHARED = 16 * 1024
ITEM_PLANS = 16
#: the dynamic shared memory a block of the column plan may take: 227 KB
#: less the kernel's static arrays (PHQ_COLUMN_SPEC_SHARED ints of the
#: program's head and 32 of codebooks)
COLUMN_SHARED_MAX = 227 * 1024 - 4 * (1024 + 32)
#: the column table's header ints (csrc/unpack_tokens.cu PHQ_COLUMN_HEADER)
_COLUMN_HEADER = 16


def chunk_bytes(columns: int, length_columns: int, slots: int) -> int:
    """The shared bytes of a chunk's staging for COLUMN_READS reads: codes
    and qualities, lengths (an odd number of ints a row) and short flags,
    in whole 16-byte words (the kernel zeroes them 16 bytes at a time)."""
    return _round16(COLUMN_READS * (2 * _odd_words(columns) + 4 * (length_columns | 1) + slots))


def column_chunks(layout: TokenLayout) -> list[tuple[int, int, bool]]:
    """The decoder slots of `layout` cut into chunks, (first slot, end
    slot, staged): consecutive slots while their staging (chunk_bytes)
    takes at most CHUNK_SHARED; a slot past that alone, staged up to
    COLUMN_SHARED_MAX, else in place."""
    chunks, first = [], 0
    for slot in range(len(layout.slots) + 1):
        if slot < len(layout.slots) and _slot_bytes(layout, first, slot + 1) <= CHUNK_SHARED:
            continue
        if slot > first:
            chunks.append((first, slot, True))
            first = slot
        if slot < len(layout.slots) and _slot_bytes(layout, slot, slot + 1) > CHUNK_SHARED:
            chunks.append((slot, slot + 1, _slot_bytes(layout, slot, slot + 1) <= COLUMN_SHARED_MAX))
            first = slot + 1
    return chunks


def _slot_bytes(layout: TokenLayout, first: int, end: int) -> int:
    columns = sum(layout.token_columns[d][1] for d in range(first, end))
    length_columns = sum(layout.length_columns[d][1] for d in range(first, end))
    return chunk_bytes(columns, length_columns, end - first)


@dataclass(frozen=True)
class ColumnPlan:
    """K3's column plan (csrc/unpack_tokens.cu phq_unpack_columns_kernel)
    for one wire row size: a block owns COLUMN_READS reads and one chunk
    of slots (column_chunks); ``stage_wire``: their wire rows staged in
    shared memory too; ``shared_bytes``: the launch's dynamic shared
    memory (the wire rows and the largest staged chunk); ``in_place``: a
    chunk runs in place (the entry zeroes the token bytes and short flags
    first)."""

    chunks: tuple
    stage_wire: bool
    shared_bytes: int

    @property
    def in_place(self) -> bool:
        return not all(staged for _, _, staged in self.chunks)


def column_plan(layout: TokenLayout, row_bytes: int) -> ColumnPlan:
    """The column plan of `layout` on wire rows of `row_bytes`: its chunks,
    and the wire rows staged where COLUMN_READS of them take at most
    WIRE_SHARED and fit beside the largest staged chunk."""
    chunks = tuple(column_chunks(layout))
    staging = max((_slot_bytes(layout, first, end) for first, end, staged in chunks if staged), default=0)
    wire = _round16(COLUMN_READS * row_bytes + 16)
    stage_wire = wire <= WIRE_SHARED and wire + staging <= COLUMN_SHARED_MAX
    return ColumnPlan(chunks, stage_wire, staging + (wire if stage_wire else 0))


def unpack_plan(layout: TokenLayout, row_bytes: int, program_ints: int | None = None):
    """K3's plan for `layout` on wire rows of `row_bytes`: the block plan
    where its staging takes at most BLOCK_SHARED bytes, else the column
    plan."""
    plan = block_plan(layout, row_bytes, program_ints)
    return plan if plan.shared_bytes <= BLOCK_SHARED else column_plan(layout, row_bytes)


def column_table(layout: TokenLayout) -> np.ndarray:
    """The column plan's table of `layout`'s program, one int32 array of
    16-byte records after a 16-int header [token columns, length columns,
    slots, items, chunks, and the int offsets of the four parts below,
    then zeros]:
      - items: each length column's plans cut into runs of at most
        ITEM_PLANS, as {first plan, end plan, length column, 0}, in length
        column order;
      - plans: ordered by their length column, each two records {start,
        end, first token column, flags} {width, 0, 0, 0} (flags: bit 1 end
        terminated, bit 2 reverse complement, the input segment from bit
        8);
      - per length column {first item, end item, the observation
        segment's width, the decoder slot};
      - per chunk of slots (column_chunks) three records {first, end token
        column, first, end length column} {first, end item, first, end
        slot} {staged, 0, 0, 0}."""
    program = layout.program
    n_segments, n_plans, n_entries, n_slots = (int(program[k]) for k in (1, 3, 4, 5))
    token_cols, length_cols = int(program[6]), int(program[7])
    at = _HEADER + 5 * n_segments
    plans = program[at : at + 9 * n_plans].reshape(n_plans, 9).astype(np.int64)
    entries = program[at + 9 * n_plans : at + 9 * n_plans + 3 * n_entries].reshape(n_entries, 3)
    order = np.argsort(plans[:, 7], kind="stable")
    plans = plans[order]
    records = np.zeros((n_plans, 8), dtype=np.int64)
    records[:, :3] = plans[:, [1, 2, 5]]
    records[:, 3] = (plans[:, 3] << 1) | (plans[:, 4] << 2) | (plans[:, 0] << 8)
    records[:, 4] = plans[:, 6]
    bounds = np.searchsorted(plans[:, 7], np.arange(length_cols + 1))
    items, lcols = [], np.zeros((length_cols, 4), dtype=np.int64)
    for column in range(length_cols):
        lcols[column, 0] = len(items)
        for first in range(bounds[column], bounds[column + 1], ITEM_PLANS):
            items.append([first, min(first + ITEM_PLANS, bounds[column + 1]), column, 0])
        lcols[column, 1] = len(items)
    lcols[entries[:, 1], 2] = entries[:, 2]
    lcols[entries[:, 1], 3] = entries[:, 0]
    items = np.array(items, dtype=np.int64).reshape(-1, 4)
    chunks = []
    for first, end, staged in column_chunks(layout):
        c0, l0 = layout.token_columns[first][0], layout.length_columns[first][0]
        c1 = layout.token_columns[end - 1][0] + layout.token_columns[end - 1][1]
        l1 = layout.length_columns[end - 1][0] + layout.length_columns[end - 1][1]
        chunks.append([c0, c1, l0, l1, lcols[l0, 0] if l1 > l0 else 0, lcols[l1 - 1, 1] if l1 > l0 else 0, first,
                       end, int(staged), 0, 0, 0])
    chunks = np.array(chunks, dtype=np.int64).reshape(-1, 12)
    parts = [items, records, lcols, chunks]
    offsets = np.cumsum([_COLUMN_HEADER] + [part.size for part in parts])
    header = np.zeros(_COLUMN_HEADER, dtype=np.int64)
    header[:9] = [token_cols, length_cols, n_slots, len(items), len(chunks), *offsets[:4]]
    return np.concatenate([header] + [part.ravel() for part in parts]).astype(np.int32)


def _segment_table(widths: list[int], qual_bits):
    """Per segment [width, code offset, quality offset, length offset,
    length bytes] of one blob row, and the offset of its flags byte."""
    if qual_bits == RAW:
        segments, offset = [], 0
        for w in widths:
            segments.append([w, offset, offset + w, offset + 2 * w, 2])
            offset += 2 * w + 2
        return segments, offset
    segments = [
        [w, code_off, qual_off, len_off, _length_bytes(w)]
        for w, (code_off, qual_off, len_off) in zip(widths, segment_offsets(widths, qual_bits))
    ]
    flags_offset = sum(sum(_lane_bytes(w, qual_bits)) + _length_bytes(w) for w in widths)
    return segments, flags_offset


def _layout(decoders, widths: list[int], qual_bits) -> TokenLayout:
    """The unpack program that extracts the tokens of `decoders`, a list
    of (position in the instrument, decoder), one slot each."""
    segments, flags_offset = _segment_table(widths, qual_bits)
    plans, entries, slots = [], [], []
    token_columns, length_columns = [], []
    column = 0
    length_column = 0
    for position, dec in decoders:
        slot = len(slots)
        slots.append(position)
        token_columns.append((column, sum(dec.segment_widths)))
        length_columns.append((length_column, len(dec.segment_widths)))
        # observation segment s starts after segments < s; its plans
        # concatenate in plan order (apply_plans)
        segment_start = np.concatenate([[0], np.cumsum(dec.segment_widths)[:-1]])
        filled = [0] * len(dec.segment_widths)
        for plan in dec.plans:
            s = plan.output_segment_index
            plans.append([
                plan.input_segment_index,
                plan.start,
                plan.end,
                int(plan.end_terminated),
                int(plan.reverse_complement),
                column + int(segment_start[s]) + filled[s],
                plan.width,
                length_column + s,
                0,
            ])
            filled[s] += plan.width
        for s, width in enumerate(dec.segment_widths):
            entries.append([slot, length_column + s, width])
        column += sum(dec.segment_widths)
        length_column += len(dec.segment_widths)
    header = [
        _WIRE_MODE[qual_bits], len(widths), flags_offset, len(plans),
        len(entries), len(slots), column, length_column,
    ] + [int(x) for x in BAM_REVERSE_COMPLEMENT]
    assert len(header) == _HEADER
    program = np.array(
        header + sum(segments, []) + sum(plans, []) + sum(entries, []),
        dtype=np.int32,
    )
    return TokenLayout(
        widths=list(widths),
        qual_bits=qual_bits,
        slots=slots,
        token_columns=token_columns,
        length_columns=length_columns,
        token_cols=column,
        length_cols=length_column,
        program=program,
    )


# --- plain version --------------------------------------------------------


def unpack_h2d_blob(widths: list[int], blob: torch.Tensor, qual_bits=6, qcb=None, ccb=None):
    """Torch port of ``_unpack_h2d_blob``: (segments, qcfail, pad, forced)
    with segments a list of (code, qual, length) int32 tensors."""
    segments = []
    offset = 0
    n = blob.shape[0]

    def nibbles(packed):
        return torch.stack([packed & 15, packed >> 4], dim=2).reshape(n, 2 * packed.shape[1])

    def length_at(offset, w):
        if _length_bytes(w) == 1:
            return blob[:, offset].to(torch.int32), offset + 1
        value = blob[:, offset].to(torch.int32) | (blob[:, offset + 1].to(torch.int32) << 8)
        return value, offset + 2

    for w in widths:
        cw, qw = _lane_bytes(w, qual_bits)
        if qual_bits == JOINT4:
            idx = nibbles(blob[:, offset : offset + qw].to(torch.int32)).long()
            code = ccb.to(torch.int32)[idx]
            qual = qcb.to(torch.int32)[idx]
            length, offset = length_at(offset + qw, w)
            segments.append((code, qual, length))
            continue
        code = nibbles(blob[:, offset : offset + cw].to(torch.int32))
        offset += cw
        packed = blob[:, offset : offset + qw].to(torch.int32)
        if qual_bits == 6:
            q3 = packed.reshape(n, w // 4, 3)
            qual = torch.stack(
                [
                    q3[:, :, 0] & 63,
                    (q3[:, :, 0] >> 6) | ((q3[:, :, 1] & 15) << 2),
                    (q3[:, :, 1] >> 4) | ((q3[:, :, 2] & 3) << 4),
                    q3[:, :, 2] >> 2,
                ],
                dim=2,
            ).reshape(n, w)
        elif qual_bits == 2:
            idx = torch.stack(
                [packed & 3, (packed >> 2) & 3, (packed >> 4) & 3, packed >> 6], dim=2
            ).reshape(n, w)
            qual = qcb.to(torch.int32)[idx.long()]
        else:
            qual = qcb.to(torch.int32)[nibbles(packed).long()]
        length, offset = length_at(offset + qw, w)
        segments.append((code, qual, length))
    flags = blob[:, offset].to(torch.int32)
    return segments, (flags & 1) > 0, (flags & 2) > 0, (flags & 4) > 0


def apply_plans_plain(dec, segments):
    """Torch port of ``apply_plans``: one (code, quality, length) triple
    per observation segment, positions past the in-read extent zeroed. The
    static forward window and the general clipped gather are kept apart
    exactly as in the original (they differ when a length exceeds the
    segment width, which the wire never sends)."""
    revcomp = torch.from_numpy(BAM_REVERSE_COMPLEMENT.astype(np.int64))
    outputs = [[] for _ in dec.segment_widths]
    out_lengths = [[] for _ in dec.segment_widths]
    for plan in dec.plans:
        code, quality, length = segments[plan.input_segment_index]
        n, w_in = code.shape
        device = code.device
        length = length.to(torch.int32)
        if plan.start < 0:
            start = torch.clamp(length + plan.start, min=0)
        else:
            start = torch.where(plan.start > length, 0, plan.start).to(torch.int32)
        if not plan.end_terminated:
            end = length
        elif plan.end < 0:
            end = torch.clamp(length + plan.end, min=0)
        else:
            end = torch.clamp(length, max=plan.end).to(torch.int32)
        size = torch.clamp(end - start, min=0)
        offsets = torch.arange(plan.width, dtype=torch.int32, device=device)[None, :]
        valid = offsets < size[:, None]
        if w_in == 0:
            piece_code = torch.zeros((n, plan.width), dtype=torch.int32, device=device)
            piece_qual = torch.zeros_like(piece_code)
        elif not plan.reverse_complement and plan.start >= 0:
            hi_end = plan.start + plan.width
            code_p = code.to(torch.int32)
            qual_p = quality.to(torch.int32)
            if w_in < hi_end:
                code_p = torch.nn.functional.pad(code_p, (0, hi_end - w_in))
                qual_p = torch.nn.functional.pad(qual_p, (0, hi_end - w_in))
            piece_code = code_p[:, plan.start : hi_end]
            piece_qual = qual_p[:, plan.start : hi_end]
            if plan.start > 0:
                shorter = (plan.start > length)[:, None]
                piece_code = torch.where(shorter, code_p[:, : plan.width], piece_code)
                piece_qual = torch.where(shorter, qual_p[:, : plan.width], piece_qual)
            piece_code = torch.where(valid, piece_code, 0)
            piece_qual = torch.where(valid, piece_qual, 0)
        else:
            if plan.reverse_complement:
                gather = end[:, None] - 1 - offsets
            else:
                gather = start[:, None] + offsets
            gather = torch.clamp(gather, 0, max(w_in - 1, 0)).long()
            piece_code = torch.gather(code.to(torch.int32), 1, gather)
            piece_qual = torch.gather(quality.to(torch.int32), 1, gather)
            if plan.reverse_complement:
                piece_code = revcomp.to(device)[piece_code.long()].to(torch.int32)
            piece_code = torch.where(valid, piece_code, 0)
            piece_qual = torch.where(valid, piece_qual, 0)
        outputs[plan.output_segment_index].append((piece_code, piece_qual))
        out_lengths[plan.output_segment_index].append(size)

    result = []
    for s, width in enumerate(dec.segment_widths):
        if outputs[s]:
            seg_code = torch.cat([c for c, _ in outputs[s]], dim=1)
            seg_qual = torch.cat([q for _, q in outputs[s]], dim=1)
            seg_len = sum(out_lengths[s])
        else:
            n = segments[0][0].shape[0]
            device = segments[0][0].device
            seg_code = torch.zeros((n, width), dtype=torch.int32, device=device)
            seg_qual = torch.zeros_like(seg_code)
            seg_len = torch.zeros(n, dtype=torch.int32, device=device)
        result.append((seg_code, seg_qual, seg_len))
    return result


def unpack_tokens_plain(instrument, layout: TokenLayout, blob, ccb=None, qcb=None) -> Tokens:
    segments, qcfail, pad, forced = unpack_h2d_blob(
        layout.widths, blob, layout.qual_bits, qcb=qcb, ccb=ccb
    )
    n = blob.shape[0]
    tokens = _empty_tokens(layout, n, blob.device)
    for slot, position in enumerate(layout.slots):
        dec = instrument.decoders[position]
        observation = apply_plans_plain(dec, segments)
        codes, quals, lengths, short = tokens.observation(layout, slot)
        codes.copy_(torch.cat([c for c, _, _ in observation], dim=1))
        quals.copy_(torch.cat([q for _, q, _ in observation], dim=1))
        flag = torch.zeros(n, dtype=torch.bool, device=blob.device)
        for s, ((_, _, length), width) in enumerate(zip(observation, dec.segment_widths)):
            lengths[:, s] = length
            flag |= length < width
        short.copy_(flag)
    tokens.qcfail.copy_(qcfail)
    tokens.pad.copy_(pad)
    tokens.forced.copy_(forced)
    return tokens


def unpack_tokens_columns(layout: TokenLayout, blob, ccb=None, qcb=None) -> Tokens:
    """The column plan's arithmetic in torch (CPU; for the tests), from
    ``column_table`` alone: per length column its items' plans, each
    plan's extent resolved once for every read, its width's code and
    quality bytes written at its first token column (zero past its size,
    and in columns no plan covers), its size added to its length column; a
    read's short flag for a slot set by each of the slot's lengths below
    its segment's width; the bases decoded as unpack_h2d_blob decodes
    them. Equal to ``unpack_tokens_plain``."""
    table = column_table(layout).astype(np.int64)
    token_cols, length_cols, n_slots, _, _, items_at, plans_at, lcols_at, chunks_at = (int(x) for x in table[:9])
    items = table[items_at:plans_at].reshape(-1, 4)
    records = table[plans_at:lcols_at].reshape(-1, 8)
    lcols = table[lcols_at:chunks_at].reshape(-1, 4)
    n = blob.shape[0]
    if layout.qual_bits == RAW:
        segments, offset = [], 0
        for w in layout.widths:
            rows = blob[:, offset : offset + 2 * w + 2].to(torch.int32)
            segments.append((rows[:, :w], rows[:, w : 2 * w], rows[:, 2 * w] | (rows[:, 2 * w + 1] << 8)))
            offset += 2 * w + 2
        flags = blob[:, offset].to(torch.int32)
        qcfail, pad, forced = (flags & 1) > 0, (flags & 2) > 0, (flags & 4) > 0
    else:
        segments, qcfail, pad, forced = unpack_h2d_blob(layout.widths, blob, layout.qual_bits, qcb=qcb, ccb=ccb)
    revcomp = torch.from_numpy(BAM_REVERSE_COMPLEMENT.astype(np.int64))
    codes = torch.zeros((n, token_cols), dtype=torch.int64)
    quals = torch.zeros((n, token_cols), dtype=torch.int64)
    lengths = torch.zeros((n, length_cols), dtype=torch.int64)
    for column, (first, end, _, _) in enumerate(lcols.tolist()):
        for plan_first, plan_end, _, _ in items[first:end].tolist():
            for start, stop, at, flags, width, *_ in records[plan_first:plan_end].tolist():
                code, qual, length = segments[flags >> 8]
                w_in = code.shape[1]
                length = length.to(torch.int64)
                lo = torch.clamp(length + start, min=0) if start < 0 else torch.where(length < start, 0, start)
                if not flags & 2:
                    hi = length
                else:
                    hi = torch.clamp(length + stop, min=0) if stop < 0 else torch.clamp(length, max=stop)
                size = torch.clamp(hi - lo, min=0)
                lengths[:, column] += size
                j = torch.arange(width)[None, :]
                reverse = bool(flags & 4)
                pos = hi[:, None] - 1 - j if reverse else lo[:, None] + j
                inside = (pos < w_in) if not reverse and start >= 0 else torch.ones_like(pos, dtype=torch.bool)
                valid = (j < size[:, None]) & inside & (w_in > 0)
                pos = torch.clamp(pos, 0, max(w_in - 1, 0))
                piece_code = torch.gather(code.to(torch.int64), 1, pos) if w_in else torch.zeros_like(pos)
                piece_qual = torch.gather(qual.to(torch.int64), 1, pos) if w_in else torch.zeros_like(pos)
                if reverse:
                    piece_code = revcomp[piece_code]
                codes[:, at : at + width] = torch.where(valid, piece_code, 0)
                quals[:, at : at + width] = torch.where(valid, piece_qual, 0)
    shorter = (lengths < torch.from_numpy(lcols[:, 2])[None, :]).to(torch.int64)
    short = torch.zeros((n, n_slots), dtype=torch.int64).index_add_(1, torch.from_numpy(lcols[:, 3]), shorter) > 0
    return Tokens(codes=codes.to(torch.uint8), quals=quals.to(torch.uint8), lengths=lengths.to(torch.int32),
                  short=short, qcfail=qcfail, pad=pad, forced=forced)


# --- kernel wrapper ---------------------------------------------------------


def _empty_tokens(layout: TokenLayout, n: int, device) -> Tokens:
    return Tokens(
        codes=torch.empty((n, layout.token_cols), dtype=torch.uint8, device=device),
        quals=torch.empty((n, layout.token_cols), dtype=torch.uint8, device=device),
        lengths=torch.empty((n, layout.length_cols), dtype=torch.int32, device=device),
        short=torch.empty((n, len(layout.slots)), dtype=torch.bool, device=device),
        qcfail=torch.empty(n, dtype=torch.bool, device=device),
        pad=torch.empty(n, dtype=torch.bool, device=device),
        forced=torch.empty(n, dtype=torch.bool, device=device),
    )


def _launch(lib, layout: TokenLayout, program: torch.Tensor, blob, ccb, qcb, stream) -> Tokens:
    """Run the kernel on `blob` (no device checks, no count) with the
    layout's plan for its row size (unpack_plan, cached on the layout)."""
    from .build import check

    n = blob.shape[0]
    tokens = _empty_tokens(layout, n, blob.device)
    key = (blob.shape[1], program.numel())
    plan = layout.block_plans.get(key)
    if plan is None:
        plan = layout.block_plans[key] = unpack_plan(layout, *key)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    outputs = (tokens.codes.data_ptr(), tokens.quals.data_ptr(), tokens.lengths.data_ptr(), tokens.short.data_ptr(),
               tokens.qcfail.data_ptr(), tokens.pad.data_ptr(), tokens.forced.data_ptr())
    if isinstance(plan, BlockPlan):
        ints = plan.ints()
        status = lib.phq_unpack_tokens(blob.data_ptr(), n, blob.shape[1], program.data_ptr(), program.numel(),
                                       ptr(ccb), ptr(qcb), ints.ctypes.data, *outputs, stream)
    else:
        table = layout.column_tables.get(str(blob.device))
        if table is None:
            table = layout.column_tables[str(blob.device)] = torch.from_numpy(column_table(layout)).to(blob.device)
        head = np.array([layout.token_cols, layout.length_cols, len(layout.slots), 0, len(plan.chunks)],
                        dtype=np.int32)
        status = lib.phq_unpack_columns(blob.data_ptr(), n, blob.shape[1], program.data_ptr(), ptr(ccb), ptr(qcb),
                                        table.data_ptr(), head.ctypes.data, int(plan.stage_wire), plan.shared_bytes,
                                        int(plan.in_place), *outputs, stream)
    check(status, "unpack_tokens")
    return tokens


def unpack_tokens(instrument, layout: TokenLayout, program, blob, ccb=None, qcb=None) -> Tokens:
    """K3. ``blob`` is the (N, bytes) uint8 wire blob; ``ccb``/``qcb`` the
    (16,) or (4,) int32 codebooks of the codebook wires. ``program`` is
    ``layout.program`` as an int32 tensor on the blob's device (the decode
    step keeps it there)."""
    if blob.device.type == "cpu":
        return unpack_tokens_plain(instrument, layout, blob, ccb=ccb, qcb=qcb)
    if blob.device.type != "cuda":
        raise ValueError(f"unpack_tokens: unsupported device {blob.device}")
    global launches
    from .build import library

    if blob.dtype != torch.uint8 or blob.dim() != 2 or not blob.is_contiguous():
        raise ValueError("unpack_tokens: blob must be a contiguous (N, bytes) uint8 tensor")
    codebooks = [t for t in (ccb, qcb) if t is not None]
    for t in codebooks:
        if t.device != blob.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("unpack_tokens: codebooks must be contiguous int32 on the blob's device")
    if layout.qual_bits == JOINT4 and (ccb is None or qcb is None or ccb.numel() != 16 or qcb.numel() != 16):
        raise ValueError("unpack_tokens: the j4 wire needs (16,) ccb and qcb")
    if layout.qual_bits in (2, 4) and (qcb is None or qcb.numel() != (4 if layout.qual_bits == 2 else 16)):
        raise ValueError("unpack_tokens: the codebook wire needs its qcb")
    if program.device != blob.device or program.dtype != torch.int32:
        raise ValueError("unpack_tokens: program must be int32 on the blob's device")
    stream = torch.cuda.current_stream(blob.device).cuda_stream
    tokens = _launch(library(), layout, program, blob, ccb, qcb, stream)
    launches += 1
    return tokens


def apply_plans(dec, segments):
    """``apply_plans`` on already unpacked segments, a list of (code,
    quality, length) integer tensors: one int32 (code, quality, length)
    triple per observation segment of `dec`. CPU tensors run the plain
    version; on CUDA the segments are laid out as raw byte rows (codes
    and qualities below 256, lengths below 65536) and K3 extracts the
    tokens."""
    device = segments[0][0].device
    if device.type == "cpu":
        return apply_plans_plain(dec, segments)
    if device.type != "cuda":
        raise ValueError(f"apply_plans: unsupported device {device}")
    from types import SimpleNamespace

    n = segments[0][0].shape[0]
    columns = []
    for code, quality, length in segments:
        length = length.to(torch.int32)
        columns += [
            code.to(torch.uint8),
            quality.to(torch.uint8),
            (length & 255).to(torch.uint8)[:, None],
            (length >> 8).to(torch.uint8)[:, None],
        ]
    columns.append(torch.zeros((n, 1), dtype=torch.uint8, device=device))  # flags
    blob = torch.cat(columns, dim=1)
    layout = _layout([(0, dec)], [code.shape[1] for code, _, _ in segments], RAW)
    program = torch.from_numpy(layout.program).to(device)
    tokens = unpack_tokens(SimpleNamespace(decoders=[dec]), layout, program, blob)
    codes, quals, lengths, _ = tokens.observation(layout, 0)
    result = []
    start = 0
    for s, width in enumerate(dec.segment_widths):
        result.append(
            (
                codes[:, start : start + width].to(torch.int32),
                quals[:, start : start + width].to(torch.int32),
                lengths[:, s].contiguous(),
            )
        )
        start += width
    return result
