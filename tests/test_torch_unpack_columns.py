"""K3's column plan on the CPU (kernels/unpack.py: unpack_plan,
column_table, ColumnPlan, unpack_tokens_columns): which layouts take it,
what its tables hold, and its arithmetic, walked by a torch twin over the
tables, against the plain version and the JAX package's _unpack_h2d_blob
+ apply_plans. The kernel itself runs only on the card
(tests/test_torch_kernels.py -m cuda, chip_smoke.py). Tokens are integers:
every comparison is exact."""

import ctypes
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pheniqs_tpu.device import classify as jax_classify
from pheniqs_tpu.device.step import _unpack_h2d_blob
from pheniqs_tpu_torch.device import wire
from pheniqs_tpu_torch.device.flagship import (
    flagship_ontology,
    mdd_flagship_ontology,
    whitelist_flagship_ontology,
    wide_mdd_ontology,
)
from pheniqs_tpu_torch.device.instrument import DeviceDecoder, TokenPlan, compile_instrument
from pheniqs_tpu_torch.kernels import unpack
from test_torch_unpack import CASES, GATHER


def _program_decoders(count: int):
    """Three decoders of `count` token plans in all over two wire segments
    (24 + 32; negative starts, reverse complement, several plans into one
    observation segment): chip_smoke.program_blob's instrument."""
    decoders = []
    for d in range(3):
        plans = [TokenPlan(p % 2, (p % 20) - (6 if p % 7 == 0 else 0), p % 20 + 1 + p % 3, bool(p % 4),
                           p % 5 == 0, p % 6, 1 + p % 3) for p in range(d, count, 3)]
        out = [sum(plan.width for plan in plans if plan.output_segment_index == k) for k in range(6)]
        decoders.append(DeviceDecoder("mdd" if d == 1 else "pamld", "cellular", d, True, plans, out))
    return decoders


def _length_decoders():
    """Eight MDD decoders of 256 one-position segments over one 256-position
    wire segment, a fifth reverse complemented: 2048 length columns
    (chip_smoke.lengths_blob's instrument)."""
    decoders = []
    for d in range(8):
        plans = [TokenPlan(0, (k + d) % 256, (k + d) % 256 + 1, True, k % 5 == 0, k, 1) for k in range(256)]
        decoders.append(DeviceDecoder("mdd", "cellular", d, True, plans, [1] * 256))
    return decoders


#: (label, decoders, wire segment widths, wire modes) of the twin's cases
TWIN_CASES = (
    ("gather", [DeviceDecoder("pamld", "sample", 1, True, GATHER, [16, 13, 5])], [24, 12], (6, 2, 4, "j4")),
    ("program 3000", _program_decoders(330), [24, 32], ("j4", 6)),
    ("program 10000", _program_decoders(1100), [24, 32], ("j4",)),
    ("lengths 2048", _length_decoders(), [256], ("j4",)),
)


def _blob(widths, mode, n: int, seed: int):
    """(segments, blob, ccb, qcb): `n` random reads of wire segments
    `widths` on the `mode` wire, each segment of a random length, a tenth
    of them qcfail."""
    rng = np.random.default_rng(seed)
    segments = [(rng.choice([1, 2, 4, 8, 15], size=(n, w)).astype(np.int32),
                 rng.choice([2, 23, 37], size=(n, w)).astype(np.int32),
                 rng.integers(0, w + 1, size=n).astype(np.int32)) for w in widths]
    ccb = qcb = lut = None
    if mode == "j4":
        code = np.concatenate([c.ravel() for c, _, _ in segments])
        qual = np.concatenate([q.ravel() for _, q, _ in segments])
        ccb, qcb, lut_idx, lut_exact = wire.sense_joint_codebook(np.unique(code.astype(np.int64) << 8 | qual))
        lut = (lut_idx, lut_exact)
    elif mode != 6:
        _, qcb, lut_idx, lut_exact = wire.sense_qual_codebook([2, 23, 37], str(mode))
        lut = (lut_idx, lut_exact)
    blob = wire.pack_h2d_blob(widths, segments, rng.random(n) < 0.1, qual_bits=mode, qual_lut=lut)
    return segments, blob, ccb, qcb


def _row_bytes(widths, mode) -> int:
    return unpack._segment_table(widths, mode)[1] + 1


@pytest.mark.parametrize("label,layout,row_bytes", CASES, ids=[c[0] for c in CASES])
def test_column_plan_exactly_where_the_block_plan_is_not_whole(label, layout, row_bytes):
    """unpack_plan gives the column plan exactly where a block plan would
    stage fewer than 128 reads a block or anything in place (its first
    choice, everything staged for 128 reads, passing a block's shared
    memory), or would stage past BLOCK_SHARED (one block an SM: the
    programs of ~2,000 and ~3,000 ints), and the block plan everywhere
    else."""
    block = unpack.block_plan(layout, row_bytes)
    partial = block.shared_bytes > unpack.SHARED_BYTES
    plan = unpack.unpack_plan(layout, row_bytes)
    if partial or block.shared_bytes > unpack.BLOCK_SHARED:
        assert plan == unpack.column_plan(layout, row_bytes)
    else:
        assert plan == block and plan.reads == unpack.MAX_BLOCK_READS
    expected = label.startswith(("program", "lengths", "raw 2 x 3000"))
    assert isinstance(plan, unpack.ColumnPlan) == expected
    assert partial == label.startswith(("program 60000", "lengths", "raw 2 x 3000"))


@pytest.mark.parametrize("name", ["flagship", "mdd flagship", "whitelist", "wide mdd"])
def test_flagship_layouts_keep_the_block_plan(name):
    """The flagship, MDD flagship and whitelist layouts (the whitelist's
    decoders at 2048 barcodes: the layout depends only on their token
    plans) and the wide MDD instrument's keep the block plan, R = 128,
    everything staged, on every wire."""
    ontology = {"flagship": flagship_ontology, "mdd flagship": mdd_flagship_ontology,
                "whitelist": lambda: whitelist_flagship_ontology(cellular_barcodes=2048),
                "wide mdd": wide_mdd_ontology}[name]()
    instrument = compile_instrument(ontology, "cpu")
    widths = [152, 8, 8, 28] if name == "wide mdd" else [8, 8, 28]
    for mode in (6, 2, 4, "j4"):
        layout = unpack.token_layout(instrument, widths, mode)
        plan = unpack.unpack_plan(layout, _row_bytes(widths, mode))
        assert isinstance(plan, unpack.BlockPlan) and plan.reads == 128


@pytest.mark.parametrize("label,decoders,widths,modes", TWIN_CASES, ids=[c[0] for c in TWIN_CASES])
def test_column_table(label, decoders, widths, modes):
    """The column table: its header's counts and offsets (16-byte records);
    every plan once, in length column order, with its start, end, first
    token column, width and flags; each length column's plans cut into
    items of at most ITEM_PLANS, in order; each length column's item
    range, observation width and decoder slot; and every token column a
    plan fills inside that plan's columns, no two plans overlapping."""
    instrument = SimpleNamespace(decoders=decoders)
    layout = unpack.token_layout(instrument, widths, "j4")
    table = unpack.column_table(layout)
    assert table.dtype == np.int32
    token_cols, length_cols, slots, n_items, n_chunks, items_at, plans_at, lcols_at, chunks_at = table[:9]
    n_plans = sum(len(d.plans) for d in decoders)
    assert (token_cols, length_cols, slots) == (layout.token_cols, layout.length_cols, len(layout.slots))
    assert not table[9:16].any() and items_at == 16
    assert [plans_at, lcols_at, chunks_at] == [16 + 4 * n_items, 16 + 4 * n_items + 8 * n_plans,
                                               16 + 4 * n_items + 8 * n_plans + 4 * length_cols]
    assert table.size == chunks_at + 12 * n_chunks
    items = table[items_at:plans_at].reshape(-1, 4)
    records = table[plans_at:lcols_at].reshape(-1, 8)
    lcols = table[lcols_at:chunks_at].reshape(-1, 4)
    chunks = table[chunks_at:].reshape(-1, 12)
    # the chunks tile the slots in order, each with its slots' column,
    # length column and item ranges
    assert [tuple(c[6:9]) for c in chunks] == [(a, b, int(staged)) for a, b, staged in unpack.column_chunks(layout)]
    assert chunks[0, 6] == 0 and chunks[-1, 7] == slots and (chunks[1:, 6] == chunks[:-1, 7]).all()
    for c0, c1, l0, l1, i0, i1, d0, d1, *_ in chunks:
        assert (c0, c1) == (layout.token_columns[d0][0], sum(layout.token_columns[d1 - 1]))
        assert (l0, l1) == (layout.length_columns[d0][0], sum(layout.length_columns[d1 - 1]))
        assert (i0, i1) == (lcols[l0, 0], lcols[l1 - 1, 1])
    expected = []
    for slot, dec in enumerate(decoders):
        c0, _ = layout.token_columns[slot]
        l0, _ = layout.length_columns[slot]
        starts = np.concatenate([[0], np.cumsum(dec.segment_widths)[:-1]])
        filled = [0] * len(dec.segment_widths)
        for plan in dec.plans:
            s = plan.output_segment_index
            flags = int(plan.end_terminated) << 1 | int(plan.reverse_complement) << 2 | plan.input_segment_index << 8
            expected.append((l0 + s, plan.start, plan.end, c0 + starts[s] + filled[s], flags, plan.width))
            filled[s] += plan.width
        assert list(lcols[l0 : l0 + len(dec.segment_widths), 2]) == list(dec.segment_widths)
        assert (lcols[l0 : l0 + len(dec.segment_widths), 3] == slot).all()
    expected.sort(key=lambda row: row[0])  # a stable sort: plan order within a length column
    columns = np.array([row[0] for row in expected])
    np.testing.assert_array_equal(records[:, :5], np.array([row[1:] for row in expected]))
    assert not records[:, 5:].any()
    covered = np.zeros(token_cols, int)
    for start, _, column, _, width, *_ in records:
        covered[column : column + width] += 1
    assert covered.max() <= 1
    assert lcols[0, 0] == 0 and lcols[-1, 1] == n_items and (lcols[1:, 0] == lcols[:-1, 1]).all()
    for column, (first, end, _, _) in enumerate(lcols):
        plans = [p for f, e, c, _ in items[first:end] for p in range(f, e)]
        assert (items[first:end, 2] == column).all() and (items[first:end, 3] == 0).all()
        assert all(e - f <= unpack.ITEM_PLANS for f, e, _, _ in items[first:end])
        assert plans == list(np.flatnonzero(columns == column))


@pytest.mark.parametrize("label,decoders,widths,modes", TWIN_CASES, ids=[c[0] for c in TWIN_CASES])
def test_column_twin_matches_plain_and_jax(label, decoders, widths, modes):
    """The column plan's arithmetic (unpack_tokens_columns: each token byte
    from its column's descriptor, each length the sum of its length
    column's plans, a short flag set by each of its slot's lengths below
    the segment's width) equals the
    plain version and JAX's _unpack_h2d_blob + apply_plans, byte for byte,
    on the general gather (every wire), programs past 2048 ints (~3,000 and
    ~10,000) and 2048 length columns."""
    instrument = SimpleNamespace(decoders=decoders)
    n = 48
    for k, mode in enumerate(modes):
        layout = unpack.token_layout(instrument, widths, mode)
        if label.startswith("program"):
            assert layout.program.size > 2048
        if label == "lengths 2048":
            assert layout.length_cols == 2048
        segments, blob, ccb, qcb = _blob(widths, mode, n, seed=len(label) + k)
        books = {} if qcb is None else {"qcb": torch.from_numpy(qcb)}
        if ccb is not None:
            books["ccb"] = torch.from_numpy(ccb)
        twin = unpack.unpack_tokens_columns(layout, torch.from_numpy(blob), **books)
        plain = unpack.unpack_tokens_plain(instrument, layout, torch.from_numpy(blob), **books)
        for field in ("codes", "quals", "lengths", "short", "qcfail", "pad", "forced"):
            assert torch.equal(getattr(twin, field), getattr(plain, field)), field
        jbooks = {key: jnp.asarray(value.numpy()) for key, value in books.items()}
        theirs, qcfail, pad, forced = _unpack_h2d_blob(widths, jnp.asarray(blob), mode, **jbooks)
        for slot, dec in enumerate(decoders):
            codes, quals, lengths, short = twin.observation(layout, slot)
            observation = jax_classify.apply_plans(dec, theirs)
            np.testing.assert_array_equal(codes.numpy(), np.concatenate([np.asarray(c) for c, _, _ in observation], 1))
            np.testing.assert_array_equal(quals.numpy(), np.concatenate([np.asarray(q) for _, q, _ in observation], 1))
            np.testing.assert_array_equal(lengths.numpy(), np.stack([np.asarray(x) for _, _, x in observation], 1))
            expected_short = np.zeros(n, bool)
            for (_, _, length), width in zip(observation, dec.segment_widths):
                expected_short |= np.asarray(length) < width
            np.testing.assert_array_equal(short.numpy(), expected_short)
        for mine, their in ((twin.qcfail, qcfail), (twin.pad, pad), (twin.forced, forced)):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(their))


def test_column_plan_matches_the_kernel():
    """The column table's header is PHQ_COLUMN_HEADER ints and a block owns
    PHQ_COLUMN_READS reads; the chunks keep each block's staging within
    CHUNK_SHARED but for a slot alone, staged up to SHARED_BYTES and in
    place past it; the wire rows are staged where 32 of them take at most
    WIRE_SHARED."""
    source = (Path(unpack.__file__).parent.parent / "csrc" / "unpack_tokens.cu").read_text()
    assert int(re.search(r"#define PHQ_COLUMN_HEADER (\d+)", source).group(1)) == unpack._COLUMN_HEADER
    assert int(re.search(r"#define PHQ_COLUMN_READS (\d+)", source).group(1)) == unpack.COLUMN_READS
    spec_shared = int(re.search(r"#define PHQ_COLUMN_SPEC_SHARED (\d+)", source).group(1))
    assert unpack.COLUMN_SHARED_MAX == 227 * 1024 - 4 * (spec_shared + 32)
    for label, decoders, widths, _ in TWIN_CASES:
        layout = unpack.token_layout(SimpleNamespace(decoders=decoders), widths, "j4")
        plan = unpack.column_plan(layout, _row_bytes(widths, "j4"))
        assert not plan.in_place and plan.stage_wire
        assert [first for first, _, _ in plan.chunks] == [0] + [end for _, end, _ in plan.chunks[:-1]]
        for first, end, staged in plan.chunks:
            size = unpack._slot_bytes(layout, first, end)
            assert size <= unpack.CHUNK_SHARED or end == first + 1
            assert plan.shared_bytes >= size + unpack._round16(32 * _row_bytes(widths, "j4") + 16)
        if label == "lengths 2048":
            assert plan.chunks == tuple((d, d + 1, True) for d in range(8))
    # a slot whose one read passes a block's shared memory: in place
    wide = SimpleNamespace(decoders=[DeviceDecoder("pamld", "cellular", 0, True,
                                                   [TokenPlan(0, 0, 20, True, False, 0, 20)] * 300, [6000])])
    layout = unpack.token_layout(wide, [24], "j4")
    plan = unpack.column_plan(layout, _row_bytes([24], "j4"))
    assert plan.in_place and plan.chunks == ((0, 1, False),)


def test_launch_passes_the_column_plan_and_table():
    """The wrapper's launch hands the column entry the table's device copy
    (made once per layout and device, reused by later batches), its
    header's counts, whether the wire rows are staged, the shared bytes
    and whether a chunk runs in place."""
    layout = unpack.token_layout(SimpleNamespace(decoders=_length_decoders()), [256], "j4")
    seen = []

    class Library:
        @staticmethod
        def phq_unpack_columns(*args):
            seen.append((list((ctypes.c_int32 * 5).from_address(args[7])), *args[8:11], args[6]))
            return 0

    blob = torch.zeros((300, _row_bytes([256], "j4")), dtype=torch.uint8)
    program = torch.from_numpy(layout.program)
    for _ in range(2):
        unpack._launch(Library, layout, program, blob, None, None, None)
    assert list(layout.block_plans) == [(blob.shape[1], layout.program.size)]
    plan = unpack.column_plan(layout, blob.shape[1])
    np.testing.assert_array_equal(layout.column_tables["cpu"].numpy(), unpack.column_table(layout))
    assert seen[0] == seen[1] == ([2048, 2048, 8, 0, 8], 1, plan.shared_bytes, 0, layout.column_tables["cpu"].data_ptr())
