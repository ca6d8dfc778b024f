"""K3's block plan (kernels/unpack.py:block_plan) on the CPU: how a block
of 128 reads stages its rows in shared memory, for every wire mode, the
raw rows of apply_plans, programs of 2029, ~3000 and ~60,000 ints, rows
too wide to stage and 2048 length columns, and where the layout takes the
column plan instead. The kernel itself runs only on the card
(tests/test_torch_kernels.py, chip_smoke.py)."""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from pheniqs_tpu_torch.device import wire
from pheniqs_tpu_torch.device.flagship import flagship_ontology, mdd_flagship_ontology
from pheniqs_tpu_torch.device.instrument import DeviceDecoder, TokenPlan, compile_instrument
from pheniqs_tpu_torch.kernels import unpack

GATHER = [
    TokenPlan(0, -8, 0, False, False, 0, 8),
    TokenPlan(0, 2, 10, True, True, 0, 8),
    TokenPlan(1, 0, -2, True, False, 1, 6),
    TokenPlan(1, 5, 12, True, False, 1, 7),
    TokenPlan(0, -6, -1, True, True, 2, 5),
]


def _gather_instrument():
    return SimpleNamespace(decoders=[DeviceDecoder("pamld", "sample", 1, True, GATHER, [16, 13, 5])])


def _row_bytes(widths, qual_bits) -> int:
    """A wire row's bytes: the flags byte follows every segment."""
    return unpack._segment_table(widths, qual_bits)[1] + 1


def _layouts():
    """(label, layout, row bytes) of every case the plan must take."""
    cases = []
    flagship = compile_instrument(flagship_ontology(), "cpu")
    mdd = compile_instrument(mdd_flagship_ontology(), "cpu")
    for mode in (6, 2, 4, wire.JOINT4):
        widths = [8, 8, 28]
        for label, instrument in (("flagship", flagship), ("mdd", mdd)):
            layout = unpack.token_layout(instrument, widths, mode)
            cases.append((f"{label} {mode}", layout, _row_bytes(widths, mode)))
        layout = unpack.token_layout(_gather_instrument(), [24, 12], mode)
        cases.append((f"gather {mode}", layout, _row_bytes([24, 12], mode)))
    raw = unpack._layout([(0, _gather_instrument().decoders[0])], [24, 13], unpack.RAW)
    cases.append(("raw", raw, _row_bytes([24, 13], unpack.RAW)))
    # rows too wide to stage at 32 reads a block: raw segments of 3000 positions
    wide = unpack._layout([(0, _gather_instrument().decoders[0])], [3000, 3000], unpack.RAW)
    cases.append(("raw 2 x 3000", wide, _row_bytes([3000, 3000], unpack.RAW)))
    # programs at the kernel's former 2048-int limit and past it: 8
    # observation segments, 219, 330 and 6600 plans (the last too large to
    # stage beside the rows)
    for label, count in (("program 2048", 219), ("program 3000", 330), ("program 60000", 6600)):
        plans = [TokenPlan(p % 2, p % 20, p % 20 + 1 + p % 3, True, bool(p % 5 == 0), p % 8, 1 + p % 3)
                 for p in range(count)]
        widths = [sum(plan.width for plan in plans if plan.output_segment_index == s) for s in range(8)]
        big = unpack.token_layout(
            SimpleNamespace(decoders=[DeviceDecoder("mdd", "sample", 1, True, plans, widths)]), [24, 24], wire.JOINT4)
        cases.append((label, big, _row_bytes([24, 24], wire.JOINT4)))
    # 1024 MDD decoders of two segments: 2048 length columns, whose rows
    # at 32 reads pass a block's shared memory
    plans = [TokenPlan(0, 0, 4, True, False, 0, 4), TokenPlan(0, 4, 8, True, False, 1, 4)]
    many = SimpleNamespace(decoders=[DeviceDecoder("mdd", "sample", 1, True, plans, [4, 4])] * 1024)
    cases.append(("lengths 2048", unpack.token_layout(many, [8], wire.JOINT4), _row_bytes([8], wire.JOINT4)))
    return cases


CASES = _layouts()


@pytest.mark.parametrize("label,layout,row_bytes", CASES, ids=[c[0] for c in CASES])
def test_block_plan_fits_and_aligns(label, layout, row_bytes):
    """The block plan stages 128 reads: the staging areas (program, wire
    rows with their 16-byte lead, codes, qualities, lengths, short flags,
    three flags) lie 16-byte aligned one after another inside the shared
    bytes the plan asks for; a staged token row has an odd number of words;
    every block's span of every output starts 16-byte aligned given an
    aligned base. It is taken where those bytes fit two blocks an SM (the
    flagship's, the MDD flagship's and the gather's layouts on every wire,
    the raw rows), and the column plan elsewhere (long programs, rows too
    wide to stage, 2048 length columns)."""
    plan = unpack.block_plan(layout, row_bytes)
    reads = plan.reads
    assert reads == unpack.MAX_BLOCK_READS
    slots = len(layout.slots)
    areas = [
        ("program", 0, 4 * layout.program.size),
        ("wire", plan.wire_at, reads * row_bytes + 16),
        ("codes", plan.codes_at, reads * plan.token_pitch),
        ("quals", plan.quals_at, reads * plan.token_pitch),
        ("lengths", plan.lengths_at, 4 * reads * plan.length_pitch),
        ("short", plan.short_at, reads * slots),
        ("flags", plan.flags_at, 3 * reads),
    ]
    end = 0
    for name, at, size in areas:
        assert at % 16 == 0 and at >= end, (name, at, end)
        end = at + size
    assert end <= plan.shared_bytes
    assert plan.token_pitch >= layout.token_cols and plan.token_pitch % 4 == 0
    assert layout.token_cols == 0 or (plan.token_pitch // 4) % 2 == 1
    assert plan.length_pitch >= layout.length_cols
    assert layout.length_cols == 0 or plan.length_pitch % 2 == 1
    for block in (1, 2, 3, 1000):
        r0 = block * reads
        for element, columns in ((1, layout.token_cols), (4, layout.length_cols), (1, slots), (1, 1)):
            assert (r0 * columns * element) % 16 == 0
    ints = plan.ints()
    assert ints.dtype == np.int32 and ints[0] == reads and ints[-1] == plan.shared_bytes
    chosen = unpack.unpack_plan(layout, row_bytes)
    blocked = label.startswith(("flagship", "mdd", "gather", "raw")) and "3000" not in label
    assert (chosen == plan) == blocked and (plan.shared_bytes <= unpack.BLOCK_SHARED) == blocked
    if label == "program 2048":
        assert layout.program.size > 2000
    if label in ("program 3000", "program 60000"):
        assert layout.program.size > 2048
    if label == "program 60000":
        # the program alone passes a block's shared memory
        assert 4 * layout.program.size > unpack.SHARED_BYTES
    if label == "lengths 2048":
        assert layout.length_cols == 2048


def test_block_plan_matches_the_kernel():
    """The plan's ints are the kernel's PhqUnpackPlan, field for field, and
    its reads the kernel's."""
    source = (Path(unpack.__file__).parent.parent / "csrc" / "unpack_tokens.cu").read_text()
    struct = re.search(r"struct PhqUnpackPlan \{(.*?)\};", source, re.S).group(1)
    fields = re.findall(r"\w+(?=[,;])", struct)
    plan = unpack.block_plan(CASES[0][1], CASES[0][2])
    assert len(fields) == plan.ints().size == int(re.search(r"#define PHQ_UNPACK_PLAN_INTS (\d+)", source).group(1))
    names = ["reads", "token_pitch", "length_pitch", "wire_at", "codes_at", "quals_at", "lengths_at", "short_at",
             "flags_at", "shared_bytes"]
    assert fields == names
    assert [getattr(plan, name) for name in names] == [int(x) for x in plan.ints()]
    assert int(re.search(r"#define PHQ_UNPACK_MAX_READS (\d+)", source).group(1)) == unpack.MAX_BLOCK_READS


def test_block_plan_steps_down():
    """The block plan is taken while its staging fits BLOCK_SHARED (two
    blocks an SM); one byte less, the layout steps down to the column
    plan."""
    label, layout, row_bytes = CASES[0]
    full = unpack.block_plan(layout, row_bytes)
    old = unpack.BLOCK_SHARED
    try:
        unpack.BLOCK_SHARED = full.shared_bytes
        assert unpack.unpack_plan(layout, row_bytes) == full
        unpack.BLOCK_SHARED = full.shared_bytes - 1
        assert unpack.unpack_plan(layout, row_bytes) == unpack.column_plan(layout, row_bytes)
    finally:
        unpack.BLOCK_SHARED = old


def test_launch_passes_the_cached_plan():
    """The wrapper's launch hands the kernel's entry the plan for the
    blob's row size and keeps it on the layout, so later batches reuse it."""
    import ctypes

    import torch

    layout = unpack.token_layout(compile_instrument(flagship_ontology(), "cpu"), [8, 8, 28], wire.JOINT4)
    seen = []

    class Library:
        @staticmethod
        def phq_unpack_tokens(*args):
            seen.append(list((ctypes.c_int32 * unpack.BlockPlan.__dataclass_fields__.__len__())
                             .from_address(args[7])))
            return 0

    blob = torch.zeros((300, _row_bytes([8, 8, 28], wire.JOINT4)), dtype=torch.uint8)
    program = torch.from_numpy(layout.program)
    for _ in range(2):
        unpack._launch(Library, layout, program, blob, None, None, None)
    key = (blob.shape[1], layout.program.size)
    assert list(layout.block_plans) == [key]
    expected = unpack.block_plan(layout, blob.shape[1]).ints().tolist()
    assert seen == [expected, expected]
