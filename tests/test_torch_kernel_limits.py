"""The inputs the port's CUDA kernels once refused (a PAMLD observation
past 64 positions, MDD past 8 segments or 64 positions, a token program
past 2048 ints, more than 32 decoders): each now has a kernel path. One
case per former limit, on stand-in instruments of DeviceDecoders: the
kernel's plan for it builds on the CPU (the tile loop's instance and slice
plan, the MDD key words and segment table, K3's block plan, K4's decoder
table and K5's masks), and its plain path runs and equals the JAX
package's. The flagships keep the plans they had. What a kernel still
refuses, a decoder that no block of its kernel holds in shared memory
(past 231,392 positions for K1/K7/K8, 29,024 for K6), is refused
with the typed error, and nothing inside the reference's domain is. The
kernels themselves run on the card (tests/test_torch_kernels.py -m cuda,
chip_smoke.py)."""

import contextlib
import ctypes
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import k4_case, k4_tensors
from pheniqs_tpu.device import classify as jax_classify
from pheniqs_tpu.device.step import _counters, _unpack_h2d_blob
from pheniqs_tpu_torch.device import wire
from pheniqs_tpu_torch.device.flagship import flagship_ontology, mdd_flagship_ontology
from pheniqs_tpu_torch.device.instrument import DeviceDecoder, TokenPlan, compile_instrument
from pheniqs_tpu_torch.errors import ConfigurationError
from pheniqs_tpu_torch.kernels import check_kernel_limits, counters, kernel_limits, mdd, pack, pamld, unpack


def _decoder(algorithm, widths, plans_per_segment=1, classifier="sample"):
    """A decoder of `algorithm` reading one token per output segment of
    `widths` from input segment 0 (or `plans_per_segment` one-position
    tokens each)."""
    plans = []
    for s, width in enumerate(widths):
        if plans_per_segment == 1:
            plans.append(TokenPlan(0, sum(widths[:s]), sum(widths[: s + 1]), True, False, s, width))
        else:
            plans += [TokenPlan(0, k, k + 1, True, False, s, 1) for k in range(plans_per_segment)]
    if plans_per_segment != 1:
        widths = [plans_per_segment] * len(widths)
    return DeviceDecoder(algorithm, classifier, 1, True, plans, list(widths), barcode_count=8, width=sum(widths))


def _instrument(decoders):
    return SimpleNamespace(decoders=decoders, used_segments=(0,), pack_plans={})


CASES = {
    "pamld width": [_decoder("pamld", [65])],
    "mdd segments": [_decoder("mdd", [4] * 9)],
    "mdd width": [_decoder("mdd", [40, 25])],
    "decoders": [_decoder("pamld", [8])] * 33,
    "program": [_decoder("pamld", [30], plans_per_segment=30)] * 8,
}


@pytest.mark.parametrize("name", list(CASES))
def test_former_limit_has_a_kernel_plan(name):
    decoders = CASES[name]
    instrument = _instrument(decoders)
    dec = decoders[0]
    w = sum(dec.segment_widths)
    if name == "pamld width":
        assert pamld.instance_width(w) == 0 and pamld.instance_width(pamld.LOOPED_PAST) == 64
        plan = pamld.slice_plan(131072, 384, 336, 128, 132 * 4, 48, 132 * 4)
        assert plan.slices >= 1 and plan.columns()[-1][1] == 384
    elif name.startswith("mdd"):
        table = mdd.segment_table(dec.segment_widths, [1] * len(dec.segment_widths)).reshape(len(dec.segment_widths), -1)
        words = mdd.mask_words(w)
        assert table.shape[1] == 4 + 2 * words and list(table[:, 1]) == list(dec.segment_widths)
        assert list(table[:, 0]) == list(np.cumsum([0] + list(dec.segment_widths[:-1])))
        if w <= 64:
            masks = table[:, 4:].copy().view(np.uint64)
            bits = [sum(int(x) << (64 * m) for m, x in enumerate(row)) for row in masks]
            assert sum(bin(b).count("1") for b in bits) == w and not any(a & b for a, b in zip(bits, bits[1:]))
            assert mdd.key_words(w) == 16
        else:
            # the wide instance: segments by their ranges, keys of whole
            # 16-position runs, a warp's batch of 32 staged reads
            assert words == 0 and mdd.key_words(w) == 4 * -(-w // 16) and mdd.batch_reads(w, 4) == mdd.BATCH_MAX
    elif name == "decoders":
        layout = wire.d2h_layout(instrument, True)
        plan = pack.pack_plan(instrument, True)
        assert plan.staged and layout["qcfail_bytes"] == 5
        qcfail = [(offset, count) for kind, _, count, offset, *_ in plan.fields if kind == pack.BITS]
        assert qcfail == [(layout["qcfail_offset"] + byte, 8 if byte < 4 else 1) for byte in range(5)]
        assert len(counters.decoder_table(instrument).rows) == 33
    else:
        layout = unpack.token_layout(instrument, [32], wire.JOINT4)
        assert layout.program.size > 2048
        plan = unpack.unpack_plan(layout, unpack._segment_table([32], wire.JOINT4)[1] + 1)
        assert isinstance(plan, unpack.BlockPlan) and plan.reads == unpack.MAX_BLOCK_READS


@pytest.mark.parametrize("name", list(CASES))
def test_former_limit_plain_matches_jax(name):
    """The case's plain path on the CPU against the JAX package on the
    same inputs: decisions exact where neither flags a read (PAMLD;
    confidences rtol 1e-5 there), MDD decisions, K4's integer counters
    and K3's tokens exact."""
    rng = np.random.default_rng(len(name))
    decoders = CASES[name]
    dec = decoders[0]
    w = sum(dec.segment_widths)
    n = 256
    if name == "pamld width" or name.startswith("mdd"):
        panel = rng.choice(np.array([1, 2, 4, 8], np.uint8), size=(24, w))
        code = panel[rng.integers(24, size=n)]
        errors = rng.random(code.shape) < 1.0 / w
        code[errors] = rng.choice(np.array([1, 2, 4, 8, 15], np.uint8), size=int(errors.sum()))
        qual = rng.choice(np.array([2, 12, 23, 37], np.uint8), size=code.shape)
        qcfail = rng.random(n) < 0.05
    if name == "pamld width":
        ontology = {"input segment cardinality": 1, "sample": {
            "algorithm": "pamld", "index": 1, "noise": 0.05, "confidence threshold": 0.0,
            "random barcode probability": 4.0**-16, "high quality threshold": 30,
            "high quality distance threshold": 0, "transform": {"token": [f"0::{w}"]},
            "codec": {str(i + 1): {"barcode": ["".join("ACGT"[[1, 2, 4, 8].index(c)] for c in row)],
                                   "concentration": 0.95 / 24, "index": i + 1} for i, row in enumerate(panel)},
        }}
        from pheniqs_tpu.device import compile_instrument as jax_compile

        ours = compile_instrument(ontology, "cpu")
        theirs = jax_classify.pamld_classify_device(
            jax_compile(ontology), jax_compile(ontology).decoders[0], jnp.asarray(code.astype(np.int32)),
            jnp.asarray(qual.astype(np.int32)), jnp.asarray(qcfail), want_uncertain=True)
        mine = pamld.pamld_classify(ours.decoders[0], torch.from_numpy(code), torch.from_numpy(qual),
                                    torch.from_numpy(qcfail), tpq_constants=None, want_uncertain=True,
                                    eps=ours.tpq_analytic_eps)
        settled = ~(mine["uncertain"].numpy() | np.asarray(theirs["uncertain"]))
        assert settled.mean() > 0.5
        for key in ("decoded", "argmax", "distance", "branch", "qcfail"):
            np.testing.assert_array_equal(mine[key].numpy()[settled], np.asarray(theirs[key])[settled], err_msg=key)
        np.testing.assert_allclose(mine["confidence"].numpy()[settled], np.asarray(theirs["confidence"])[settled],
                                   rtol=1e-5, atol=0)
    elif name.startswith("mdd"):
        dec = DeviceDecoder("mdd", "sample", 0, True, dec.plans, list(dec.segment_widths), barcode_count=24, width=w,
                            panel_codes=torch.from_numpy(panel.astype(np.int32)),
                            panel_codes_u8=torch.from_numpy(panel), distance_tolerance=(1,) * len(dec.segment_widths))
        dec.key_table = mdd.key_table_tensor(dec.panel_codes_u8)
        widths = dec.segment_widths
        lengths = np.tile(np.array(widths, np.int32), (n, 1))
        starts = np.concatenate([[0], np.cumsum(widths)[:-1]])
        obs = [(code[:, s : s + ws].astype(np.int32), qual[:, s : s + ws].astype(np.int32), lengths[:, k])
               for k, (s, ws) in enumerate(zip(starts, widths))]
        theirs = jax_classify.mdd_classify_device(dec, [tuple(jnp.asarray(x) for x in o) for o in obs],
                                                  jnp.asarray(qcfail))
        args = (dec, torch.from_numpy(code), torch.from_numpy(qual), torch.from_numpy(lengths), torch.from_numpy(qcfail))
        for mine in (mdd.mdd_classify(*args), mdd.mdd_classify_two_phase(*args)):
            for key in ("decoded", "argmax", "distance", "branch", "qcfail"):
                np.testing.assert_array_equal(mine[key].numpy(), np.asarray(theirs[key]), err_msg=key)
        assert (mine["decoded"] > 0).float().mean() > 0.5
    elif name == "decoders":
        instrument, arrays = k4_case("forced", 2048, seed=33, decoders=(("pamld", 96, 16), ("mdd", 40, 8)) * 16
                                     + (("naive", 0, 0),))
        mine = counters.counters(instrument, *k4_tensors(arrays, "cpu"), True).numpy()
        unsure = arrays["forced"].copy()
        for k, d in enumerate(instrument.decoders):
            if d.algorithm == "pamld":
                unsure |= arrays["uncertain"][k]
        valid = jnp.asarray((~arrays["pad"] & ~unsure).astype(np.float32))
        parts = []
        for k, d in enumerate(instrument.decoders):
            result = {key: jnp.asarray(arrays[key][k]) for key in (
                "decoded", "argmax", "distance", "branch", "confidence", "qcfail")}
            sums = _counters(d, result, valid)
            parts += [np.asarray(sums[column]) for column in wire.counter_names(d)]
        theirs = np.concatenate(parts)
        offset = 0
        for _, column, size in wire.counter_layout(instrument):
            a, b = mine[offset : offset + size], theirs[offset : offset + size]
            if column in ("accumulated_confidence", "accumulated_pf_confidence"):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=2048 * 2.0**-41, err_msg=column)
            else:
                np.testing.assert_array_equal(a, b, err_msg=column)
            offset += size
    else:
        instrument = _instrument(decoders)
        layout = unpack.token_layout(instrument, [32], 6)
        segments = [(rng.choice([1, 2, 4, 8, 15], size=(n, 32)).astype(np.int32),
                     rng.integers(0, 42, size=(n, 32)).astype(np.int32),
                     rng.integers(0, 33, size=n).astype(np.int32))]
        blob = wire.pack_h2d_blob([32], segments, rng.random(n) < 0.1, qual_bits=6)
        mine = unpack.unpack_tokens(instrument, layout, torch.from_numpy(layout.program), torch.from_numpy(blob))
        theirs = _unpack_h2d_blob([32], jnp.asarray(blob), 6)[0]
        for slot, d in enumerate(decoders):
            codes, quals, lengths, _ = mine.observation(layout, slot)
            observation = jax_classify.apply_plans(d, theirs)
            np.testing.assert_array_equal(codes.numpy(), np.concatenate([np.asarray(c) for c, _, _ in observation], 1))
            np.testing.assert_array_equal(quals.numpy(), np.concatenate([np.asarray(q) for _, q, _ in observation], 1))
            np.testing.assert_array_equal(lengths.numpy(), np.stack([np.asarray(x) for _, _, x in observation], 1))


@pytest.mark.parametrize("ontology", [flagship_ontology, mdd_flagship_ontology])
def test_flagship_plans_unchanged(ontology):
    """The flagships run the instances and plans they ran before the wider
    paths: K1 MAXW 16, K6's 4-word instance with one mask word, K3 staging
    the wire, tokens and program at 128 reads a block, K5 staging 256;
    every width up to 64 keeps its register instance."""
    instrument = compile_instrument(ontology(), "cpu")
    # the register instances keep their widths: MAXW 16, 32, 64 up to 64
    assert [pamld.instance_width(w) for w in (1, 16, 17, 32, 33, 64, 65)] == [16, 16, 32, 32, 64, 64, 0]
    for dec in instrument.decoders:
        if dec.algorithm == "pamld":
            assert pamld.instance_width(sum(dec.segment_widths)) == 16
        if dec.algorithm == "mdd":
            assert mdd.key_words(sum(dec.segment_widths)) == 4 and mdd.mask_words(sum(dec.segment_widths)) == 1
    layout = unpack.token_layout(instrument, [8, 8, 28], wire.JOINT4)
    row_bytes = unpack._segment_table([8, 8, 28], wire.JOINT4)[1] + 1
    plan = unpack.block_plan(layout, row_bytes)
    assert unpack.unpack_plan(layout, row_bytes) == plan and plan.reads == 128
    packed = pack.pack_plan(instrument, True)
    assert packed.staged and packed.reads == 256 and packed.shared_bytes <= pack.SHARED_BYTES


def test_wrapper_refuses_with_the_same_type():
    """What a kernel still refuses is a ConfigurationError, raised when an
    engine is built for a card (check_kernel_limits): a decoder that no
    block of its kernel holds. K3, which refused a block whose lengths and
    short flags alone passed a block's shared memory, now gives eight MDD
    decoders of 256 segments (2048 length columns) its column plan, each
    decoder's columns staged by a block of its own."""
    wide = _instrument([_decoder("mdd", [1] * 256)] * 8)
    layout = unpack.token_layout(wide, [256], wire.JOINT4)
    plan = unpack.unpack_plan(layout, unpack._segment_table([256], wire.JOINT4)[1] + 1)
    assert isinstance(plan, unpack.ColumnPlan) and plan.chunks == tuple((d, d + 1, True) for d in range(8))
    assert plan.shared_bytes <= unpack.SHARED_BYTES
    with pytest.raises(ConfigurationError, match="shared memory a block"):
        check_kernel_limits(_instrument([_decoder("pamld", [231_393])]))


def test_no_limit_within_the_reference_domain():
    """No line for PAMLD observations of 65-1024 positions, MDD of 256
    segments or 1024 positions, 1026 decoders, or their token program of
    some 400,000 ints: every kernel has a block, and K3 a plan, for them."""
    decoders = [_decoder("pamld", [w]) for w in (65, 128, 129, 1024)]
    decoders += [_decoder("mdd", [4] * 256), _decoder("mdd", [1024])]
    instrument = _instrument(decoders * 171)
    assert kernel_limits(instrument) == []
    layout = unpack.token_layout(instrument, [32], wire.JOINT4)
    assert layout.program.size > 65_536 and layout.length_cols > 2048
    plan = unpack.unpack_plan(layout, unpack._segment_table([32], wire.JOINT4)[1] + 1)
    assert isinstance(plan, unpack.ColumnPlan) and plan.shared_bytes <= unpack.SHARED_BYTES


@pytest.mark.parametrize("algorithm,barcodes,ceiling", [("pamld", 8, 231_392), ("mdd", 1, 29_024), ("mdd", 8, 29_024)])
def test_kernel_limits_at_the_shared_memory_ceiling(algorithm, barcodes, ceiling):
    """kernel_limits names a decoder one position past the widest its
    kernel's block holds (a looped K1 barcode row; a wide K6 warp's one
    staged read, its key table past 40 KB and read from L2 at that width
    even for one barcode) and not one at it; the byte counts use the CUDA
    sources' constants."""
    csrc = Path(pamld.__file__).parent.parent / "csrc"
    source = (csrc / "pamld.cu").read_text() + (csrc / "mdd.cu").read_text()
    for name, value in (("PHQ_PAMLD_SMEM_MAX", pamld.SHARED_LIMIT), ("PHQ_MDD_SMEM_MAX", mdd.SHARED_LIMIT),
                        ("PHQ_MDD_SHARED_TABLE", mdd.SHARED_TABLE), ("PHQ_MDD_SHARED_SEGMENTS", mdd.SHARED_SEGMENTS)):
        assert int(re.search(rf"#define {name} \((\d+) \* 1024\)", source).group(1)) * 1024 == value
    assert int(re.search(r"#define PHQ_MDD_THREADS (\d+)", source).group(1)) == 32 * mdd.WARPS
    assert int(re.search(r"#define PHQ_MDD_BATCH_MAX (\d+)", source).group(1)) == mdd.BATCH_MAX
    for width, refused in ((ceiling, False), (ceiling + 1, True)):
        dec = _decoder(algorithm, [width])
        dec.barcode_count = barcodes
        lines = kernel_limits(_instrument([dec]))
        assert bool(lines) == refused, (width, lines)


class _TileLoopLibrary:
    """The tile loop's C entries as the wrappers call them, recorded, with
    phq_pamld_info answering as csrc/pamld.cu does on an H100 (132 SMs, 4
    resident blocks; the looped instance's tile: 32768 bytes of rows of
    whole 16-byte vectors, cut to whole groups of 16 barcodes)."""

    def __init__(self):
        self.calls = []

    def phq_pamld_info(self, w, out):
        maxw = pamld.instance_width(w)
        row = maxw if maxw else 16 * -(-w // 16)
        tile = 32768 // row
        if maxw == 0 and tile >= 16:
            tile -= tile % 16
        values = [max(tile, 1), 128, 256 if maxw == 16 else 128, 132, maxw] + [4, 120, 0] * 3
        values += [16 if maxw == 0 else 2, 48]
        (ctypes.c_int * 16).from_address(out)[:] = values
        self.calls.append(("info", w))
        return 0

    def phq_pamld_state(self, ints, floats, code, qual, state, stream):
        self.calls.append("state")
        return 0

    def phq_pamld(self, *args):
        self.calls.append("classify")
        return 0

    def phq_pamld_slices(self, ints, floats, mode, *args):
        self.calls.append(("stage A", "stage B")[mode - 1])
        return 0

    def phq_pamld_merge(self, *args):
        self.calls.append("merge")
        return 0


@pytest.fixture
def tile_loop_library(monkeypatch):
    """The tile loop's wrappers on CPU tensors against _TileLoopLibrary in
    place of the built kernels (the card's stream and device patched)."""
    from pheniqs_tpu_torch.kernels import build

    fake = _TileLoopLibrary()
    monkeypatch.setattr(build, "library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    monkeypatch.setattr(pamld, "_TILE_LOOPS", {})
    return fake


@pytest.mark.parametrize("width,barcodes,n", [(16, 96, 131072), (64, 384, 16384), (65, 96, 131072), (97, 101, 4096),
                                              (97, 40, 4096), (128, 384, 131072), (300, 384, 131072),
                                              (96, 4096, 131072)])
def test_tile_loop_launches_follow_the_instance(tile_loop_library, width, barcodes, n):
    """What _classify_launches runs for an observation of `width`
    positions: past LOOPED_PAST the looped instance, whose read state (8 *
    ceil(W/16) + 2 words a read: code and quality vectors, C, qpos*U) one
    launch writes first, counted with the tile loop's; then one launch over
    a panel of one slice, else stages A, B and C, by the card's plan
    (tile_loop, asked once per instance, and for the looped one per row of
    16-byte vectors; the looped instance sliced wherever its panel holds
    more than one cut). K1's count takes them below 1024 barcodes, K7's
    above."""
    rows = torch.zeros((n, width + 4), dtype=torch.uint8)
    codes, quals = rows[:, :width], rows[:, 2 : width + 2]
    dec = SimpleNamespace(noise=0.05, random_barcode_probability=4.0**-16, confidence_threshold=0.95,
                          barcode_count=barcodes, high_quality_threshold=30, high_quality_distance_threshold=0,
                          panel_codes_u8=torch.zeros((barcodes, width), dtype=torch.uint8),
                          concentration=torch.zeros(barcodes))
    qcfail = torch.zeros(n, dtype=torch.bool)
    consts = torch.zeros(24)
    run = pamld._TileLoopLaunch(dec, codes, quals, qcfail, None, consts, True, 0.0)
    looped = width > pamld.LOOPED_PAST
    assert run.state_launches == int(looped)
    assert (run.state is not None) == looped
    if looped:
        assert run.state.numel() == (8 * -(-width // 16) + 2) * n and run.state.dtype == torch.int32
    tile_loop_library.calls.clear()
    counts = (pamld.launches, pamld.chunked_launches)
    pamld._classify_launches(dec, codes, quals, qcfail, None, consts, True, 0.0, None)
    loop = pamld.tile_loop(width, "cpu")
    assert loop.maxw == pamld.instance_width(width) and loop.maxw in ((0,) if looped else (16, 32, 64))
    assert (loop.maxw, -(-width // 16) if looped else 0, 0) in pamld._TILE_LOOPS
    plan = pamld.plan_for(n, barcodes, width, "cpu")
    if looped:
        # the looped instance keeps one launch only for a panel of one cut
        assert (plan.slices == 1) == (-(-barcodes // plan.cut) == 1)
    launches = ["classify"] if plan.slices == 1 else ["stage A", "stage B", "merge"]
    assert [c for c in tile_loop_library.calls if c != ("info", width)] == ["state"] * looped + launches
    added = (pamld.launches - counts[0], pamld.chunked_launches - counts[1])
    total = len(launches) + int(looped)
    assert added == ((0, total) if barcodes > pamld.LARGE_PANEL_B else (total, 0))
