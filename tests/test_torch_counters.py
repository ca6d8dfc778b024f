"""K4, the statistics counters: the port's plain version (integer and
64-bit fixed-point sums, the kernel's arithmetic) against the JAX
package's ``pheniqs_tpu.device.step._counters`` (an f32 one-hot
contraction) on decisions made with numpy from a seed, its decoder table
against ``wire.counter_layout`` and its limits. The kernel against the
plain version on the card is in tests/test_torch_kernels.py, which
imports no JAX.

Tolerances: integer columns exact; confidence sums rtol 1e-5 (the JAX
sum rounds in its own order) plus the fixed point's own bound of N *
2^-41, which shows only where a bin holds nothing but confidences near
1e-8 (each such term quantised to 2^-40 is off by up to 1e-5 of itself).
"""

import math

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from chip_smoke import K4_CASES, k4_case, k4_tensors
from pheniqs_tpu.device.step import _counters
from pheniqs_tpu_torch.device import wire
from pheniqs_tpu_torch.kernels import counters

CONFIDENCE = ("accumulated_confidence", "accumulated_pf_confidence")


def _jax_counters(instrument, arrays, want_uncertain):
    """The flat counter vector from the JAX package's _counters, decoder by
    decoder, over the same valid rows."""
    unsure = arrays["forced"].copy() if want_uncertain else np.zeros_like(arrays["forced"])
    if want_uncertain:
        for k, dec in enumerate(instrument.decoders):
            if dec.algorithm == "pamld":
                unsure |= arrays["uncertain"][k]
    valid = jnp.asarray((~arrays["pad"] & ~unsure).astype(np.float32))
    parts = []
    for k, dec in enumerate(instrument.decoders):
        result = {key: jnp.asarray(arrays[key][k]) for key in (
            "decoded", "argmax", "distance", "branch", "confidence", "qcfail")}
        sums = _counters(dec, result, valid)
        parts += [np.asarray(sums[name]) for name in wire.counter_names(dec)]
    return np.concatenate(parts) if parts else np.zeros(0, np.float32)


@pytest.mark.parametrize("want_uncertain", [True, False])
@pytest.mark.parametrize("name", list(K4_CASES))
def test_plain_matches_jax(name, want_uncertain):
    instrument, arrays = k4_case(name)
    rows, pad, forced = k4_tensors(arrays, "cpu")
    mine = counters.counters(instrument, rows, pad, forced, want_uncertain).numpy()
    theirs = _jax_counters(instrument, arrays, want_uncertain)
    n = arrays["pad"].shape[0]
    assert mine.dtype == np.float32 and mine.shape == theirs.shape == (counters.decoder_table(instrument).total,)
    offset = 0
    for _, column, size in wire.counter_layout(instrument):
        a, b = mine[offset : offset + size], theirs[offset : offset + size]
        if column in CONFIDENCE:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=n * 2.0**-41, err_msg=column)
        else:
            np.testing.assert_array_equal(a, b, err_msg=column)
        offset += size
    counted = mine[: instrument.decoders[0].barcode_count + 1].sum()
    if name in ("all invalid", "empty"):
        assert not mine.any()
    else:
        assert counted > 0


def test_cases_reach_their_edges():
    """The cases hold what their names say."""
    _, one = k4_case("one bin")
    assert len(np.unique(one["argmax"][0])) == 1
    _, last = k4_case("last bin")
    assert (last["decoded"][0] == 384).mean() > 0.3 and (last["argmax"][1] == 96).any()
    _, apart = k4_case("argmax differs")
    low = np.isin(apart["branch"][0], (1, 2))
    assert (apart["decoded"][0] != apart["argmax"][0]).mean() > 0.9 and low.any()
    _, extreme = k4_case("extreme confidences")
    assert set(np.unique(extreme["confidence"][0])) == {np.float32(1 - 2.0**-24), np.float32(1e-8)}
    _, ragged = k4_case("ragged")
    assert ragged["pad"].shape[0] % 32 != 0
    instrument, naive = k4_case("naive only")
    assert instrument.decoders[0].barcode_count == 0
    mine = counters.counters_plain(instrument, *k4_tensors(naive, "cpu"), True)
    assert mine.shape == (2,) and mine[0] == (~naive["pad"] & ~naive["forced"]).sum()


@settings(max_examples=60, deadline=None)
@given(st.lists(st.floats(min_value=0.0, max_value=1.0, width=32), min_size=1, max_size=300))
def test_fixed_point_sum_bound(values):
    """The fixed-point confidence sum of N rows in one bin lies within
    N * 2^-41 + 1/2 ulp of the f64 sum of the same f32 confidences."""
    n = len(values)
    confidence = np.asarray(values, np.float32)
    instrument, arrays = k4_case("bound", n, decoders=(("pamld", 1, 8),))
    arrays["decoded"][0] = 1
    arrays["branch"][0] = 0
    arrays["qcfail"][0] = False
    arrays["confidence"][0] = confidence
    arrays["pad"][:] = False
    sums = counters.counters_plain(instrument, *k4_tensors(arrays, "cpu"), False).numpy()
    layout = [name for _, name, _ in wire.counter_layout(instrument)]
    got = sums[2 * layout.index("accumulated_confidence") + 1]
    pf = sums[2 * layout.index("accumulated_pf_confidence") + 1]
    exact = math.fsum(float(c) for c in confidence)
    assert abs(float(got) - exact) <= n * 2.0**-41 + np.spacing(np.float32(got)) / 2
    assert got == pf


def test_decoder_table_follows_counter_layout(monkeypatch):
    from pheniqs_tpu_torch.device.flagship import flagship_ontology
    from pheniqs_tpu_torch.device.instrument import compile_instrument

    wide_instrument, _ = k4_case("wide", 0, decoders=(("pamld", 96, 16), ("pamld", 737_280, 16), ("naive", 0, 0)))
    mdd_instrument, _ = k4_case("mdd", 0)
    for instrument in (compile_instrument(flagship_ontology(), "cpu"), wide_instrument, mdd_instrument):
        table = counters.decoder_table(instrument)
        layout = wire.counter_layout(instrument)
        assert table.total == sum(size for _, _, size in layout)
        offset = wide = 0
        for position, (first, b1, kind, cols, wide_at, shared) in enumerate(table.rows):
            mine = [(p, name, size) for p, name, size in layout if p == position]
            dec = instrument.decoders[position]
            assert first == offset and cols == len(mine) and all(size == b1 for _, _, size in mine)
            assert b1 == dec.barcode_count + 1
            assert kind == {"pamld": 2, "mdd": 1}.get(dec.algorithm, 0)
            assert wide_at == (wide if kind == 2 else -1)
            # a PAMLD decoder's two fixed-point sums in three 4-byte pieces each
            histogram = b1 * (4 * cols + 24 * (kind == 2))
            assert shared == (histogram if histogram <= counters.SHARED_LIMIT else 0)
            offset += b1 * cols
            wide += 2 * b1 if kind == 2 else 0
        assert table.wide == wide
        assert table.shared_bytes == max(row[5] for row in table.rows) <= counters.SHARED_LIMIT <= counters.SHARED_MAX
    # the whitelist's cellular panel takes global atomics, its sample panel shared memory
    assert [row[5] > 0 for row in counters.decoder_table(wide_instrument).rows] == [True, False, True]
    monkeypatch.setattr(counters, "SHARED_LIMIT", 0)
    assert all(row[5] == 0 for row in counters.decoder_table(wide_instrument).rows)


@pytest.mark.parametrize(
    "n,width,slices",
    [(131072, 16, 1), (2**23 - 1, 1, 1), (2**23, 1, 2), (2**14, 1024, 2), (2**14, 1023, 1)],
)
def test_limits(n, width, slices):
    """K4's row slices: contiguous, covering the batch in order, each
    within both limits (an integer column below 2^24, n < 2^23 for the
    fixed-point sums), and as few as those limits allow."""
    instrument, _ = k4_case("limits", 0, decoders=(("mdd", 4, width), ("naive", 0, 0)))
    if width == 1:
        instrument.decoders[0].algorithm = "pamld"
    plan = counters.row_slices(instrument, n)
    assert len(plan) == slices
    assert plan[0][0] == 0 and plan[-1][1] == n
    assert all(stop == start for (_, stop), (start, _) in zip(plan, plan[1:]))
    for start, stop in plan:
        assert 0 < stop - start < 2**23 and (stop - start) * width < 2**24


def test_counters_slice_a_batch_past_the_f32_limit():
    """A batch of 2^20 + 1 rows on 16-nt decoders (the flagship's), past
    the 2^24 at which an f32 integer column would round: K4 sums it in two
    row slices, on the CPU as on the card, and returns float64. Its integer
    columns equal an int64 numpy count, one distance bin past 2^24 and odd
    among them; its confidence sums are within N * 2^-41 of the exact sum
    plus half an f32 ulp of each slice's sum (one conversion per slice)."""
    n = 2**20 + 1
    instrument, arrays = k4_case("past the limit", n, decoders=(("pamld", 96, 16), ("pamld", 384, 16), ("naive", 0, 0)))
    # every row of the cellular decoder in bin 7 at distance 16 but three
    arrays["branch"][1] = 0
    arrays["argmax"][1] = 7
    arrays["decoded"][1] = np.where(arrays["branch"][1] == 0, 7, 0)
    arrays["distance"][1] = 16
    arrays["distance"][1][:3] = 15
    arrays["uncertain"][:] = False
    arrays["forced"][:] = False
    arrays["pad"][:] = False
    arrays["qcfail"][:] = False
    assert counters.row_slices(instrument, n) == [(0, 2**20 - 1), (2**20 - 1, n)]
    mine = counters.counters(instrument, *k4_tensors(arrays, "cpu"), True).numpy()
    assert mine.dtype == np.float64
    offset = 0
    big = 0
    for position, column, size in wire.counter_layout(instrument):
        got = mine[offset : offset + size]
        offset += size
        dec = instrument.decoders[position]
        valid = ~arrays["pad"]
        pf = valid & ~arrays["qcfail"][position]
        key = arrays["decoded"][position].astype(np.int64)
        argmax = arrays["argmax"][position].astype(np.int64)
        branch = arrays["branch"][position]
        distance = np.where(valid & (key > 0) & (arrays["distance"][position] > 0), arrays["distance"][position], 0)
        weights = {
            "count": (key, valid), "pf_count": (key, pf), "accumulated_distance": (key, distance),
            "accumulated_pf_distance": (key, np.where(pf, distance, 0)),
            "low_confidence_count": (argmax, valid & (branch == 1)),
            "low_conditional_confidence_count": (argmax, valid & (branch == 2)),
        }
        if column in CONFIDENCE:
            passed = valid & (branch == 0) & (pf if column == "accumulated_pf_confidence" else True)
            exact = np.zeros(size, np.float64)
            np.add.at(exact, key[passed], arrays["confidence"][position][passed].astype(np.float64))
            halves = np.zeros(size, np.float64)
            for start, stop in counters.row_slices(instrument, n):
                rows = passed & (np.arange(n) >= start) & (np.arange(n) < stop)
                part = np.zeros(size, np.float64)
                np.add.at(part, key[rows], arrays["confidence"][position][rows].astype(np.float64))
                halves += np.spacing(part.astype(np.float32)).astype(np.float64) / 2
            assert (np.abs(got - exact) <= n * 2.0**-41 + halves).all(), column
            continue
        index, weight = weights[column]
        expected = np.zeros(size, np.int64)
        np.add.at(expected, index, weight.astype(np.int64))
        np.testing.assert_array_equal(got, expected.astype(np.float64), err_msg=f"{dec.algorithm} {column}")
        big = max(big, int(expected.max()))
    assert big > 2**24 and big % 2 == 1


#: K4 plan cases: name -> decoders as (algorithm, barcodes, width)
PLAN_CASES = {
    "1 decoder": (("pamld", 96, 16),),
    "flagship": (("pamld", 96, 16), ("pamld", 384, 16), ("naive", 0, 0)),
    "whitelist": (("pamld", 96, 16), ("pamld", 737_280, 16), ("naive", 0, 0)),
    "33 decoders": (("pamld", 96, 16), ("mdd", 40, 8), ("naive", 0, 0)) * 11,
    "64 decoders": ((("pamld", 96, 16), ("mdd", 40, 8), ("naive", 0, 0)) * 22)[:64],
    "300 decoders": (("pamld", 96, 16), ("mdd", 40, 8), ("naive", 0, 0)) * 100,
}


@pytest.mark.parametrize("name", list(PLAN_CASES))
@pytest.mark.parametrize("n", [1, 4096 + 37, 131072, 2**20 - 1])
def test_counter_plan_covers_every_decoder_and_read(name, n):
    """K4's plan: every decoder in exactly one group, the groups in order
    and each histogram 16-byte aligned inside its group's bytes; a group
    of several decoders within GROUP_BYTES; every read in exactly one tile
    (a multiple of TILE_UNIT, at most MAX_TILE); a block's shared bytes
    within SHARED_MAX; the grid about WAVES blocks an SM of an H100 where
    the batch allows; the flagship's decoders in one group."""
    instrument, _ = k4_case(name, 0, decoders=PLAN_CASES[name])
    plan = counters.counter_plan(instrument)
    d = len(instrument.decoders)
    assert [first for first, _, _ in plan.groups] == [0] + [stop for _, stop, _ in plan.groups[:-1]]
    assert plan.groups[-1][1] == d and all(first < stop for first, stop, _ in plan.groups)
    for first, stop, group_bytes in plan.groups:
        sizes = [-(-row[5] // 16) * 16 for row in plan.table.rows[first:stop]]
        assert [plan.smem[k] for k in range(first, stop)] == [sum(sizes[:j]) for j in range(len(sizes))]
        assert group_bytes == sum(sizes) and group_bytes % 16 == 0
        assert stop - first == 1 or group_bytes <= counters.GROUP_BYTES
    tile = plan.tile(n, 132)
    tiles = -(-n // tile)
    assert tile % counters.TILE_UNIT == 0 and tile <= counters.MAX_TILE
    assert (tiles - 1) * tile < n <= tiles * tile
    assert plan.shared_bytes(tile) <= counters.SHARED_MAX and plan.flags_at % 16 == 0
    # the shortest tile whose grid stays within about WAVES blocks an SM
    target = -(-counters.WAVES * 132 // len(plan.groups))
    assert tiles <= target or tile == counters.MAX_TILE
    if tile > counters.TILE_UNIT:
        assert -(-n // (tile - counters.TILE_UNIT)) > target
    if name in ("1 decoder", "flagship", "whitelist"):
        assert len(plan.groups) == 1
    # the per-decoder instance: every histogram shared, small together
    assert plan.per_decoder == (name in ("1 decoder", "flagship", "33 decoders"))
    assert plan.decoder_bytes <= max(row[5] for row in plan.table.rows) or not plan.per_decoder
    assert plan.uncertain_rows == tuple(k for k, dec in enumerate(instrument.decoders) if dec.algorithm == "pamld")


#: K4's instances timed on the card (chip_smoke.py --times, epilogue;
#: PERF.md PR 16): (decoders repeated, count) -> whether the per-decoder
#: instance was the faster by more than 3 % (the counts where the two
#: were closer are left out)
INSTANCE_READINGS = {
    **{(K4_CASES["flagship"][0], d): d < 8 for d in (3, 4, 12, 16, 24, 33)},
    **{(K4_CASES["33 decoders"][0][:3], d): True for d in (3, 4, 6, 8, 9, 12, 16, 24, 33)},
}


@pytest.mark.parametrize("unit, d", list(INSTANCE_READINGS), ids=[
    f"{'wide' if unit[1][0] == 'mdd' else 'flagship'}-{d}" for unit, d in INSTANCE_READINGS])
def test_instance_is_the_one_the_card_timed_faster(unit, d):
    """counter_plan takes the per-decoder instance exactly where the
    card timed it faster than the grouped kernel, on flagship-like
    decoders (PAMLD 96 and 384, naive) and on small ones (PAMLD 96, MDD
    40, naive), by the histograms' bytes together (PER_DECODER_BYTES)."""
    instrument, _ = k4_case("instances", 0, decoders=(unit * 11)[:d])
    plan = counters.counter_plan(instrument)
    assert plan.per_decoder == INSTANCE_READINGS[unit, d]
    if plan.per_decoder:
        assert plan.decoder_bytes <= counters.SHARED_LIMIT


def test_counter_plan_is_made_once_per_instrument(monkeypatch):
    """The plan (decoder table, groups, uncertain rows, rows a slice) and
    its device table are made once and cached on the instrument: a
    batch's launch arguments walk no decoder; another SHARED_LIMIT makes
    another plan; dataclasses.replace starts afresh."""
    import dataclasses

    import torch

    from pheniqs_tpu_torch.device.flagship import flagship_ontology
    from pheniqs_tpu_torch.device.instrument import compile_instrument

    instrument = compile_instrument(flagship_ontology(), "cpu")
    plan = counters.counter_plan(instrument)
    table = counters._device_table(instrument, plan, torch.device("cpu"))
    assert counters._device_table(instrument, plan, torch.device("cpu")) is table
    np.testing.assert_array_equal(table.numpy(), plan.ints())
    made = []
    monkeypatch.setattr(counters, "decoder_table", lambda inst: made.append(inst))
    monkeypatch.setattr(counters, "slice_rows", lambda inst: made.append(inst))
    _, arrays = k4_case("flagship", 4096)
    rows, pad, forced = k4_tensors(arrays, "cpu")
    for _ in range(2):
        again, args = counters.launch_arguments(instrument, rows, pad, forced, True, 132)
        assert again is plan and counters.row_slices(instrument, 4096) == [(0, 4096)]
    assert not made
    assert (args["decoders"], args["groups"], args["uncertain"], args["per_decoder"]) == (3, 1, 2, 1)
    assert args["shared_bytes"] == plan.decoder_bytes == 385 * (4 * 8 + 16)
    assert counters.launch_arguments(instrument, rows, pad, forced, False, 132)[1]["uncertain"] == 0
    assert dataclasses.replace(instrument).counter_plans == {}


def test_shared_limit_makes_another_plan(monkeypatch):
    """k4_threshold_sweep sets SHARED_LIMIT around its calls: the plan
    cached under one limit is not the other's."""
    instrument, _ = k4_case("sweep", 0, decoders=(("pamld", 4096, 16),))
    shared = counters.counter_plan(instrument)
    monkeypatch.setattr(counters, "SHARED_LIMIT", counters.SHARED_MAX)
    wider = counters.counter_plan(instrument)
    monkeypatch.setattr(counters, "SHARED_LIMIT", 0)
    none = counters.counter_plan(instrument)
    assert shared.table.rows[0][5] == 0 and wider.table.rows[0][5] > 0 and none.table.rows[0][5] == 0
    assert wider.groups[0][2] > 0 and none.groups[0][2] == 0


@pytest.mark.parametrize("n,offset,vec", [(4096, 0, 4), (4096 + 37, 0, 1), (4096, 1, 1)])
def test_launch_arguments_take_four_reads_a_lane_only_on_aligned_rows(n, offset, vec):
    """Four reads a lane (int4, float4 and 4-byte loads) where the batch is
    a multiple of 4 reads and every row is aligned for it; else one."""
    import torch

    instrument, arrays = k4_case("flagship", n)
    rows, pad, forced = k4_tensors(arrays, "cpu")
    if offset:
        pad = torch.cat([torch.zeros(offset, dtype=torch.bool), pad])[offset:]
    assert counters.launch_arguments(instrument, rows, pad, forced, True, 132)[1]["vec"] == vec


def _tiled(instrument, arrays, want_uncertain, sms=132):
    """The accumulate kernel's walk in torch: per (group, tile) the tile's
    valid flags from pad, forced and the plan's uncertain rows, then each
    decoder of the group summed over the tile (the plain version's
    arithmetic); each decoder's columns added over the tiles in float64."""
    import torch

    plan = counters.counter_plan(instrument)
    n = arrays["pad"].shape[0]
    tile = plan.tile(n, sms)
    sums = {}
    for first, stop, _ in plan.groups:
        for t0 in range(0, n, tile):
            part = {key: torch.from_numpy(np.ascontiguousarray(value[..., t0 : t0 + tile]))
                    for key, value in arrays.items()}
            bad = part["pad"] | part["forced"] if want_uncertain else part["pad"]
            for k in plan.uncertain_rows if want_uncertain else ():
                bad = bad | part["uncertain"][k]
            for k in range(first, stop):
                row = {key: part[key][k] for key in ("decoded", "argmax", "distance", "branch", "confidence", "qcfail")}
                columns = counters._decoder_counters_plain(instrument.decoders[k], row, ~bad)
                sums[k] = [c.double() + s for c, s in zip(columns, sums[k])] if k in sums else [c.double() for c in columns]
    return torch.cat([column for k in range(len(instrument.decoders)) for column in sums[k]]).numpy()


@pytest.mark.parametrize("name", ["flagship", "forced", "33 decoders", "64 decoders"])
@pytest.mark.parametrize("want_uncertain", [True, False])
def test_tiles_and_groups_sum_to_the_plain_counters(name, want_uncertain):
    """Every (group, tile) block's sums, added, give the plain version's
    counters: the plan misses no read and no decoder and takes the
    uncertain rows the reference ORs (integer columns exact; the
    confidence sums within the f32 rounding of each tile's part)."""
    instrument, arrays = k4_case(name, 3 * 1024 + 37)
    mine = _tiled(instrument, arrays, want_uncertain)
    plain = counters.counters_plain(instrument, *k4_tensors(arrays, "cpu"), want_uncertain).numpy()
    np.testing.assert_allclose(mine, plain, rtol=1e-6, atol=1e-6)
