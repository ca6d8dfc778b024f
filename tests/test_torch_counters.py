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
            histogram = b1 * (4 * cols + 16 * (kind == 2))
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
