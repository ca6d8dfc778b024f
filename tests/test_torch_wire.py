"""The port's wire helpers (pheniqs_tpu_torch.device.wire) and its plain
wire unpack against the JAX reference module (pheniqs_tpu.device.step).
Every comparison is exact: bytes, integers and layouts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pheniqs_tpu.device import step as jax_step
from pheniqs_tpu.device.flagship import flagship_instrument
from pheniqs_tpu_torch.device import wire
from pheniqs_tpu_torch.device.flagship import flagship_ontology
from pheniqs_tpu_torch.device.instrument import compile_instrument
from pheniqs_tpu_torch.kernels.unpack import unpack_h2d_blob

MODES = [6, 2, 4, "j4"]


def test_wire_constants_match():
    assert (wire.H2D_QCFAIL, wire.H2D_PAD, wire.H2D_FORCED) == (
        jax_step.H2D_QCFAIL, jax_step.H2D_PAD, jax_step.H2D_FORCED,
    )
    assert wire.JOINT4 == jax_step.JOINT4


@pytest.mark.parametrize("mode", MODES)
def test_lane_and_blob_bytes_match(mode):
    for w in (4, 8, 12, 28, 152, 256, 300):
        assert wire._lane_bytes(w, mode) == jax_step._lane_bytes(w, mode)
    for widths in ([8, 8, 28], [4], [152, 8, 300]):
        assert wire.h2d_blob_bytes(widths, mode) == jax_step.h2d_blob_bytes(widths, mode)


def _same(a, b):
    assert type(a) is type(b) or (a is None) == (b is None)
    if a is None:
        return
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize(
    "values,mode",
    [
        ([2, 12, 23, 37], "auto"),
        ([2, 12, 23, 37], "6"),
        ([2, 12], "4"),
        ([2, 70], "auto"),
        (list(range(2, 14)), "auto"),
        (list(range(2, 41)), "auto"),
        ([5], "2"),
    ],
)
def test_sense_qual_codebook_matches(values, mode):
    _same(wire.sense_qual_codebook(values, mode), jax_step.sense_qual_codebook(values, mode))


@pytest.mark.parametrize("count", [1, 5, 16, 17])
def test_sense_joint_codebook_matches(count):
    rng = np.random.default_rng(count)
    codes = rng.choice([1, 2, 4, 8, 15], size=count)
    quals = rng.choice([2, 12, 23, 37, 40, 70], size=count)
    pairs = np.unique(codes * 256 + np.minimum(quals, 63))
    _same(wire.sense_joint_codebook(pairs), jax_step.sense_joint_codebook(pairs))


def _segments(rng, n, widths, rich):
    segments = []
    for w in widths:
        sw = w - 2 if w > 4 else w
        if rich:
            code = rng.integers(0, 16, size=(n, sw)).astype(np.uint8)
            qual = rng.integers(0, 80, size=(n, sw)).astype(np.uint8)
        else:
            code = rng.choice(np.array([1, 2, 4, 8], np.uint8), size=(n, sw))
            qual = rng.choice(np.array([2, 12, 23, 37], np.uint8), size=(n, sw))
            qual[rng.random((n, sw)) < 0.01] = 30  # outside the codebook: forced
        length = rng.integers(0, sw + 1, size=n).astype(np.int32)
        segments.append((code, qual, length))
    return segments


def _lut(mode, segments):
    code = np.concatenate([c.ravel() for c, _, _ in segments])
    qual = np.concatenate([q.ravel() for _, q, _ in segments])
    if mode == 6:
        return None, None, None
    if mode == "j4":
        pairs = np.unique((code.astype(np.int64) & 15) << 8 | np.minimum(qual, 63))[:16]
        ccb, qcb, lut_idx, lut_exact = wire.sense_joint_codebook(pairs)
        return ccb, qcb, (lut_idx, lut_exact)
    _, qcb, lut_idx, lut_exact = wire.sense_qual_codebook([2, 12, 23, 37], str(mode))
    return None, qcb, (lut_idx, lut_exact)


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("mode", MODES)
def test_pack_h2d_blob_matches(mode, native, monkeypatch):
    monkeypatch.setenv("PHENIQS_NATIVE_PACK", native)
    rng = np.random.default_rng(41)
    widths = [8, 8, 28]
    segments = _segments(rng, 200, widths, rich=(mode == 6))
    qcfail = rng.random(200) < 0.1
    _, _, lut = _lut(mode, segments)
    ours = wire.pack_h2d_blob(widths, segments, qcfail, qual_bits=mode, qual_lut=lut)
    theirs = jax_step.pack_h2d_blob(widths, segments, qcfail, qual_bits=mode, qual_lut=lut)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("mode", MODES)
def test_plain_unpack_matches_jax(mode):
    rng = np.random.default_rng(43)
    widths = [8, 12, 28]
    segments = _segments(rng, 300, widths, rich=(mode == 6))
    qcfail = rng.random(300) < 0.1
    ccb, qcb, lut = _lut(mode, segments)
    blob = wire.pack_h2d_blob(widths, segments, qcfail, qual_bits=mode, qual_lut=lut)
    blob[-5:, -1] |= wire.H2D_PAD
    theirs = jax_step._unpack_h2d_blob(
        widths, jnp.asarray(blob), qual_bits=mode,
        qcb=None if qcb is None else jnp.asarray(qcb),
        ccb=None if ccb is None else jnp.asarray(ccb),
    )
    ours = unpack_h2d_blob(
        widths, torch.from_numpy(blob), mode,
        qcb=None if qcb is None else torch.from_numpy(qcb),
        ccb=None if ccb is None else torch.from_numpy(ccb),
    )
    for (c, q, l), (tc, tq, tl) in zip(ours[0], theirs[0]):
        np.testing.assert_array_equal(c.numpy(), np.asarray(tc))
        np.testing.assert_array_equal(q.numpy(), np.asarray(tq))
        np.testing.assert_array_equal(l.numpy(), np.asarray(tl))
    for flag, reference in zip(ours[1:], theirs[1:]):
        np.testing.assert_array_equal(flag.numpy(), np.asarray(reference))


def _decoders(d: int):
    """A stand-in instrument of `d` decoders cycling PAMLD 96, MDD 40 and
    naive (chip_smoke's WIDE_DECODERS rows): both layouts read only each
    decoder's algorithm and barcode count."""
    from types import SimpleNamespace

    cycle = (("pamld", 96), ("mdd", 40), ("naive", 0))
    return SimpleNamespace(decoders=[SimpleNamespace(algorithm=a, barcode_count=b) for a, b in (cycle * d)[:d]])


@pytest.mark.parametrize("want_uncertain", [True, False])
def test_layouts_match(want_uncertain):
    """The flagship's layouts, and those of 33 and 64 decoders (the
    decoder masks and qcfail bytes past one 32-bit word), equal the
    reference's."""
    cases = [(flagship_instrument(), compile_instrument(flagship_ontology(), "cpu"))]
    cases += [(_decoders(d), _decoders(d)) for d in (33, 64)]
    for reference, ours in cases:
        assert wire.counter_layout(ours) == jax_step.counter_layout(reference)
        assert wire.d2h_layout(ours, want_uncertain) == jax_step.d2h_layout(
            reference, want_uncertain
        )
    assert [wire.d2h_layout(ours, want_uncertain)["qcfail_bytes"] for _, ours in cases[1:]] == [5, 8]
