"""K6's wide instance on the CPU (kernels/mdd.py past 64 positions): the
panel's bit planes in the key table, the pair walk that orders a warp's
(read, barcode) pairs, and the two-phase twin built on both, against the
plain version and the JAX package's mdd_classify_device. The kernel
itself runs only on the card (tests/test_torch_kernels.py -m cuda,
chip_smoke.py). MDD is integer-only: every comparison is exact."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pheniqs_tpu.device import classify as jax_classify
from pheniqs_tpu.device import compile_instrument as jax_compile
from pheniqs_tpu_torch.device.flagship import synthetic_batch, wide_mdd_ontology
from pheniqs_tpu_torch.device.instrument import carry_instrument
from pheniqs_tpu_torch.kernels import mdd

KEYS = ("decoded", "argmax", "distance", "branch", "qcfail", "confidence")


def test_plane_words_and_the_key_table():
    """plane_words puts bit q of position 32g + j of row i at bit j of word
    [g, q, i]; the key table past 64 positions appends the panel's planes,
    4 of them for codes below 16 and 8 where a code is 16 or more, and
    decoder_planes and the kernel's ints read that count back."""
    rng = np.random.default_rng(5)
    codes = rng.choice(np.array([0, 1, 2, 4, 8, 15], np.uint8), size=(7, 70))
    words = mdd.plane_words(codes, 8)
    assert words.shape == (3, 8, 7) and words.dtype == np.uint32
    for g in range(3):
        for q in range(8):
            for i in range(7):
                expected = sum(((int(codes[i, 32 * g + j]) >> q) & 1) << j for j in range(32) if 32 * g + j < 70)
                assert int(words[g, q, i]) == expected
    for panel, planes in ((codes, 4), (np.where(codes == 15, 31, codes).astype(np.uint8), 8)):
        table = mdd.key_table(panel)
        nw = mdd.key_words(70)
        assert mdd.panel_planes(panel) == planes
        assert table.size == 2 * 7 * nw + 8 + 3 * planes * 7
        np.testing.assert_array_equal(mdd.table_planes(table, 7, 70).numpy(), mdd.plane_words(panel, planes))
        dec = dataclasses.make_dataclass("D", ["segment_widths", "barcode_count", "key_table",
                                               "quality_masking_threshold"])([30, 40], 7, torch.from_numpy(table), 0)
        assert mdd.decoder_planes(dec) == planes
        ints = mdd._ints(dec, 100, 70, 2)
        assert ints.tolist()[7:] == [nw, planes, mdd.batch_reads(70, planes)]
    assert mdd.key_table(codes[:, :64]).size == 2 * 7 * 16 + 8  # no planes up to 64 positions


@pytest.mark.parametrize("barcodes", [1, 5, 31, 32, 33, 40, 80, 200])
@pytest.mark.parametrize("batch", [1, 7, 32])
def test_pair_walk_finds_each_first_hit(barcodes, batch):
    """The kernel's walk over (read, barcode) pairs, 32 lanes a round, a
    round whose last read hit moving on to the next read, gives every read
    its first barcode within tolerance (its row's first True), -1 for
    none, at hit rates from none to dense."""
    gen = torch.Generator().manual_seed(barcodes * 100 + batch)
    for rate in (0.0, 0.01, 0.1, 0.5):
        within = torch.rand((45, barcodes), generator=gen) < rate
        expected = torch.where(within.any(dim=1), torch.argmax(within.to(torch.uint8), dim=1), -1)
        assert torch.equal(mdd.pair_walk(within, batch), expected)


def _observations(widths, words, n, rng, short=0.03, noise=0.1):
    """(code, qual, lengths) of `n` reads drawn from the panel `words` (N
    of them random), 0.5 substitutions a read, `short` of the segments cut."""
    w = sum(widths)
    code = words[rng.integers(len(words), size=n)].copy()
    errors = rng.random(code.shape) < 0.5 / w
    code[errors] = rng.choice(np.array([1, 2, 4, 8, 15], np.uint8), size=int(errors.sum()))
    code[rng.random(n) < noise] = rng.choice(np.array([1, 2, 4, 8], np.uint8), size=w)
    qual = rng.integers(2, 41, size=code.shape).astype(np.uint8)
    lengths = np.tile(np.array(widths, np.int32), (n, 1))
    cut = rng.random(lengths.shape) < short
    lengths[cut] = rng.integers(0, np.broadcast_to(np.array(widths), lengths.shape)[cut] + 1)
    starts = np.concatenate([[0], np.cumsum(widths)[:-1]])
    for s, (start, ws) in enumerate(zip(starts, widths)):
        beyond = np.arange(ws)[None, :] >= lengths[:, s : s + 1]
        code[:, start : start + ws][beyond] = 0
        qual[:, start : start + ws][beyond] = 0
    return code, qual, lengths


def test_wide_twin_with_eight_planes_matches_plain():
    """A panel holding codes of 16 and more (outside the reference's 4-bit
    codes, where JAX's one-hot compare does not apply) takes 8 planes; the
    twin counts its errors on them and equals the plain version, which
    compares whole bytes, byte for byte, at tolerance 2 with quality
    masking."""
    rng = np.random.default_rng(16)
    widths = [11] * 10 + [10, 10]
    words = rng.choice(np.array([1, 2, 4, 8], np.uint8), size=(40, 130))
    words[3, 5] = 16
    words[7, 40:60] = 31
    words[9] = 16
    code, qual, lengths = _observations(widths, words, 300, rng)
    code[:20, 3] = 31
    dec = dataclasses.make_dataclass(
        "D", ["segment_widths", "barcode_count", "key_table", "quality_masking_threshold", "distance_tolerance",
              "panel_codes"])(widths, 40, torch.from_numpy(mdd.key_table(words)), 5, (2,) * 12,
                              torch.from_numpy(words.astype(np.int32)))
    assert mdd.decoder_planes(dec) == 8
    args = (dec, torch.from_numpy(code), torch.from_numpy(qual), torch.from_numpy(lengths),
            torch.from_numpy(rng.random(300) < 0.05))
    twin, plain = mdd.mdd_classify_two_phase(*args), mdd.mdd_classify_plain(*args)
    for key in KEYS:
        assert torch.equal(twin[key], plain[key]), key
    decoded = plain["decoded"].numpy()
    assert (decoded == 10).any() and (decoded == 8).any() and (decoded == 0).any()


def test_wide_mdd_instrument_matches_jax():
    """The wide MDD instrument (wide_mdd_ontology: a sample barcode of 12
    segments and 130 positions read from segment 0, tolerance 2), compiled
    by the JAX package and carried to the port: on reads drawn by
    synthetic_batch the two-phase twin (planes, pair walk) and the plain
    version equal JAX's mdd_classify_device byte for byte."""
    ontology = wide_mdd_ontology()
    reference = jax_compile(ontology)
    dec = carry_instrument(reference, "cpu").decoders[0]
    assert dec.algorithm == "mdd" and len(dec.segment_widths) == 12 and sum(dec.segment_widths) == 130
    assert mdd.decoder_planes(dec) == 4
    batch = synthetic_batch(ontology, 400, seed=12, error_rate=0.01)
    code, qual, _ = batch["segments"][0]
    rng = np.random.default_rng(12)
    lengths = np.tile(np.array(dec.segment_widths, np.int32), (400, 1))
    cut = rng.random(lengths.shape) < 0.02
    lengths[cut] = rng.integers(0, 10, size=int(cut.sum()))
    starts = np.concatenate([[0], np.cumsum(dec.segment_widths)[:-1]])
    code, qual = code[:, :130].copy(), qual[:, :130].copy()
    for s, (start, ws) in enumerate(zip(starts, dec.segment_widths)):
        beyond = np.arange(ws)[None, :] >= lengths[:, s : s + 1]
        code[:, start : start + ws][beyond] = 0
        qual[:, start : start + ws][beyond] = 0
    qcfail = rng.random(400) < 0.05
    obs = [(jnp.asarray(code[:, s : s + ws]), jnp.asarray(qual[:, s : s + ws]), jnp.asarray(lengths[:, k]))
           for k, (s, ws) in enumerate(zip(starts, dec.segment_widths))]
    theirs = jax_classify.mdd_classify_device(reference.decoders[0], obs, jnp.asarray(qcfail))
    args = (dec, torch.from_numpy(code), torch.from_numpy(qual), torch.from_numpy(lengths), torch.from_numpy(qcfail))
    twin, plain = mdd.mdd_classify_two_phase(*args), mdd.mdd_classify_plain(*args)
    for key in KEYS:
        np.testing.assert_array_equal(twin[key].numpy(), np.asarray(theirs[key]), err_msg=key)
        np.testing.assert_array_equal(plain[key].numpy(), np.asarray(theirs[key]), err_msg=key)
    decoded = twin["decoded"].numpy()
    assert twin["exact"].any() and ((twin["distance"].numpy() > 0) & (decoded > 0)).any()
