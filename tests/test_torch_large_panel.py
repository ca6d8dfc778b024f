"""The port's large-panel PAMLD (K7's plain version, CPU, B > 1024)
against the JAX reference and the float64 oracle, and the hybrid bound's
rescale term.

Also the arithmetic of the redesigned tile loop (csrc/pamld.cu) that the
CPU can check: its sigma order, its slice plan and the slices' merge.

Tolerances, each with its reason:
  * the kernel's sigma order: within d_sigma(read) of the f64 sum of the
    same f32 terms (the hybrid bound, which holds for any order);
  * the sliced posterior: as the chunked one against JAX below;
  * decisions, distances, branches and qcfail: exact against the oracle
    and on every row neither side flags uncertain against JAX (a flagged
    row is re-resolved in f64 by the hybrid engine);
  * confidence: rtol 1e-3, atol 1e-6 against the oracle (the JAX test's
    own tolerance for the chunked path), rtol 1e-5 against JAX (the exp and
    the chunk sums differ by a few ulp between XLA and torch);
  * the bound's margins: exact (the same f32 operations on both sides);
  * decode step bytes and counters: as tests/test_torch_step.py.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from pheniqs_tpu.decode.oracle import pamld_classify
from pheniqs_tpu.decode.spec import spec_from_ontology
from pheniqs_tpu.device import classify as jax_classify
from pheniqs_tpu.device import compile_instrument as jax_compile
from pheniqs_tpu.device.step import make_decode_step
from pheniqs_tpu_torch.device import classify, wire
from pheniqs_tpu_torch.device.flagship import flagship_ontology, synthetic_batch
from pheniqs_tpu_torch.device.instrument import (
    LARGE_PANEL_B,
    STRICT_CODES,
    _panel_matrices,
    carry_instrument,
    compile_instrument,
)
from pheniqs_tpu_torch.device.step import DecodeStep
from pheniqs_tpu_torch.kernels import pamld
from test_device_classify import make_pamld_ontology, random_panel, simulate_reads
from test_torch_kernels import _confidence_f64


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


def _jax_rel_eps(barcode_count: int, w: int, eps: float, q_sum: np.ndarray) -> np.ndarray:
    """rel_eps exactly as pheniqs_tpu/device/classify.py:632-645 computes it."""
    q_sum = jnp.asarray(q_sum, dtype=jnp.float32)
    d_sigma = jax_classify._gamma(2 * w + 2) * (2.0 * q_sum + jax_classify._TERM_BOUND * w) + eps * w
    lam = float(abs(jax_classify.LN_PHRED_BASE))
    chunks = -(-barcode_count // 1024) if barcode_count > jax_classify.LARGE_PANEL_B else 0
    return np.asarray(
        jax_classify._HYBRID_SAFETY
        * (
            4.0 * lam * d_sigma
            + 2.0 * jax_classify._gamma(barcode_count + 2)
            + 2.0 * jax_classify._gamma(2 * chunks)
            + 8.0 * jax_classify._U32
        )
    )


@pytest.mark.parametrize("barcode_count", [1000, 1025, 5000])
def test_uncertain_margins_match_jax(barcode_count):
    """The rescale term 2*gamma(2*ceil(B/1024)) of the chunked posterior
    enters the bound past LARGE_PANEL_B, in the plain version's margins and
    in the f32 scalars K1 and K7 receive."""
    from types import SimpleNamespace

    rng = np.random.default_rng(barcode_count)
    w, eps = 16, 5.2e-7
    q_sum = rng.integers(0, 41 * w, size=257).astype(np.float32)
    dec = SimpleNamespace(barcode_count=barcode_count)
    rel_eps, _ = pamld._uncertain_margins(dec, w, eps, torch.from_numpy(q_sum))
    np.testing.assert_array_equal(rel_eps.numpy(), _jax_rel_eps(barcode_count, w, eps, q_sum))
    chunks = -(-barcode_count // 1024) if barcode_count > LARGE_PANEL_B else 0
    assert pamld.chunk_gamma(barcode_count) == 2.0 * pamld.gamma(2 * chunks)
    assert (pamld.chunk_gamma(barcode_count) > 0) == (barcode_count > LARGE_PANEL_B)
    full = SimpleNamespace(
        barcode_count=barcode_count, noise=0.05, random_barcode_probability=4.0**-16,
        confidence_threshold=0.95, high_quality_threshold=30, high_quality_distance_threshold=0,
    )
    _, floats = pamld._scalars(full, w, eps, True, w, 0, 1)
    assert floats[10] == np.float32(2.0 * jax_classify._gamma(2 * chunks))


@pytest.fixture(scope="module")
def chunked_case():
    rng = np.random.default_rng(23)
    panel = random_panel(rng, 1500, 12)
    ontology = make_pamld_ontology(panel)
    code, qual, _ = simulate_reads(rng, panel, 256)
    # a fifth of the reads as noise, so the noise and confidence branches fire
    noise = rng.random(256) < 0.2
    code[noise] = np.array([1, 2, 4, 8], np.uint8)[rng.integers(4, size=(int(noise.sum()), 12))]
    return ontology, code, qual


def test_large_panel_chunked_posterior_matches_oracle(chunked_case):
    """test_device_classify.py::test_large_panel_chunked_posterior_matches_oracle
    on the port."""
    ontology, code, qual = chunked_case
    spec = spec_from_ontology(ontology, "sample")
    qcfail = np.zeros(code.shape[0], dtype=bool)
    oracle = pamld_classify(spec, code, qual, qcfail)
    instrument = compile_instrument({"sample": ontology, "input segment cardinality": 1}, "cpu")
    assert instrument.decoders[0].barcode_count > LARGE_PANEL_B
    device = classify.pamld_classify_device(
        instrument, instrument.decoders[0], _t(code), _t(qual), torch.from_numpy(qcfail)
    )
    np.testing.assert_array_equal(device["decoded"].numpy(), oracle.decoded)
    np.testing.assert_array_equal(device["qcfail"].numpy(), oracle.qcfail)
    np.testing.assert_array_equal(device["branch"].numpy(), oracle.branch)
    np.testing.assert_array_equal(device["distance"].numpy(), oracle.edit_distance)
    np.testing.assert_allclose(device["confidence"].numpy(), oracle.confidence, rtol=1e-3, atol=1e-6)
    assert (oracle.decoded == 0).any() and (oracle.decoded > 0).mean() > 0.5


def test_large_panel_chunked_posterior_matches_jax(chunked_case):
    ontology, code, qual = chunked_case
    rng = np.random.default_rng(5)
    qcfail = rng.random(code.shape[0]) < 0.05
    reference = jax_compile({"sample": ontology, "input segment cardinality": 1})
    ours = carry_instrument(reference, "cpu")
    theirs = jax_classify.pamld_classify_device(
        reference, reference.decoders[0], jnp.asarray(code.astype(np.int32)),
        jnp.asarray(qual.astype(np.int32)), jnp.asarray(qcfail), want_uncertain=True,
    )
    mine = classify.pamld_classify_device(
        ours, ours.decoders[0], _t(code), _t(qual), torch.from_numpy(qcfail), want_uncertain=True
    )
    theirs = {k: np.asarray(v) for k, v in theirs.items()}
    mine = {k: v.numpy() for k, v in mine.items()}
    settled = ~(theirs["uncertain"] | mine["uncertain"])
    assert settled.mean() > 0.5
    for key in ("decoded", "argmax", "distance", "branch", "qcfail"):
        np.testing.assert_array_equal(mine[key][settled], theirs[key][settled], err_msg=key)
    np.testing.assert_allclose(mine["confidence"][settled], theirs["confidence"][settled], rtol=1e-5, atol=0)
    assert (theirs["uncertain"] != mine["uncertain"]).mean() < 0.01


def test_chunked_posterior_equals_monolithic_within_rescale():
    """The online posterior (one rescale per 1024-barcode chunk) against
    the monolithic one on the same features: the same argmax and decoded
    sigma (the sigma sums are the same per column), sums within the
    bound's rescale term."""
    rng = np.random.default_rng(3)
    panel = random_panel(rng, 3000, 10)
    instrument = compile_instrument({"sample": make_pamld_ontology(panel), "input segment cardinality": 1}, "cpu")
    dec = instrument.decoders[0]
    code, qual, _ = simulate_reads(rng, panel, 200, error_rate=0.1)
    features = pamld.observation_features_plain(_t(code), _t(qual))
    qpos = (_t(qual) > 0).to(torch.float32).sum(dim=1) * pamld.UNIFORM_BASE_QUALITY
    args = (features, qpos, dec.likelihood_matrix, dec.concentration, dec.noise * dec.random_barcode_probability)
    mono = pamld.posterior_plain(*args)
    chunked = pamld.posterior_chunked_plain(*args)
    assert torch.equal(mono[0], chunked[0])
    assert torch.equal(mono[3], chunked[3])
    for a, b in zip(mono[1:3] + mono[4:], chunked[1:3] + chunked[4:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=0)


def test_100k_barcode_panel_smoke():
    """test_device_classify.py::test_100k_barcode_panel_smoke on the port:
    98 chunks, decisions equal to the oracle's."""
    rng = np.random.default_rng(99)
    panel = random_panel(rng, 100000, 16)
    ontology = make_pamld_ontology(panel)
    spec = spec_from_ontology(ontology, "sample")
    code, qual, _ = simulate_reads(rng, panel, 48)
    qcfail = np.zeros(48, dtype=bool)
    oracle = pamld_classify(spec, code, qual, qcfail)
    instrument = compile_instrument({"sample": ontology, "input segment cardinality": 1}, "cpu")
    device = classify.pamld_classify_device(
        instrument, instrument.decoders[0], _t(code), _t(qual), torch.from_numpy(qcfail)
    )
    np.testing.assert_array_equal(device["decoded"].numpy(), oracle.decoded)
    np.testing.assert_array_equal(device["qcfail"].numpy(), oracle.qcfail)


WIDTHS = [8, 8, 28]


@pytest.fixture(scope="module", params=[1500, 33000])
def large_step_case(request):
    """The flagship with a cellular panel past LARGE_PANEL_B: 1500 barcodes,
    and 33000 (int32 decoded indices on the wire, d2h_layout's "wide")."""
    cellular = request.param
    ontology = flagship_ontology(cellular_barcodes=cellular)
    reference = jax_compile(ontology)
    ours = carry_instrument(reference, "cpu")
    n = 1024
    batch = synthetic_batch(ontology, n, seed=41, error_rate=0.05)
    rng = np.random.default_rng(42)
    used = [batch["segments"][i] for i in reference.used_segments]
    for _, _, length in used:
        length[rng.random(n) < 0.02] = rng.integers(0, 8)
    qcfail = rng.random(n) < 0.03
    code = np.concatenate([c.ravel() for c, _, _ in used])
    qual = np.concatenate([q.ravel() for _, q, _ in used])
    pairs = np.unique((code.astype(np.int64) & 15) << 8 | np.minimum(qual, 63))
    ccb, qcb, lut_idx, lut_exact = wire.sense_joint_codebook(pairs)
    blob = wire.pack_h2d_blob(WIDTHS, used, qcfail, qual_bits="j4", qual_lut=(lut_idx, lut_exact))
    blob[-16:] = 0
    blob[-16:, -1] = wire.H2D_PAD | wire.H2D_QCFAIL
    jax_step = jax.jit(
        make_decode_step(
            reference, want_uncertain=True, want_counters=True,
            pack_outputs=True, h2d_widths=WIDTHS, qual_bits="j4",
        )
    )
    packed, flat = jax_step({"blob": jnp.asarray(blob), "qcb": jnp.asarray(qcb), "ccb": jnp.asarray(ccb)})
    step = DecodeStep(ours, WIDTHS, "j4", want_uncertain=True)
    mine_blob, mine_counters = step(*(torch.from_numpy(x) for x in (blob, ccb, qcb)))
    layout = wire.d2h_layout(ours, True)
    return (
        ours, layout,
        mine_blob.numpy().reshape(-1, layout["total"]),
        np.asarray(packed["blob"]).reshape(-1, layout["total"]),
        mine_counters.numpy(), np.asarray(flat),
    )


def test_large_panel_step_decision_blob_matches(large_step_case):
    ours, layout, mine, theirs, _, _ = large_step_case
    wide = ours.decoders[2].barcode_count >= 32000
    assert layout["wide"] == wide and layout["index_size"] == (4 if wide else 2)
    assert mine.shape == theirs.shape == (1024, layout["total"])
    u = layout["uncertain_offset"]
    unsure = (mine[:, u] | theirs[:, u]).astype(bool)
    assert 0 < unsure.mean() < 0.5
    settled = ~unsure
    ints = slice(0, layout["int_bytes"])
    np.testing.assert_array_equal(mine[settled, ints], theirs[settled, ints])
    qc = slice(layout["qcfail_offset"], layout["qcfail_offset"] + layout["qcfail_bytes"])
    np.testing.assert_array_equal(mine[settled, qc], theirs[settled, qc])
    np.testing.assert_array_equal(mine[:, u], theirs[:, u])
    floats = slice(layout["float_offset"], layout["float_offset"] + layout["float_bytes"])
    conf_mine = np.ascontiguousarray(mine[:, floats]).view(np.float32)
    conf_theirs = np.ascontiguousarray(theirs[:, floats]).view(np.float32)
    np.testing.assert_allclose(conf_mine[settled], conf_theirs[settled], rtol=1e-5, atol=0)
    decoded = np.ascontiguousarray(mine[:, ints]).view(np.int32 if wide else np.int16)
    assert (decoded[settled, 1] > 0).mean() > 0.8  # the cellular decoder


def test_large_panel_step_counters_match(large_step_case):
    ours, _, _, _, mine, theirs = large_step_case
    assert mine.shape == theirs.shape
    offset = 0
    for _, name, size in wire.counter_layout(ours):
        a, b = mine[offset : offset + size], theirs[offset : offset + size]
        if name in ("accumulated_confidence", "accumulated_pf_confidence"):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
        offset += size


# --- the redesigned tile loop (csrc/pamld.cu) ------------------------------


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2**32 - 1), st.sampled_from([8, 16, 24]))
def test_kernel_sigma_order_within_the_bound(seed, w):
    """The tile loop's sigma order (pamld.sigma_tile_order: match terms,
    then the read's strictness sum with qpos*U; or the interleaved loop for
    a barcode with other codes) stays within d_sigma(read) of the f64 sum
    of the same f32 terms, for random reads (N and IUPAC codes, qualities
    0-41) and panels of strict and mixed barcodes."""
    rng = np.random.default_rng(seed)
    n, b = 24, 40
    panel = np.array(STRICT_CODES, np.uint8)[rng.integers(4, size=(b, w))]
    mixed = rng.random(b) < 0.3
    panel[mixed, rng.integers(w, size=int(mixed.sum()))] = rng.choice([15, 3, 5, 12], size=int(mixed.sum()))
    code = np.where(rng.random((n, w)) < 0.7, panel[rng.integers(b, size=n)],
                    rng.choice([0, 1, 2, 4, 8, 15], size=(n, w))).astype(np.uint8)
    qual = rng.integers(0, 42, size=(n, w)).astype(np.uint8)
    mine = pamld.sigma_tile_order(_t(code), _t(qual), _t(panel)).numpy().astype(np.float64)
    features = pamld.observation_features_plain(_t(code), _t(qual)).numpy().astype(np.float64)
    g = _panel_matrices(panel, np.ones(b, np.float32), "cpu")[2].numpy().astype(np.float64)
    qpos_u = (qual > 0).sum(axis=1) * np.float64(np.float32(pamld.UNIFORM_BASE_QUALITY))
    exact = features @ g + qpos_u[:, None]
    bound = pamld.sigma_bound(w, 0.0, torch.from_numpy(qual.astype(np.float32)).sum(dim=1)).numpy()
    assert (np.abs(mine - exact) <= bound[:, None]).all()


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 2**18), st.integers(1, 800_000), st.sampled_from([512, 1024, 2048]),
       st.sampled_from([128, 256]), st.integers(1, 1200))
def test_slice_plan_covers_the_panel(n, barcodes, tile, reads_per_block, slots):
    """The slice plan, a pure function of (N, B, tile, reads a block,
    resident block slots): every column once, in order, in whole tiles,
    each slice at least one tile; at least SLICE_WAVES waves where the
    tiles allow, and the fewest slices that give them."""
    plan = pamld.slice_plan(n, barcodes, tile, reads_per_block, slots)
    columns = plan.columns()
    assert len(columns) == plan.slices >= 1
    assert columns[0][0] == 0 and columns[-1][1] == barcodes
    for (_, stop), (start, _) in zip(columns, columns[1:]):
        assert stop == start and start % tile == 0
    assert all(stop > start for start, stop in columns)
    tiles = -(-barcodes // tile)
    assert plan.slices <= tiles and plan.read_blocks == -(-n // reads_per_block)
    if plan.slices < tiles:
        assert plan.waves >= pamld.SLICE_WAVES
    if plan.slices > 1:
        assert plan.read_blocks * (plan.slices - 1) / slots < pamld.SLICE_WAVES


@pytest.mark.parametrize("barcodes,tile", [(1025, 256), (5000, 2048), (3000, 512)])
def test_sliced_posterior_matches_chunked_and_jax(barcodes, tile):
    """The plain posterior over the slices of a plan, merged in slice
    order by reduce_partials (K7's algebra), against the port's chunked
    posterior and JAX's _posterior_chunked on the same features: decisions
    equal on the rows neither flags, confidences rtol 1e-5 there."""
    rng = np.random.default_rng(barcodes)
    panel = random_panel(rng, barcodes, 12)
    instrument = compile_instrument({"sample": make_pamld_ontology(panel), "input segment cardinality": 1}, "cpu")
    dec = instrument.decoders[0]
    code, qual, _ = simulate_reads(rng, panel, 300, error_rate=0.08)
    noise = rng.random(300) < 0.2
    code[noise] = np.array(STRICT_CODES, np.uint8)[rng.integers(4, size=(int(noise.sum()), 12))]
    qcfail = torch.from_numpy(rng.random(300) < 0.05)
    features = pamld.observation_features_plain(_t(code), _t(qual))
    qpos = (_t(qual) > 0).to(torch.float32).sum(dim=1) * pamld.UNIFORM_BASE_QUALITY
    args = (features, qpos, dec.likelihood_matrix, dec.concentration, dec.noise * dec.random_barcode_probability)
    plan = pamld.slice_plan(300, barcodes, tile, 256, 10_000)
    assert plan.slices == -(-barcodes // tile) > 1 and barcodes % tile
    sliced = pamld.posterior_sliced_plain(*args, plan.columns())
    theirs = jax_classify._posterior_chunked(*(jnp.asarray(x.numpy()) for x in args[:4]), args[4])
    posteriors = {
        "sliced": sliced,
        "chunked": pamld.posterior_chunked_plain(*args),
        "jax": tuple(torch.from_numpy(np.asarray(x).copy()) for x in theirs),
    }
    eps = instrument.tpq_analytic_eps
    results = {
        name: pamld.finish_plain(dec, _t(code), _t(qual), qcfail, (post[0].to(torch.int64),) + tuple(post[1:]),
                                 want_uncertain=True, eps=eps)
        for name, post in posteriors.items()
    }
    mine = results["sliced"]
    for name in ("chunked", "jax"):
        other = results[name]
        settled = ~(mine["uncertain"] | other["uncertain"])
        assert settled.float().mean() > 0.5
        for key in ("decoded", "argmax", "distance", "branch", "qcfail"):
            assert torch.equal(mine[key][settled], other[key][settled]), (name, key)
        np.testing.assert_allclose(mine["confidence"][settled].numpy(), other["confidence"][settled].numpy(),
                                   rtol=1e-5, atol=0, err_msg=name)


def _sigma_f64(dec, code, qual) -> torch.Tensor:
    """sigma (N, B) from the float64 sums of the same f32 terms, F.G + qpos*U."""
    features = pamld.observation_features_plain(_t(code), _t(qual)).to(torch.float64)
    qpos_u = torch.from_numpy((qual > 0).sum(axis=1)) * float(np.float32(pamld.UNIFORM_BASE_QUALITY))
    return features @ dec.likelihood_matrix.to(torch.float64) + qpos_u[:, None]


@pytest.mark.parametrize("barcodes,width", [(1025, 12), (5000, 12), (3000, 10), (5000, 16)])
def test_tile_order_matches_plain_and_jax(barcodes, width):
    """pamld_classify_tile_order (the tile loop's own arithmetic, which
    chip_smoke holds the kernel to on every row) against the plain version
    (pamld_classify_plain) and JAX's _posterior_chunked, each finished by
    finish_plain, on reads near the panel, random reads and reads of flat
    qualities (exact ties): decisions equal on the rows neither flags; a
    row whose decisions differ anywhere is a near tie in f64 (tie_gaps:
    the two best barcodes within lambda * 2 d_sigma), with no other row
    differing; confidences rtol 1e-5 of the f64 posterior of the same f32
    terms, each, on settled rows; and rtol 1e-5 of each other there at W
    <= 12. At W = 16 the tile order's sigma, M + C with M and C both of
    about the read's quality sum, lies up to ~7e-6 of a low confidence
    from exact where the contraction lies ~4e-6, so the two may differ by
    more than 1e-5 of each other; each is held to the f64 value instead."""
    rng = np.random.default_rng(barcodes + width)
    n = 400
    panel = random_panel(rng, barcodes, width)
    instrument = compile_instrument({"sample": make_pamld_ontology(panel), "input segment cardinality": 1}, "cpu")
    dec = instrument.decoders[0]
    code, qual, _ = simulate_reads(rng, panel, n, error_rate=0.08)
    noise = rng.random(n) < 0.3
    code[noise] = np.array(STRICT_CODES, np.uint8)[rng.integers(4, size=(int(noise.sum()), width))]
    qual[rng.random(n) < 0.3] = 30
    qcfail = torch.from_numpy(rng.random(n) < 0.05)
    kwargs = dict(want_uncertain=True, eps=instrument.tpq_analytic_eps)
    twin = pamld.pamld_classify_tile_order(dec, _t(code), _t(qual), qcfail, **kwargs)
    features = pamld.observation_features_plain(_t(code), _t(qual))
    qpos = (_t(qual) > 0).to(torch.float32).sum(dim=1) * pamld.UNIFORM_BASE_QUALITY
    theirs = jax_classify._posterior_chunked(
        *(jnp.asarray(x.numpy()) for x in (features, qpos, dec.likelihood_matrix, dec.concentration)),
        dec.noise * dec.random_barcode_probability,
    )
    post = tuple(torch.from_numpy(np.asarray(x).copy()) for x in theirs)
    others = {
        "plain": pamld.pamld_classify_plain(dec, _t(code), _t(qual), qcfail, **kwargs),
        "jax": pamld.finish_plain(dec, _t(code), _t(qual), qcfail, (post[0].to(torch.int64),) + post[1:], **kwargs),
    }
    exact = _confidence_f64(dec, _sigma_f64(dec, code, qual)).numpy()
    keys = ("decoded", "argmax", "distance", "branch", "qcfail")
    for name, other in others.items():
        settled = ~(twin["uncertain"] | other["uncertain"])
        assert settled.float().mean() > 0.8
        differs = torch.zeros(n, dtype=torch.bool)
        for key in keys:
            assert torch.equal(twin[key][settled], other[key][settled]), (name, key)
            differs |= twin[key] != other[key]
        rows = differs.nonzero()[:, 0]
        gap, window = pamld.tie_gaps(dec, _t(code)[rows], _t(qual)[rows], twin["argmax"][rows] - 1,
                                     other["argmax"][rows] - 1)
        assert bool((twin["argmax"][rows] != other["argmax"][rows]).all()), name
        assert bool((gap <= window).all()), (name, gap, window)
        held = (settled & (twin["confidence"] > 0)).numpy()
        for side in (twin, other):
            np.testing.assert_allclose(side["confidence"].numpy()[held], exact[held], rtol=1e-5, atol=0, err_msg=name)
        if width <= 12:
            np.testing.assert_allclose(twin["confidence"].numpy()[held], other["confidence"].numpy()[held],
                                       rtol=1e-5, atol=0, err_msg=name)
