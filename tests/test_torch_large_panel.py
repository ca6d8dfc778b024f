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

import math
from fractions import Fraction

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
       st.sampled_from([128, 256]), st.integers(1, 1200), st.sampled_from([2, 8, 48]),
       st.sampled_from([0, 396, 528]))
def test_slice_plan_covers_the_panel(n, barcodes, tile, reads_per_block, slots, unit, whole_slots):
    """The slice plan, a pure function of (N, B, tile, reads a block,
    resident block slots, the kernel's unit, the one-launch instance's
    slots): every column once, in order; a panel of one tile in one slice
    unless its slices fill the block slots of their waves (blocks over
    slots of the whole waves taken) better than one launch fills its own;
    else the slices cut at whole tiles where the tiles give
    SLICE_WAVES waves, the same columns as the plan of whole tiles alone
    gave (a whitelist's slices do not move), else at multiples of the unit
    (a panel of one tile too); each slice at least one cut (the last may
    hold the ragged end); at least SLICE_WAVES waves where the cuts allow,
    and the fewest slices that give them."""
    plan = pamld.slice_plan(n, barcodes, tile, reads_per_block, slots, unit, whole_slots)
    columns = plan.columns()
    assert len(columns) == plan.slices >= 1
    assert columns[0][0] == 0 and columns[-1][1] == barcodes
    assert plan.read_blocks == -(-n // reads_per_block)
    if whole_slots and barcodes <= tile:
        sliced = pamld.slice_plan(n, barcodes, tile, reads_per_block, slots, unit)

        def fill(waves):
            return waves / math.ceil(waves)

        if sliced.slices == 1 or (fill(Fraction(plan.read_blocks * sliced.slices, slots))
                                  <= fill(Fraction(plan.read_blocks, whole_slots))):
            assert plan.slices == 1 and columns == [(0, barcodes)] and plan.waves == plan.read_blocks / whole_slots
            return
        assert plan == sliced and plan.slices > 1
    tiles = -(-barcodes // tile)
    wanted = -(-pamld.SLICE_WAVES * slots // plan.read_blocks)
    assert plan.cut == (tile if tiles >= wanted else unit)
    for (_, stop), (start, _) in zip(columns, columns[1:]):
        assert stop == start and start % plan.cut == 0
    assert all(stop - start >= min(plan.cut, barcodes - start) for start, stop in columns)
    cuts = -(-barcodes // plan.cut)
    assert plan.slices <= cuts
    if plan.slices < cuts:
        assert plan.waves >= pamld.SLICE_WAVES
    if plan.slices > 1:
        assert plan.read_blocks * (plan.slices - 1) / slots < pamld.SLICE_WAVES
    if tiles >= wanted:
        s = plan.slices
        assert s == min(tiles, wanted)
        assert columns == [(k * tiles // s * tile, min((k + 1) * tiles // s * tile, barcodes)) for k in range(s)]


#: the W <= 16 tile loop on the H100 (phq_pamld_info): tiles of 2048
#: barcodes, 256 reads a block, 132 SMs x 4 blocks for the sliced stages
#: and for the one-launch instance, a unit of 48
H100_LOOP = dict(tile=2048, reads_per_block=256, slots=132 * 4, unit=48)


@pytest.mark.parametrize("n,barcodes,slices,cut", [
    (131072, 96, 1, 96), (131072, 384, 1, 384), (131072, 1024, 1, 1024), (131072, 4096, 5, 48),
    (131072, 737_280, 5, 2048), (20000, 96, 2, 48), (20000, 384, 8, 48), (200_000, 384, 3, 48),
    (16384, 96, 2, 48), (16384, 384, 8, 48), (65536, 96, 2, 48), (98304, 96, 1, 96), (98304, 384, 6, 48),
    (196608, 96, 2, 48), (196608, 384, 3, 48), (262144, 96, 1, 96), (262144, 384, 1, 384),
    (20000, 2048, 27, 48), (131072, 2048, 1, 2048),
])
def test_slice_plan_at_the_main_path_shapes(n, barcodes, slices, cut):
    """With the H100's figures: a flagship batch (N = 131072, 512 read
    blocks) fills the one-launch instance's 528 slots to 0.97 of a wave, and
    so would its slices, so K1's panels keep one launch (as at 262144,
    1.94 waves); a batch that leaves one launch's slots idle and whose
    slices fill theirs better (the CLI's default of 16384 reads, the TP
    phase's 20,000, 65536; 98304 and 196608 at B = 384) is cut below the
    tile into the waves its units allow, while at 98304 reads B = 96's two
    slices fill 1.45 waves no better than one launch's 0.73 and it keeps
    one launch; a K8 shard of 2048 barcodes at 20,000 reads runs 27
    slices; the 4096-barcode panel is cut below a tile too (2 tiles gave
    1.94 waves); the whitelist keeps its 5 slices of whole tiles, tiles
    [72k, 72(k+1)) of its 360."""
    plan = pamld.slice_plan(n, barcodes, whole_slots=132 * 4, **H100_LOOP)
    assert (plan.slices, plan.cut) == (slices, cut)
    if slices > 1:
        assert plan.waves >= min(pamld.SLICE_WAVES, plan.read_blocks * -(-barcodes // cut) / 528)
    if barcodes == 737_280:
        assert plan.columns() == [(k * 72 * 2048, (k + 1) * 72 * 2048) for k in range(5)]


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
    plan = pamld.slice_plan(300, barcodes, tile, 256, 10_000, tile)
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


@pytest.mark.parametrize("barcodes", [96, 384, 1000])
def test_sub_tile_slices_match_monolithic_and_jax(barcodes):
    """K1's slices below a tile (the sliced plan at N = 131072 on the H100's
    figures: 48-barcode cuts, S = 2 or 5; 1000 is no multiple of the cut):
    the plain posterior over the plan's columns (posterior_sliced_plain)
    finished by finish_plain, against the monolithic posterior
    (posterior_plain, pamld_classify_plain's for B <= 1024) and JAX's
    pamld_classify_device on the same reads, W = 16: decisions equal on
    the rows neither flags, confidences rtol 1e-5 there (the totals are
    summed in another order)."""
    rng = np.random.default_rng(barcodes)
    n, width = 400, 16
    panel = random_panel(rng, barcodes, width)
    ontology = {"sample": make_pamld_ontology(panel), "input segment cardinality": 1}
    reference = jax_compile(ontology)
    ours = carry_instrument(reference, "cpu")
    dec = ours.decoders[0]
    code, qual, _ = simulate_reads(rng, panel, n, error_rate=0.08)
    noise = rng.random(n) < 0.2
    code[noise] = np.array(STRICT_CODES, np.uint8)[rng.integers(4, size=(int(noise.sum()), width))]
    qcfail = rng.random(n) < 0.05
    plan = pamld.slice_plan(131072, barcodes, **H100_LOOP)
    columns = plan.columns()
    assert plan.slices > 1 and plan.cut == 48 and columns[-1][1] == barcodes
    assert any(start % 2048 for start, _ in columns)
    code_t, qual_t, qcfail_t = _t(code), _t(qual), torch.from_numpy(qcfail)
    features = pamld.observation_features_plain(code_t, qual_t)
    qpos = (qual_t > 0).to(torch.float32).sum(dim=1) * pamld.UNIFORM_BASE_QUALITY
    args = (features, qpos, dec.likelihood_matrix, dec.concentration, dec.noise * dec.random_barcode_probability)
    kwargs = dict(want_uncertain=True, eps=ours.tpq_analytic_eps)
    mine = pamld.finish_plain(dec, code_t, qual_t, qcfail_t, pamld.posterior_sliced_plain(*args, columns), **kwargs)
    monolithic = pamld.finish_plain(dec, code_t, qual_t, qcfail_t, pamld.posterior_plain(*args), **kwargs)
    assert all(torch.equal(monolithic[key], value) for key, value in pamld.pamld_classify_plain(
        dec, code_t, qual_t, qcfail_t, **kwargs).items())
    theirs = jax_classify.pamld_classify_device(
        reference, reference.decoders[0], jnp.asarray(code.astype(np.int32)), jnp.asarray(qual.astype(np.int32)),
        jnp.asarray(qcfail), want_uncertain=True,
    )
    others = {"monolithic": monolithic, "jax": {k: torch.from_numpy(np.asarray(v).copy()) for k, v in theirs.items()}}
    for name, other in others.items():
        settled = ~(mine["uncertain"] | other["uncertain"])
        assert settled.float().mean() > 0.5, name
        for key in ("decoded", "argmax", "distance", "branch", "qcfail"):
            assert torch.equal(mine[key][settled], other[key][settled].to(mine[key].dtype)), (name, key)
        np.testing.assert_allclose(mine["confidence"][settled].numpy(), other["confidence"][settled].numpy(),
                                   rtol=1e-5, atol=0, err_msg=name)
    assert (mine["decoded"] == 0).any() and (mine["decoded"] > 0).float().mean() > 0.5


def _running_posterior(p, sigma, start: int):
    """The kernel's running posterior (csrc/pamld.cu PhqPosterior::add)
    over the columns of `p` in order, the first global column `start`:
    (total, best, best0, second, sigma_best)."""
    n = p.shape[0]
    total = torch.zeros(n)
    best = torch.full((n,), -1.0)
    second = torch.zeros(n)
    sigma_best = torch.zeros(n)
    best0 = torch.zeros(n, dtype=torch.int32)
    for j in range(p.shape[1]):
        c = p[:, j]
        total = total + c
        better = c > best
        second = torch.where(better, torch.maximum(second, best), torch.maximum(second, c))
        best0 = torch.where(better, start + j, best0)
        sigma_best = torch.where(better, sigma[:, j], sigma_best)
        best = torch.where(better, c, best)
    return total, best, best0, second, sigma_best


@pytest.mark.parametrize("barcodes", [96, 384, 1000])
def test_slice_merge_equals_one_pass(barcodes):
    """The merge algebra alone, on ONE sigma matrix (sigma_tile_order,
    computed once): the slices of K1's plan each run the kernel's running
    posterior, merged in slice order by device/tp.py:reduce_partials,
    against one running posterior over every column. best, best0, second
    and sigma_best bit-equal on every row, the slices' row minima merged to
    the same shift, and the total within the bound's gamma_b term
    (2*gamma(B+2) of itself: any summation tree of the B terms). The panel
    repeats barcodes within a slice and across slices, so exact ties
    (the first global index wins) and duplicated maxima (the runner-up
    keeps them) occur."""
    from pheniqs_tpu_torch.device import tp
    from pheniqs_tpu_torch.device.instrument import LN_PHRED_BASE

    rng = np.random.default_rng(barcodes + 1)
    n, width = 300, 16
    panel = random_panel(rng, barcodes, width)
    plan = pamld.slice_plan(131072, barcodes, **H100_LOOP)
    columns = plan.columns()
    assert plan.slices >= 2
    # barcode 3 again late in slice 0 and in the last slice; the last slice's
    # first barcode again in slice 1
    panel[columns[0][1] - 1] = panel[3]
    panel[columns[-1][1] - 1] = panel[3]
    panel[columns[1][0] + 1] = panel[columns[-1][0]]
    code, qual, _ = simulate_reads(rng, panel, n, error_rate=0.05)
    qual[rng.random(n) < 0.3] = 30
    codes = np.array([[STRICT_CODES["ACGT".index(base)] for base in word] for word in panel], np.uint8)
    code[:40] = codes[3]
    code[40:80] = codes[columns[-1][0]]
    sigma = pamld.sigma_tile_order(_t(code), _t(qual), torch.from_numpy(codes))
    concentration = torch.full((barcodes,), 0.95 / barcodes)
    minima = torch.stack([sigma[:, start:stop].min(dim=1).values for start, stop in columns])
    shift = sigma.min(dim=1).values
    assert torch.equal(tp.merge_panel_shift(minima), shift)
    p = torch.exp(LN_PHRED_BASE * (sigma - shift[:, None])) * concentration[None, :]
    one = dict(zip(pamld.PARTIAL_ROWS, _running_posterior(p, sigma, 0)))
    partials = torch.stack([
        pamld.pack_partials(*_running_posterior(p[:, start:stop], sigma[:, start:stop], start))
        for start, stop in columns
    ])
    merged = pamld.unpack_partials(tp.reduce_partials(partials))
    for key in ("best_p", "best0", "second_p", "sigma_best"):
        a, b = merged[key], one[key]
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), key
    tolerance = 2.0 * pamld.gamma(barcodes + 2)
    assert bool(((merged["total"] - one["total"]).abs() <= tolerance * one["total"]).all())
    duplicated = one["second_p"] == one["best_p"]
    tied = torch.isin(one["best0"], torch.tensor([3, columns[1][0] + 1]))
    assert int(duplicated.sum()) > 0 and int((duplicated & tied).sum()) > 0


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
