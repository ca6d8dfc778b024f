"""The inputs the CUDA kernels once refused, through the port's plain
versions (each kernel's arithmetic on the CPU) against the JAX package at
small sizes: PAMLD observations past 64 positions (K1 at 65-160, K7 at
1100 barcodes, K8 over two shards), MDD past 8 segments or 64 positions
(K6), a token program past 2048 ints (K3), 40 decoders (K4, K5), and the
wide flagship through both engines. The kernels themselves run on the
card (tests/test_torch_kernels.py -m cuda, chip_smoke.py's wide phase).

Tolerances, as tests/test_torch_classify.py and test_torch_step.py state
them: decisions exact on the rows neither side flags uncertain (settled);
confidences rtol 1e-5 against JAX there; sigma atol 1e-3; K6's, K3's and
K4's integer columns and K5's bytes exact. At these widths the hybrid
bound flags nearly every confident read of a 0.95 threshold (a read's
quality sum grows with W, and so does its sigma's rounding), so the PAMLD
cases also run without a confidence threshold, where most rows settle.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pheniqs_tpu.device import classify as jax_classify
from pheniqs_tpu.device import compile_instrument as jax_compile
from pheniqs_tpu.device.step import _unpack_h2d_blob, make_decode_step
from pheniqs_tpu.device.tp import tp_mesh
from pheniqs_tpu.device.tp import tp_posterior as jax_tp_posterior
from pheniqs_tpu_torch.device import classify, tp, wire
from pheniqs_tpu_torch.device.flagship import (
    flagship_ontology,
    panel_codes,
    synthetic_batch,
    wide_flagship_ontology,
)
from pheniqs_tpu_torch.device.instrument import (
    STRICT_CODES,
    UNIFORM_BASE_QUALITY,
    DeviceDecoder,
    TokenPlan,
    carry_instrument,
)
from pheniqs_tpu_torch.device.step import DecodeStep
from pheniqs_tpu_torch.kernels import mdd, pack, pamld, unpack
from test_device_classify import make_pamld_ontology, random_panel, simulate_reads
from test_hybrid import decisions
from test_torch_engine import _run

KEYS = ("decoded", "argmax", "distance", "branch", "qcfail")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


def _pamld_case(width, barcodes, n, seed, confidence):
    """A random `barcodes` x `width` PAMLD panel compiled by the JAX package
    and carried to the port, and `n` reads drawn from it (a fifth of them
    random), as numpy code and quality rows."""
    rng = np.random.default_rng(seed)
    panel = random_panel(rng, barcodes, width)
    ontology = make_pamld_ontology(panel, confidence=confidence)
    reference = jax_compile({"sample": ontology, "input segment cardinality": 1})
    ours = carry_instrument(reference, "cpu")
    code, qual, _ = simulate_reads(rng, panel, n, error_rate=2.0 / width)
    noise = rng.random(n) < 0.2
    code[noise] = np.array(STRICT_CODES, np.uint8)[rng.integers(4, size=(int(noise.sum()), width))]
    qcfail = rng.random(n) < 0.05
    return reference, ours, code, qual, qcfail


def _hold_settled(mine, theirs, min_settled):
    """Decisions exact and confidences rtol 1e-5 on the rows neither side
    flags; the uncertain masks apart on at most 1 % of rows. Returns the
    settled mask."""
    mine = {k: np.asarray(v) for k, v in mine.items()}
    theirs = {k: np.asarray(v) for k, v in theirs.items()}
    settled = ~(mine["uncertain"] | theirs["uncertain"])
    assert settled.mean() >= min_settled, settled.mean()
    for key in KEYS:
        np.testing.assert_array_equal(mine[key][settled], theirs[key][settled], err_msg=key)
    np.testing.assert_allclose(mine["confidence"][settled], theirs["confidence"][settled], rtol=1e-5, atol=0)
    assert (mine["uncertain"] != theirs["uncertain"]).mean() < 0.01
    return settled


@pytest.mark.parametrize("confidence", [0.0, 0.95])
@pytest.mark.parametrize("width", [65, 96, 128, 160])
def test_pamld_wide_matches_jax(width, confidence):
    """K1's plain version at 65-160 positions (the looped instance's
    widths) against JAX's pamld_classify_device on 96 barcodes.
    Without a confidence threshold most rows settle; at 0.95 the bound
    flags nearly every confident read, which the hybrid host re-resolves."""
    reference, ours, code, qual, qcfail = _pamld_case(width, 96, 768, width, confidence)
    theirs = jax_classify.pamld_classify_device(
        reference, reference.decoders[0], jnp.asarray(code), jnp.asarray(qual), jnp.asarray(qcfail),
        want_uncertain=True,
    )
    mine = classify.pamld_classify_device(ours, ours.decoders[0], _t(code), _t(qual), torch.from_numpy(qcfail),
                                          want_uncertain=True)
    settled = _hold_settled(mine, theirs, 0.6 if confidence == 0.0 else 0.0)
    if confidence:
        # the bound's reach at these widths (chip_smoke's wide phase predicts it)
        assert settled.mean() < 0.5


@pytest.mark.parametrize("width,barcodes,mixed", [(97, 101, 0), (96, 96, 5)])
def test_pamld_wide_tails_match_jax(width, barcodes, mixed):
    """The shapes at the wide tile loop's tails against JAX's
    pamld_classify_device: W = 97 (not a multiple of 4 or 16: the last
    block of positions is one word) with B = 101 (not a multiple of the
    barcode loop's group or of the slice unit 48), and W = 96 with `mixed`
    barcodes holding an N (barcodes with other codes than A, C, G and T
    inside groups of strict ones; the reads drawn from the words without
    the N). The tile loop's twin (pamld_classify_tile_order, the kernels'
    sigma order) and the plain version are each held on settled rows."""
    rng = np.random.default_rng(width + barcodes + mixed)
    panel = random_panel(rng, barcodes, width)
    code, qual, _ = simulate_reads(rng, panel, 512, error_rate=2.0 / width)
    for k in range(mixed):
        word, at = panel[1 + 9 * k], 7 * k % width
        panel[1 + 9 * k] = word[:at] + "N" + word[at + 1 :]
    reference = jax_compile({"sample": make_pamld_ontology(panel, confidence=0.0), "input segment cardinality": 1})
    ours = carry_instrument(reference, "cpu")
    dec = ours.decoders[0]
    assert int((dec.panel_codes_u8 == 15).any(dim=1).sum()) == mixed
    qcfail = rng.random(512) < 0.05
    theirs = jax_classify.pamld_classify_device(
        reference, reference.decoders[0], jnp.asarray(code), jnp.asarray(qual), jnp.asarray(qcfail),
        want_uncertain=True,
    )
    kwargs = dict(want_uncertain=True, eps=ours.tpq_analytic_eps)
    twin = pamld.pamld_classify_tile_order(dec, _t(code), _t(qual), torch.from_numpy(qcfail), **kwargs)
    plain = pamld.pamld_classify_plain(dec, _t(code), _t(qual), torch.from_numpy(qcfail), **kwargs)
    for mine in (twin, plain):
        _hold_settled(mine, theirs, 0.6)


@pytest.mark.parametrize("width", [65, 128, 160])
def test_features_and_sigma_wide_match_jax(width):
    """The read features and sigma (F.G + qpos*U) of the plain version
    against JAX's observation_features and its HIGHEST-precision
    contraction: features exact; each sigma within d_sigma(read) of the f64
    sum of the same terms (pamld.sigma_bound, the bound the hybrid mode
    rests on). At these widths sigma reaches ~3000, where an f32 ulp is
    2.4e-4, so the two contractions' orders lie up to 8 ulps (0.002)
    apart: the atol of 1e-3 that holds at the flagship's ~300 does not."""
    reference, ours, code, qual, _ = _pamld_case(width, 96, 256, width + 2, 0.95)
    f_j = np.asarray(jax_classify.observation_features(reference, jnp.asarray(code), jnp.asarray(qual)))
    f_t = classify.observation_features(ours, _t(code), _t(qual)).numpy()
    np.testing.assert_array_equal(f_t, f_j)
    qpos = (_t(qual) > 0).to(torch.float32).sum(1)
    sigma_t = (torch.from_numpy(f_t) @ ours.decoders[0].likelihood_matrix + qpos[:, None] * UNIFORM_BASE_QUALITY)
    sigma_j = np.asarray(jnp.dot(jnp.asarray(f_j), reference.decoders[0].likelihood_matrix, precision="highest"))
    sigma_j = sigma_j + np.asarray(qpos)[:, None].astype(np.float32) * np.float32(UNIFORM_BASE_QUALITY)
    exact = (torch.from_numpy(f_t).double() @ ours.decoders[0].likelihood_matrix.double()).numpy()
    exact += (qpos.double() * float(np.float32(UNIFORM_BASE_QUALITY))).numpy()[:, None]
    bound = pamld.sigma_bound(width, 0.0, torch.from_numpy(qual.astype(np.float64)).sum(dim=1)).numpy()[:, None]
    for sigma in (sigma_t.numpy(), sigma_j):
        assert (np.abs(sigma.astype(np.float64) - exact) <= bound).all()


@pytest.mark.parametrize("width", [96, 160])
def test_tile_order_wide_within_the_bound(width):
    """The tile loop's sigma order (pamld.sigma_tile_order, which the MAXW
    128 and looped instances keep) within d_sigma(read) of the f64 sum of
    the same f32 terms, on reads with N codes and zero qualities against
    strict and mixed barcodes; and its whole arithmetic
    (pamld_classify_tile_order) against the plain contraction: decisions
    equal on settled rows, every row whose argmax differs a near tie in f64
    (pamld.tie_gaps)."""
    rng = np.random.default_rng(width)
    n, b = 48, 40
    panel = np.array(STRICT_CODES, np.uint8)[rng.integers(4, size=(b, width))]
    mixed = rng.random(b) < 0.3
    panel[mixed, rng.integers(width, size=int(mixed.sum()))] = rng.choice([15, 3, 5, 12], size=int(mixed.sum()))
    code = np.where(rng.random((n, width)) < 0.8, panel[rng.integers(b, size=n)],
                    rng.choice([0, 1, 2, 4, 8, 15], size=(n, width))).astype(np.uint8)
    qual = rng.integers(0, 42, size=(n, width)).astype(np.uint8)
    mine = pamld.sigma_tile_order(_t(code), _t(qual), _t(panel)).numpy().astype(np.float64)
    features = pamld.observation_features_plain(_t(code), _t(qual)).to(torch.float64)
    from pheniqs_tpu_torch.device.instrument import _panel_matrices

    g = _panel_matrices(panel, np.ones(b, np.float32), "cpu")[2].to(torch.float64)
    qpos_u = (qual > 0).sum(axis=1) * np.float64(np.float32(UNIFORM_BASE_QUALITY))
    exact = (features @ g).numpy() + qpos_u[:, None]
    bound = pamld.sigma_bound(width, 0.0, torch.from_numpy(qual.astype(np.float32)).sum(dim=1)).numpy()
    assert (np.abs(mine - exact) <= bound[:, None]).all()

    _, ours, code, qual, qcfail = _pamld_case(width, 96, 512, width + 1, 0.0)
    dec = ours.decoders[0]
    qcfail = torch.from_numpy(qcfail)
    kwargs = dict(want_uncertain=True, eps=ours.tpq_analytic_eps)
    twin = pamld.pamld_classify_tile_order(dec, _t(code), _t(qual), qcfail, **kwargs)
    other = pamld.pamld_classify_plain(dec, _t(code), _t(qual), qcfail, **kwargs)
    settled = _hold_settled(twin, other, 0.6)
    differs = torch.zeros(code.shape[0], dtype=torch.bool)
    for key in KEYS:
        differs |= twin[key] != other[key]
    rows = differs.nonzero()[:, 0]
    gap, window = pamld.tie_gaps(dec, _t(code)[rows], _t(qual)[rows], twin["argmax"][rows] - 1,
                                 other["argmax"][rows] - 1)
    assert bool((gap <= window).all()) and not bool(differs[torch.from_numpy(settled)].any())


def test_chunked_wide_matches_jax():
    """K7's plain version (the chunked posterior past 1024 barcodes) at 96
    positions and 1100 barcodes against JAX's."""
    reference, ours, code, qual, qcfail = _pamld_case(96, 1100, 384, 7, 0.0)
    theirs = jax_classify.pamld_classify_device(
        reference, reference.decoders[0], jnp.asarray(code), jnp.asarray(qual), jnp.asarray(qcfail),
        want_uncertain=True,
    )
    mine = classify.pamld_classify_device(ours, ours.decoders[0], _t(code), _t(qual), torch.from_numpy(qcfail),
                                          want_uncertain=True)
    _hold_settled(mine, theirs, 0.6)


def test_panel_sharded_wide_matches_tp_posterior():
    """K8's plain algebra at 96 positions over P = 2 shards of a
    301-barcode panel (a padded shard) against JAX's tp_posterior on a
    (1, 2) mesh (its tolerances: test_torch_tp.py), and its decisions
    (pamld_classify_sharded on the CPU) against the unsharded plain
    version on settled rows."""
    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual CPU mesh")
    _, ours, code, qual, qcfail = _pamld_case(96, 301, 384, 11, 0.0)
    dec = ours.decoders[0]
    features = pamld.observation_features_plain(_t(code), _t(qual))
    qpos = (_t(qual) > 0).to(torch.float32).sum(dim=1) * UNIFORM_BASE_QUALITY
    noise = float(dec.noise * dec.random_barcode_probability)
    inputs = [x.numpy() for x in (features, qpos, dec.likelihood_matrix, dec.concentration)]
    theirs = jax_tp_posterior(tp_mesh(1, 2), *map(jnp.asarray, inputs), noise)
    mine = tp.tp_posterior(*map(torch.from_numpy, inputs), noise, 2)
    for name, a, b in zip(("best0", "best_p", "sigma_p", "sigma_best", "second_p"), mine, theirs):
        if name == "best0":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            rtol = 5e-4 if name in ("best_p", "sigma_p") else 1e-3
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=1e-30, err_msg=name)
    shards = [tp.shard_panel(dec, rank, 2) for rank in range(2)]
    kwargs = dict(tpq_constants=None, want_uncertain=True, eps=ours.tpq_analytic_eps)
    sharded = pamld.pamld_classify_sharded(dec, shards, _t(code), _t(qual), torch.from_numpy(qcfail), **kwargs)
    whole = pamld.pamld_classify(dec, _t(code), _t(qual), torch.from_numpy(qcfail), **kwargs)
    _hold_settled(sharded, whole, 0.6)


def _mdd_ontology(words, widths, tolerance, qmt):
    starts = np.concatenate([[0], np.cumsum(widths)[:-1]])
    codec = {
        str(i + 1): {"barcode": [w[s : s + ws] for s, ws in zip(starts, widths)],
                     "concentration": 1.0 / len(words), "index": i + 1}
        for i, w in enumerate(words)
    }
    return {
        "algorithm": "mdd", "index": 1, "codec": codec, "distance tolerance": [tolerance] * len(widths),
        "quality masking threshold": qmt,
        "transform": {"token": [f"0:{s}:{s + ws}" for s, ws in zip(starts, widths)]},
    }


@pytest.mark.parametrize("segments,width", [(9, 80), (12, 80), (9, 130), (12, 130)])
def test_mdd_wide_matches_jax(segments, width):
    """K6 past 8 segments and 64 positions (the wide instance): its
    two-phase algorithm (the key table's lookup, then the first barcode
    within every segment's tolerance from the key table's bit planes)
    and its plain version against JAX's mdd_classify_device byte for byte,
    at tolerance 1 and at tolerance 2 with quality masking and 3 % of the
    segments short (a tenth of the reads random: misses); its key words
    and segment table as the kernel takes them."""
    widths = [width // segments + (1 if s < width % segments else 0) for s in range(segments)]
    assert sum(widths) == width
    for tolerance, qmt, short in ((1, 0, 0.0), (2, 5, 0.03)):
        rng = np.random.default_rng(segments * width + tolerance)
        words = random_panel(rng, 40, width)
        ontology = _mdd_ontology(words, widths, tolerance, qmt)
        reference = jax_compile({"sample": ontology, "input segment cardinality": 1})
        dec = carry_instrument(reference, "cpu").decoders[0]
        # the key table past 64 positions: words, sorted keys, index, then
        # the panel's 4 bit planes per 32 positions (its codes are IUPAC's)
        assert dec.key_table.numel() == 2 * 40 * mdd.key_words(width) + 40 + 4 * 40 * mdd.groups(width)
        np.testing.assert_array_equal(mdd.table_planes(dec.key_table, 40, width).numpy(),
                                      mdd.plane_words(dec.panel_codes_u8.numpy(), 4))
        table = mdd.segment_table(widths, [tolerance] * segments).reshape(segments, -1)
        assert table.shape[1] == 4 + 2 * mdd.mask_words(width) and (table[:, 1] == widths).all()
        n = 512
        code, qual, _ = simulate_reads(rng, words, n, error_rate=0.5 / width)
        noise = rng.random(n) < 0.1
        code[noise] = np.array(STRICT_CODES, np.uint8)[rng.integers(4, size=(int(noise.sum()), width))]
        lengths = np.tile(np.array(widths, np.int32), (n, 1))
        cut = rng.random(lengths.shape) < short
        lengths[cut] = rng.integers(0, np.broadcast_to(np.array(widths), lengths.shape)[cut] + 1)
        starts = np.concatenate([[0], np.cumsum(widths)[:-1]])
        for s, (start, ws) in enumerate(zip(starts, widths)):
            beyond = np.arange(ws)[None, :] >= lengths[:, s : s + 1]
            code[:, start : start + ws][beyond] = 0
            qual[:, start : start + ws][beyond] = 0
        qcfail = rng.random(n) < 0.05
        obs = [(code[:, s : s + ws].astype(np.int32), qual[:, s : s + ws].astype(np.int32), lengths[:, k])
               for k, (s, ws) in enumerate(zip(starts, widths))]
        theirs = jax_classify.mdd_classify_device(
            reference.decoders[0], [tuple(jnp.asarray(x) for x in o) for o in obs], jnp.asarray(qcfail))
        args = (dec, torch.from_numpy(code), torch.from_numpy(qual), torch.from_numpy(lengths),
                torch.from_numpy(qcfail))
        twin = mdd.mdd_classify_two_phase(*args)
        plain = mdd.mdd_classify_plain(*args)
        for key in KEYS + ("confidence",):
            np.testing.assert_array_equal(twin[key].numpy(), np.asarray(theirs[key]), err_msg=key)
            np.testing.assert_array_equal(plain[key].numpy(), np.asarray(theirs[key]), err_msg=key)
        decoded = twin["decoded"].numpy()
        assert twin["exact"].any() and (~twin["exact"].numpy() & (decoded > 0)).any() and (decoded == 0).any()


def test_unpack_program_past_2048_matches_jax():
    """K3's plain version on an instrument whose token program takes more
    than 2048 ints (three decoders of 90-100 token plans: negative starts
    and ends, reverse complement, several plans into one segment) on the
    j4 and 6-bit wires, against JAX's _unpack_h2d_blob + apply_plans; the
    kernel's plan builds for it."""
    rng = np.random.default_rng(13)
    decoders = []
    for d, count in enumerate((100, 95, 90)):
        plans = [TokenPlan(p % 2, (p % 20) - (6 if p % 7 == 0 else 0), p % 20 + 1 + p % 3, bool(p % 4),
                           p % 5 == 0, p % 6, 1 + p % 3) for p in range(count)]
        widths = [sum(plan.width for plan in plans if plan.output_segment_index == s) for s in range(6)]
        decoders.append(DeviceDecoder("mdd" if d == 1 else "pamld", "cellular", d, True, plans, widths))
    instrument = SimpleNamespace(decoders=decoders)
    n, wire_widths = 256, [24, 32]
    # 15 (code, quality) pairs: the j4 wire's codebook holds 16
    segments = [(rng.choice([1, 2, 4, 8, 15], size=(n, w)).astype(np.int32),
                 rng.choice([2, 23, 37], size=(n, w)).astype(np.int32),
                 rng.integers(0, w + 1, size=n).astype(np.int32)) for w in wire_widths]
    for mode in ("j4", 6):
        layout = unpack.token_layout(instrument, wire_widths, mode)
        assert layout.program.size > 2048
        plan = unpack.unpack_plan(layout, unpack._segment_table(wire_widths, mode)[1] + 1)
        assert plan.shared_bytes <= unpack.SHARED_BYTES
        ccb = qcb = lut = None
        if mode == "j4":
            code = np.concatenate([c.ravel() for c, _, _ in segments])
            qual = np.concatenate([q.ravel() for _, q, _ in segments])
            pairs = np.unique((code.astype(np.int64) & 15) << 8 | np.minimum(qual, 63))
            ccb, qcb, lut_idx, lut_exact = wire.sense_joint_codebook(pairs)
            lut = (lut_idx, lut_exact)
        blob = wire.pack_h2d_blob(wire_widths, segments, rng.random(n) < 0.1, qual_bits=mode, qual_lut=lut)
        books = {} if ccb is None else {"ccb": torch.from_numpy(ccb), "qcb": torch.from_numpy(qcb)}
        mine = unpack.unpack_tokens_plain(instrument, layout, torch.from_numpy(blob), **books)
        jbooks = {} if ccb is None else {"ccb": jnp.asarray(ccb), "qcb": jnp.asarray(qcb)}
        theirs, qcfail, pad, forced = _unpack_h2d_blob(wire_widths, jnp.asarray(blob), mode, **jbooks)
        for slot, dec in enumerate(decoders):
            codes, quals, lengths, short = mine.observation(layout, slot)
            observation = jax_classify.apply_plans(dec, theirs)
            np.testing.assert_array_equal(codes.numpy(), np.concatenate([np.asarray(c) for c, _, _ in observation], 1))
            np.testing.assert_array_equal(quals.numpy(), np.concatenate([np.asarray(q) for _, q, _ in observation], 1))
            np.testing.assert_array_equal(lengths.numpy(), np.stack([np.asarray(x) for _, _, x in observation], 1))
            expected_short = np.zeros(n, bool)
            for (_, _, length), width in zip(observation, dec.segment_widths):
                expected_short |= np.asarray(length) < width
            np.testing.assert_array_equal(short.numpy(), expected_short)
        for mine_flag, their_flag in ((mine.qcfail, qcfail), (mine.pad, pad), (mine.forced, forced)):
            np.testing.assert_array_equal(mine_flag.numpy(), np.asarray(their_flag))


def _forty_decoders():
    """The flagship's sample decoder with 39 more: 18 cellular PAMLD
    decoders over the 8-nt windows of segment 0 (16 barcodes each) and 21
    naive ones over 4-nt windows of segment 3."""
    ontology = flagship_ontology()
    rng = np.random.default_rng(40)
    base = ontology["cellular"][0]
    ontology["cellular"] = []
    for k in range(18):
        words = random_panel(rng, 16, 8)
        ontology["cellular"].append(dict(
            base, index=2 + k,
            codec={str(i + 1): {"barcode": [w], "concentration": 0.95 / 16, "index": i + 1}
                   for i, w in enumerate(words)},
            **{"random barcode probability": 1.0 / 4**8, "transform": {"token": [f"0:{8 * k}:{8 * k + 8}"]}},
        ))
    ontology["molecular"] = [{"algorithm": "naive", "index": 20 + k, "transform": {"token": [f"3:{k}:{k + 4}"]}}
                             for k in range(21)]
    return ontology


@pytest.fixture(scope="module")
def forty_case():
    ontology = _forty_decoders()
    reference = jax_compile(ontology)
    ours = carry_instrument(reference, "cpu")
    assert len(ours.decoders) == 40
    batch = synthetic_batch(ontology, 2048, seed=40, error_rate=0.05)
    # segment 0 drawn from the 18 cellular panels, 1 % substitutions
    rng = np.random.default_rng(42)
    code0 = batch["segments"][0][0]
    for dec in ours.decoders:
        if dec.classifier_type == "cellular":
            start = dec.plans[0].start
            window = dec.panel_codes.numpy()[rng.integers(dec.barcode_count, size=code0.shape[0])]
            errors = rng.random(window.shape) < 0.01
            window[errors] = np.array(STRICT_CODES)[rng.integers(4, size=int(errors.sum()))]
            code0[:, start : start + 8] = window
    used = [batch["segments"][i] for i in reference.used_segments]
    widths = [-(-used[k][0].shape[1] // 4) * 4 for k in range(len(used))]
    rng = np.random.default_rng(41)
    qcfail = rng.random(2048) < 0.03
    code = np.concatenate([c.ravel() for c, _, _ in used])
    qual = np.concatenate([q.ravel() for _, q, _ in used])
    pairs = np.unique((code.astype(np.int64) & 15) << 8 | np.minimum(qual, 63))
    ccb, qcb, lut_idx, lut_exact = wire.sense_joint_codebook(pairs)
    blob = wire.pack_h2d_blob(widths, used, qcfail, qual_bits="j4", qual_lut=(lut_idx, lut_exact))
    jax_step = jax.jit(make_decode_step(reference, want_uncertain=True, want_counters=True, pack_outputs=True,
                                        h2d_widths=widths, qual_bits="j4"))
    packed, flat = jax_step({"blob": jnp.asarray(blob), "qcb": jnp.asarray(qcb), "ccb": jnp.asarray(ccb)})
    step = DecodeStep(ours, widths, "j4", want_uncertain=True)
    mine_blob, mine_counters = step(torch.from_numpy(blob), torch.from_numpy(ccb), torch.from_numpy(qcb))
    layout = wire.d2h_layout(ours, True)
    return (ours, layout, mine_blob.numpy().reshape(-1, layout["total"]),
            np.asarray(packed["blob"]).reshape(-1, layout["total"]), mine_counters.numpy(), np.asarray(flat))


def test_forty_decoders_blob_matches_jax(forty_case):
    """K5's plain version with 40 decoders (two mask words, five qcfail
    bytes) against the JAX pack: the uncertain byte exact, the indices,
    qcfail bits and confidences (rtol 1e-5) on settled rows; the kernel's
    plan: its uncertain byte's rows, past 32 decoders."""
    ours, layout, mine, theirs, _, _ = forty_case
    assert layout["qcfail_bytes"] == 5
    u = layout["uncertain_offset"]
    np.testing.assert_array_equal(mine[:, u], theirs[:, u])
    settled = ~(mine[:, u].astype(bool))
    assert settled.mean() > 0.5
    ints = slice(0, layout["int_bytes"])
    np.testing.assert_array_equal(mine[settled, ints], theirs[settled, ints])
    qc = slice(layout["qcfail_offset"], layout["qcfail_offset"] + layout["qcfail_bytes"])
    np.testing.assert_array_equal(mine[settled, qc], theirs[settled, qc])
    floats = slice(layout["float_offset"], layout["float_offset"] + layout["float_bytes"])
    np.testing.assert_allclose(np.ascontiguousarray(mine[settled, floats]).view(np.float32),
                               np.ascontiguousarray(theirs[settled, floats]).view(np.float32), rtol=1e-5, atol=0)
    plan = pack.pack_plan(ours, True)
    pamld_rows = [k for k, dec in enumerate(ours.decoders) if dec.algorithm == "pamld"]
    assert len(pamld_rows) == 19 and max(pamld_rows) >= 32
    assert plan.staged and plan.uncertain_mask == sum(1 << k for k in pamld_rows)
    assert [row for array, row in plan.sources if array == pack.UNCERTAIN] == pamld_rows


def test_forty_decoders_counters_match_jax(forty_case):
    """K4's plain version over 40 decoders against JAX's _counters:
    integer columns exact, confidence sums rtol 1e-5."""
    ours, _, _, _, mine, theirs = forty_case
    assert mine.shape == theirs.shape
    offset = checked = 0
    for _, name, size in wire.counter_layout(ours):
        a, b = mine[offset : offset + size], theirs[offset : offset + size]
        if name in ("accumulated_confidence", "accumulated_pf_confidence"):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
            checked += int(a.sum())
        offset += size
    assert checked > 0


def test_wide_flagship_layout():
    """The wide variant keeps the flagship's reads but segment 3, which
    holds the 96-nt cell barcode and the UMI; its synthetic batches draw
    segment 3 at 106 nt, the flagship's keep 26."""
    ontology = wide_flagship_ontology(cellular_barcodes=64)
    assert ontology["cellular"][0]["transform"]["token"] == ["3::96"]
    assert ontology["molecular"][0]["transform"]["token"] == ["3:96:106"]
    assert ontology["sample"] == flagship_ontology()["sample"]
    sample, cells = panel_codes(ontology)
    assert cells.shape == (64, 96) and sample.shape == (96, 16)
    batch = synthetic_batch(ontology, 100, seed=3)
    assert [c.shape[1] for c, _, _ in batch["segments"]] == [150, 8, 8, 106]
    assert [c.shape[1] for c, _, _ in synthetic_batch(flagship_ontology(), 10)["segments"]] == [150, 8, 8, 26]


def test_wide_flagship_hybrid_identical_to_strict(tmp_path):
    """The wide flagship (a 96-nt cellular panel: K1's looped instance on
    the card) through the port's device engine on the CPU and through the
    JAX package's engine on the same FASTQ: hybrid identical to strict in
    both, though the bound re-resolves most reads in f64 at this width."""
    from pheniqs_tpu_torch.benchmark import synthesize_fastq_input

    base = wide_flagship_ontology(cellular_barcodes=48)
    paths = synthesize_fastq_input(str(tmp_path / "in"), 1500, chunk=2048, ontology=base)
    config = {
        "input": paths,
        "template": {"transform": {"token": ["0::"]}},
        "sample": base["sample"],
        "cellular": base["cellular"],
        "molecular": base["molecular"],
        "report url": "/dev/null",
    }
    strict, _ = _run(tmp_path, config, "pheniqs_tpu.cli.main", "strict", 1, "strict")
    reference, _ = _run(tmp_path, config, "pheniqs_tpu.cli.main", "hybrid", 1, "reference")
    port, _ = _run(tmp_path, config, "pheniqs_tpu_torch", "hybrid", 2, "port")
    assert len(decisions(strict)) == 1500
    assert decisions(reference) == decisions(strict)
    assert decisions(port) == decisions(strict)
    assert json.loads(json.dumps(len(port))) > 0
