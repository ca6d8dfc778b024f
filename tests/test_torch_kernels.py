"""The hand-written CUDA kernels against their plain torch versions, on
the card. These need an NVIDIA GPU and nvcc (a CUDA kernel has no CPU
mode), so they carry the ``cuda`` marker and skip where no GPU is
present; ``python3 chip_smoke.py`` runs the same checks at full size.

Tolerances: K3, K5 and K6 byte-exact, and so are apply_plans and
observation_features on the card (the same integer and f32 operations as
their plain versions); K1's uncertain flags equal to the plain version's
(chip_smoke.check_flags: no row may differ below 10^5 rows), its integer
outputs exact and confidences rtol 1e-5 on rows neither run flags
uncertain (the sigma sums are added in another order); K4 byte-identical across two launches
and to its plain version (integer and fixed-point sums)."""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_versions(cuda):
    import chip_smoke

    chip_smoke.kernel_checks(n=16384, timed=False)


@pytest.mark.cuda
def test_counters_kernel_matches_plain(cuda):
    """K4 byte-identical to its plain version and across two launches,
    under each instance, on every chip_smoke.K4_CASES case at its size and
    at 131,072 + 37 rows, on K4_OFFSET_CASES off alignment, over 737,281
    bins and on a batch it sums in row slices."""
    from chip_smoke import K4_CASES, K4_OFFSET_CASES, k4_edge_checks

    assert k4_edge_checks() == 2 * len(K4_CASES) - 1 + len(K4_OFFSET_CASES) + 4


@pytest.mark.cuda
def test_classify_functions_on_gpu_match_cpu(cuda):
    """classify.apply_plans (K3 on raw byte rows) and
    classify.observation_features (K1's feature prologue) on the card equal
    their plain versions bit for bit, on the general gather (negative
    starts and ends, reverse complement, two plans into one segment, a
    window past the segment end)."""
    from pheniqs_tpu_torch.device import classify
    from pheniqs_tpu_torch.device.flagship import flagship_ontology
    from pheniqs_tpu_torch.device.instrument import DeviceDecoder, TokenPlan, compile_instrument
    from pheniqs_tpu_torch.kernels import pamld, unpack

    rng = np.random.default_rng(41)
    n = 5000
    segments = [
        tuple(
            torch.from_numpy(x)
            for x in (
                rng.integers(0, 16, size=(n, w)).astype(np.int32),
                rng.integers(0, 42, size=(n, w)).astype(np.int32),
                rng.integers(0, w + 1, size=n).astype(np.int32),
            )
        )
        for w in (24, 13)
    ]
    plans = [
        TokenPlan(0, -8, 0, False, False, 0, 8),
        TokenPlan(0, 2, 10, True, True, 0, 8),
        TokenPlan(1, 0, -2, True, False, 1, 6),
        TokenPlan(1, 5, 12, True, False, 1, 7),
        TokenPlan(0, -6, -1, True, True, 2, 5),
        TokenPlan(1, 10, 20, True, False, 3, 10),
    ]
    dec = DeviceDecoder("pamld", "sample", 0, True, plans, [16, 13, 5, 10])
    before = unpack.launches
    on_card = classify.apply_plans(dec, [tuple(t.to(cuda) for t in s) for s in segments])
    assert unpack.launches == before + 1
    for mine, plain in zip(on_card, classify.apply_plans(dec, segments)):
        for a, b in zip(mine, plain):
            assert a.dtype == b.dtype == torch.int32
            assert torch.equal(a.cpu(), b)

    instrument = compile_instrument(flagship_ontology(), cuda)
    code = rng.choice(np.array([0, 1, 2, 4, 8, 15], np.uint8), size=(n, 16))
    qual = rng.integers(0, 64, size=(n, 16)).astype(np.uint8)
    before = pamld.feature_launches
    features = classify.observation_features(
        instrument, torch.from_numpy(code).to(cuda), torch.from_numpy(qual).to(cuda)
    )
    assert pamld.feature_launches == before + 1
    plain = pamld.observation_features_plain(torch.from_numpy(code), torch.from_numpy(qual))
    assert torch.equal(features.cpu().view(torch.int32), plain.view(torch.int32))


@pytest.mark.cuda
def test_decode_step_on_gpu_matches_cpu(cuda):
    from pheniqs_tpu_torch.device import wire
    from pheniqs_tpu_torch.device.flagship import flagship_ontology
    from pheniqs_tpu_torch.device.instrument import compile_instrument
    from pheniqs_tpu_torch.device.step import DecodeStep
    from chip_smoke import check_flags, flagship_blob

    ontology = flagship_ontology()
    steps = {}
    for device in ("cpu", "cuda"):
        instrument = compile_instrument(ontology, device)
        widths, blob, ccb, qcb = flagship_blob(ontology, instrument, 8192, seed=1)
        step = DecodeStep(instrument, widths, wire.JOINT4, want_uncertain=True)
        args = [torch.from_numpy(x).to(device) for x in (blob, ccb, qcb)]
        out, flat = step(*args)
        steps[device] = (out.cpu().numpy(), flat.cpu().numpy(), wire.d2h_layout(instrument, True))
    (a, ca, d2h), (b, cb, _) = steps["cpu"], steps["cuda"]
    a = a.reshape(-1, d2h["total"])
    b = b.reshape(-1, d2h["total"])
    u = d2h["uncertain_offset"]
    # flagship reads fill their tokens: the rules force exactly the padding
    # and forced wire rows; the uncertain bytes agree exactly at this size
    forced = torch.from_numpy((blob[:, -1] & (wire.H2D_PAD | wire.H2D_FORCED)) != 0)
    check_flags("decode step", torch.from_numpy(b[:, u] != 0), torch.from_numpy(a[:, u] != 0), forced)
    settled = (a[:, u] == 0) & (b[:, u] == 0)
    exact = list(range(d2h["int_bytes"])) + [d2h["qcfail_offset"]]
    np.testing.assert_array_equal(a[settled][:, exact], b[settled][:, exact])


@pytest.mark.cuda
@pytest.mark.parametrize("tolerance,qmt,short", [(1, 0, False), (2, 20, True)])
def test_mdd_kernel_matches_plain(cuda, tolerance, qmt, short):
    """K6 byte-exact against its plain version on the MDD flagship's sample
    decoder (j4 tokens from K3), at the reference's tolerance 1 with no
    quality masking and at tolerance 2 with masking and reads cut short."""
    from chip_smoke import flagship_blob
    from pheniqs_tpu_torch.device import wire
    from pheniqs_tpu_torch.device.flagship import mdd_flagship_ontology
    from pheniqs_tpu_torch.device.instrument import compile_instrument
    from pheniqs_tpu_torch.device.step import DecodeStep
    from pheniqs_tpu_torch.kernels import mdd, unpack

    ontology = mdd_flagship_ontology()
    ontology["sample"]["distance tolerance"] = [tolerance, tolerance]
    ontology["sample"]["quality masking threshold"] = qmt
    instrument = compile_instrument(ontology, cuda)
    widths, blob, ccb, qcb = flagship_blob(ontology, instrument, 20000, seed=3, short=0.1 if short else 0.0)
    step = DecodeStep(instrument, widths, wire.JOINT4, want_uncertain=True)
    args = [torch.from_numpy(x).to(cuda) for x in (blob, ccb, qcb)]
    tokens = unpack.unpack_tokens(instrument, step.layout, step.program, *args)
    codes, quals, lengths, _ = tokens.observation(step.layout, 0)
    dec = instrument.decoders[0]
    before = mdd.launches
    mine = mdd.mdd_classify(dec, codes, quals, lengths, tokens.qcfail)
    assert mdd.launches == before + 1
    plain = mdd.mdd_classify_plain(dec, codes, quals, lengths, tokens.qcfail)
    for key in ("decoded", "argmax", "distance", "branch", "confidence", "qcfail"):
        assert torch.equal(mine[key], plain[key]), key
    assert (plain["distance"] > 0).any() and (plain["decoded"] == 0).any()


@pytest.mark.cuda
def test_unpack_kernel_edge_cases(cuda):
    """K3 byte-exact and identical across two launches at N = 0, 1, R - 1,
    R + 1 and 16384 + 7 reads on the 6-bit and j4 wires with the general
    gather, on aligned blobs and on views 3 bytes off alignment, under the
    block plan and the column plan; programs of ~3,000 ints (both plans)
    and ~10,000 ints (the column plan); and 2048 length columns (the
    column plan)."""
    from chip_smoke import unpack_edge_checks

    assert unpack_edge_checks() == 42


@pytest.mark.cuda
def test_pack_kernel_edge_cases(cuda):
    """K5 byte-exact against its plain version, identical across two
    launches and writing nothing past its span, at N = 0, 1, 15, 17, 255,
    257 and 131071 reads on rows of 10 to 261 bytes: int16 and int32
    indices, with and without the uncertain byte, a naive decoder between
    two PAMLD ones, 9, 32, 33 and 64 decoders."""
    from chip_smoke import PACK_LAYOUTS, PACK_READS, pack_edge_checks

    assert pack_edge_checks() == len(PACK_LAYOUTS) * len(PACK_READS) == 70


@pytest.mark.cuda
def test_mdd_kernel_edge_cases(cuda):
    """K6 byte-exact and identical across two launches on a panel with a
    duplicated barcode (the lowest index wins), on 5-, 24- and 64-position
    observations (its three instances), on a 2000-barcode panel (the key
    table in L2), on 9 and 12 segments of 40-130 positions (the wide
    instance) and on unaligned rows, at tolerance 1 and at tolerance 2
    with quality masking and short reads, and on a wide panel holding codes
    of 16 and more (8 bit planes)."""
    from chip_smoke import mdd_edge_checks

    assert mdd_edge_checks(16384) == 18


@pytest.mark.cuda
def test_unpack_column_plan_matches_plain(cuda):
    """K3's column plan byte-exact against its plain version and across two
    launches at 16384 + 7 reads: programs of ~3,000 and ~10,000 ints, 2048
    length columns, and the general gather on every wire forced onto it,
    each aligned and 3 bytes off."""
    from chip_smoke import forced_plan, gather_blob, hold_unpack, unaligned, wide_unpack_cases
    from pheniqs_tpu_torch.kernels import unpack

    cases = [(case, columns) for case, columns in wide_unpack_cases(16384 + 7) if columns]
    cases += [(gather_blob(16384 + 7, mode), True) for mode in (6, 2, 4, "j4")]
    for (instrument, layout, program, blob, ccb, qcb), _ in cases:
        plan = forced_plan(layout, blob.shape[1], True)
        assert isinstance(plan, unpack.ColumnPlan)
        before = unpack.launches
        for rows in (blob, unaligned(blob, 3)):
            hold_unpack(f"column plan, {program.numel()} ints", instrument, layout, program, rows, ccb, qcb)
        assert unpack.launches == before + 4


@pytest.mark.cuda
def test_mdd_wide_instance_matches_plain(cuda):
    """K6's wide instance byte-exact against its plain version at every
    WIDE_MDD shape (9 and 12 segments of 50-130 positions) at tolerance 2
    with quality masking and 20 % short segments, on the wide MDD
    instrument's sample decoder, and on a panel of 8 bit planes."""
    from chip_smoke import WIDE_MDD, mdd_eight_planes, mdd_synthetic
    from pheniqs_tpu_torch.device.flagship import wide_mdd_ontology
    from pheniqs_tpu_torch.device.instrument import compile_instrument
    from pheniqs_tpu_torch.kernels import mdd

    n = 16384 + 7
    cases = [mdd_synthetic(widths, barcodes, n, 2, 5, 0.2, seed=barcodes, error_rate=0.5 / sum(widths))
             for widths, barcodes in WIDE_MDD]
    cases.append(mdd_eight_planes(n))
    # the wide MDD instrument: reads drawn from its panel, 1.5 substitutions a read
    dec = compile_instrument(wide_mdd_ontology(), cuda).decoders[0]
    rng = np.random.default_rng(12)
    panel = dec.panel_codes_u8.cpu().numpy()
    codes = panel[rng.integers(dec.barcode_count, size=n)]
    errors = rng.random(codes.shape) < 1.5 / codes.shape[1]
    codes[errors] = rng.choice(np.array([1, 2, 4, 8, 15], np.uint8), size=int(errors.sum()))
    quals = rng.integers(2, 41, size=codes.shape).astype(np.uint8)
    lengths = np.tile(np.array(dec.segment_widths, np.int32), (n, 1))
    cases.append((dec, *(torch.from_numpy(x).to(cuda) for x in (codes, quals, lengths)),
                  torch.from_numpy(rng.random(n) < 0.05).to(cuda)))
    for dec, codes, quals, lengths, qcfail in cases:
        assert sum(dec.segment_widths) > 64
        before = mdd.launches
        mine = mdd.mdd_classify(dec, codes, quals, lengths, qcfail)
        assert mdd.launches == before + 1
        plain = mdd.mdd_classify_plain(dec, codes, quals, lengths, qcfail)
        for key in ("decoded", "argmax", "distance", "branch", "confidence", "qcfail"):
            assert torch.equal(mine[key], plain[key]), key
        assert (plain["decoded"] > 0).any() and (plain["distance"] > 0).any()


def _pamld_case(rng, barcodes: int, width: int, n: int):
    """A one-segment PAMLD sample decoder over `barcodes` distinct random
    words and `n` reads drawn from it with 8 % substitutions
    (test_device_classify's helpers import JAX, which the GPU tests must
    not need)."""
    from pheniqs_tpu_torch.device.flagship import _codec, _unique_words

    words = _unique_words(rng, barcodes, width)
    sample = {
        "algorithm": "pamld", "index": 1, "codec": _codec(words, [width], 0.05), "noise": 0.05,
        "confidence threshold": 0.95, "random barcode probability": 4.0 ** -width,
        "high quality threshold": 30, "high quality distance threshold": 0,
        "transform": {"token": [f"0:0:{width}"]},
    }
    letters = np.frombuffer("".join(words).encode(), np.uint8).reshape(barcodes, width)
    bam = np.zeros(256, np.uint8)
    bam[[ord("A"), ord("C"), ord("G"), ord("T")]] = [1, 2, 4, 8]
    code = bam[letters[rng.integers(barcodes, size=n)]]
    error = rng.random(code.shape) < 0.08
    code = np.where(error, np.array([1, 2, 4, 8], np.uint8)[rng.integers(4, size=code.shape)], code)
    qual = np.where(error, rng.integers(2, 25, size=code.shape), rng.integers(8, 41, size=code.shape))
    return sample, code.astype(np.uint8), qual.astype(np.uint8)


def _confidence_f64(dec, sigma):
    """The best barcode's posterior in float64 from sigma (N, B)."""
    from pheniqs_tpu_torch.device.instrument import LN_PHRED_BASE

    sigma = sigma.to(torch.float64)
    shift = sigma.min(dim=1).values
    p = torch.exp(LN_PHRED_BASE * (sigma - shift[:, None])) * dec.concentration.to(torch.float64)[None, :]
    noise = dec.noise * dec.random_barcode_probability
    return p.max(dim=1).values / (p.sum(dim=1) + noise * torch.exp(-LN_PHRED_BASE * shift))


@pytest.mark.cuda
@pytest.mark.parametrize("barcodes,width", [(1500, 12), (4096, 16), (3000, 10)])
def test_chunked_kernel_matches_plain(cuda, barcodes, width):
    """K7 against its plain version (the online chunked posterior, sigma
    as the contraction F.G): the uncertain flags disagree on at most 1e-3
    of the rows (the sums are added in another order, and the plain version
    rescales once per chunk), integer outputs exact and confidences rtol
    1e-5 on rows neither flags but for at most 1e-3 of the rows, each of
    those within rtol 1e-5 of the f64 posterior of the kernel's own sigmas
    (sigma_tile_order); there the confidences also agree rtol 1e-5 with the
    tile loop's own arithmetic (pamld_classify_tile_order)."""
    from pheniqs_tpu_torch.device.instrument import compile_instrument
    from pheniqs_tpu_torch.kernels import pamld

    rng = np.random.default_rng(barcodes)
    sample, code, qual = _pamld_case(rng, barcodes, width, 4000)
    instrument = compile_instrument({"sample": sample, "input segment cardinality": 1}, cuda)
    dec = instrument.decoders[0]
    noise = rng.random(4000) < 0.1
    code[noise] = np.array([1, 2, 4, 8], np.uint8)[rng.integers(4, size=(int(noise.sum()), width))]
    code_t = torch.from_numpy(code).to(cuda)
    qual_t = torch.from_numpy(qual).to(cuda)
    qcfail = torch.from_numpy(rng.random(4000) < 0.05).to(cuda)
    before = pamld.chunked_launches
    kwargs = dict(want_uncertain=True, eps=instrument.tpq_analytic_eps)
    mine = pamld.pamld_classify(dec, code_t, qual_t, qcfail, tpq_constants=instrument.tpq_constants, **kwargs)
    slices = pamld.plan_for(4000, barcodes, width, cuda).slices
    assert pamld.chunked_launches == before + (1 if slices == 1 else 3)
    plain = pamld.pamld_classify_plain(dec, code_t, qual_t, qcfail, **kwargs)
    assert int((mine["uncertain"] != plain["uncertain"]).sum()) <= 4
    settled = ~(mine["uncertain"] | plain["uncertain"])
    for key in ("decoded", "argmax", "distance", "branch", "qcfail"):
        assert torch.equal(mine[key][settled], plain[key][settled]), key
    # the kernel adds sigma's terms in another order than the contraction
    # (M + C: two sums of about the read's quality sum that cancel), which
    # can move a low confidence by ~1e-5 of itself: at most 1e-3 of the
    # rows lie beyond rtol 1e-5 of the plain version, each within rtol 1e-5
    # of the f64 posterior of the kernel's own sigmas
    a, b = mine["confidence"][settled], plain["confidence"][settled]
    beyond = ~torch.isclose(a, b, rtol=1e-5, atol=0)
    assert int(beyond.sum()) <= 4
    own = _confidence_f64(dec, pamld.sigma_tile_order(code_t, qual_t, dec.panel_codes_u8))[settled]
    assert torch.allclose(a[beyond].double(), own[beyond], rtol=1e-5, atol=0)
    twin = pamld.pamld_classify_tile_order(dec, code_t, qual_t, qcfail, **kwargs)
    assert torch.allclose(mine["confidence"][settled], twin["confidence"][settled], rtol=1e-5, atol=0)
    assert (plain["decoded"] == 0).any() and (plain["decoded"] > 0).float().mean() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [131072, 20000])
@pytest.mark.parametrize("barcodes", [96, 384, 1000])
def test_pamld_kernel_slices_below_a_tile(cuda, barcodes, n):
    """K1 on a panel of one tile: a call counts its plan's launches, 1
    where one launch fills the card (as a batch of 131072 reads does at 4
    blocks/SM) and 3 where the plan cuts the panel below the tile (20,000
    reads always: stages A, B and C); two calls byte-identical; and the sliced launches held to the
    one-launch instance on the same batch (pamld.against_one_launch:
    argmax, decoded and distance bit-equal, confidences within
    2*gamma(B+2) + 8u, the rest apart only at the confidence threshold)."""
    from pheniqs_tpu_torch.device.instrument import compile_instrument
    from pheniqs_tpu_torch.kernels import pamld

    rng = np.random.default_rng(barcodes)
    sample, code, qual = _pamld_case(rng, barcodes, 16, n)
    instrument = compile_instrument({"sample": sample, "input segment cardinality": 1}, cuda)
    dec = instrument.decoders[0]
    noise = rng.random(n) < 0.1
    code[noise] = np.array([1, 2, 4, 8], np.uint8)[rng.integers(4, size=(int(noise.sum()), 16))]
    code_t, qual_t = (torch.from_numpy(x).to(cuda) for x in (code, qual))
    qcfail = torch.from_numpy(rng.random(n) < 0.05).to(cuda)
    short = torch.zeros(n, dtype=torch.bool, device=cuda)
    kwargs = dict(tpq_constants=instrument.tpq_constants, want_uncertain=True, eps=instrument.tpq_analytic_eps,
                  short=short)
    slices = pamld.plan_for(n, barcodes, 16, cuda).slices
    assert slices > 1 or n == 131072
    before = pamld.launches
    first = pamld.pamld_classify(dec, code_t, qual_t, qcfail, **kwargs)
    assert pamld.launches == before + (1 if slices == 1 else 3)
    second = pamld.pamld_classify(dec, code_t, qual_t, qcfail, **kwargs)
    for key in first:
        assert torch.equal(first[key], second[key]), key
    held = pamld.against_one_launch(dec, code_t, qual_t, qcfail, short, instrument.tpq_constants,
                                    instrument.tpq_analytic_eps)
    assert held["plan"].slices > 1
    assert held["unequal"] == {"argmax": 0, "decoded": 0, "distance": 0}
    assert held["relative"] <= held["tolerance"]
    assert held["unexplained"] == 0


@pytest.mark.cuda
def test_chunked_kernel_is_deterministic(cuda):
    """K7 over a panel of several slices, and K8 over two shards of it,
    launched twice: every output byte-identical (no atomics; the slices
    merge in slice order), and K8's argmax K7's on every row."""
    from pheniqs_tpu_torch.device import tp
    from pheniqs_tpu_torch.device.instrument import compile_instrument
    from pheniqs_tpu_torch.kernels import pamld

    rng = np.random.default_rng(7)
    sample, code, qual = _pamld_case(rng, 9000, 16, 20000)
    instrument = compile_instrument({"sample": sample, "input segment cardinality": 1}, cuda)
    dec = instrument.decoders[0]
    assert pamld.plan_for(20000, dec.barcode_count, 16, cuda).slices > 1
    args = [torch.from_numpy(x).to(cuda) for x in (code, qual, rng.random(20000) < 0.05)]
    kwargs = dict(tpq_constants=instrument.tpq_constants, want_uncertain=True, eps=instrument.tpq_analytic_eps)
    first, second = (pamld.pamld_classify(dec, *args, **kwargs) for _ in range(2))
    shards = [tp.shard_panel(dec, rank, 2) for rank in range(2)]
    k8 = [pamld.pamld_classify_sharded(dec, shards, *args, **kwargs) for _ in range(2)]
    for key in first:
        assert torch.equal(first[key], second[key]), key
        assert torch.equal(k8[0][key], k8[1][key]), key
    assert torch.equal(k8[0]["argmax"], first["argmax"])


@pytest.mark.cuda
def test_profile_step_ladder_on_the_card(cuda):
    """tools/profile_step.py's ladder on the flagship at N = 16384: every
    rung runs and reports device time and launches, and the full rung's
    blob and counters are the same bytes as DecodeStep.forward on the same
    buffer (a step built apart, as the engine builds it)."""
    from pheniqs_tpu_torch.device.instrument import compile_instrument
    from pheniqs_tpu_torch.device.step import DecodeStep
    from pheniqs_tpu_torch.tools import profile_step

    rows = list(profile_step.profile("flagship", 16384, (), iters=5, device=cuda))
    assert [row["variant"] for row in rows] == list(profile_step.RUNGS)
    assert all(row["device_ms"] > 0 and row["launches"] > 0 for row in rows)

    ontology = profile_step.INSTRUMENTS["flagship"]()
    instrument = compile_instrument(ontology, cuda)
    wire = [torch.from_numpy(x).to(cuda) for x in profile_step.wire_blob(ontology, instrument, 16384, seed=3)]
    blob, flat = profile_step.rungs(profile_step.make_step(instrument))["full"](*wire)
    want_blob, want_flat = DecodeStep(instrument, profile_step.WIDTHS, "j4", want_uncertain=True)(*wire)
    assert torch.equal(blob, want_blob) and torch.equal(flat, want_flat)


@pytest.mark.cuda
def test_sharded_step_two_slices_on_one_card(cuda):
    """ShardedDecodeStep with two slices on one card (two streams) against
    the one-card DecodeStep at 16384 flagship reads and MDD-flagship reads
    (chip_smoke.sharded_vs_one_card: the blob byte for byte under the same
    K1 plans, else held by pamld.against_one_launch's rule; integer
    counters exact; each slice's kernel launches the one-card step's plus
    two per decoder a slice runs sliced)."""
    from chip_smoke import sharded_vs_one_card
    from pheniqs_tpu_torch.device.flagship import flagship_ontology, mdd_flagship_ontology

    for ontology in (flagship_ontology(), mdd_flagship_ontology()):
        report = sharded_vs_one_card("two slices", ontology, 16384, ["cuda:0", "cuda:0"], seed=5)
        assert report["slice_reads"] == 8192 and len(report["slice_kernel_launches"]) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("width", [65, 128, 160, 300])
def test_pamld_wide_instances_match_plain(cuda, width):
    """K1's looped instance (every width past 64, its blocked loop) at 65,
    128, 160 and 300 positions on 16384 reads of the wide flagship's
    96-barcode cellular panel:
    two launches identical, decisions bit-equal to the tile-order twin, the
    plain version's apart only on near ties in f64
    (chip_smoke.wide_pamld_entry)."""
    from chip_smoke import pamld_observations, wide_pamld_entry
    from pheniqs_tpu_torch.device.flagship import wide_flagship_ontology

    instrument, observations = pamld_observations(wide_flagship_ontology(96, width), 16384, seed=width)
    dec, codes, quals, qcfail, short = observations[1]
    entry = wide_pamld_entry(dec, instrument, codes, quals, qcfail, short)
    assert entry["instance"] == 0 and entry["launches"] == (1 if entry["slices"] == 1 else 3) + 1


@pytest.mark.cuda
def test_wide_kernels_match_plain(cuda):
    """Every extended kernel as chip_smoke's wide phase holds it, at 16384
    reads: K1 at 65-300 positions, K7 and K8 at 96, K6 past 8 segments and
    64 positions, K3's programs past 2048 ints staged and in place and its
    lengths written in place, K4 and
    K5 at 33 and 64 decoders and K5's rows in place."""
    from chip_smoke import WIDE_DECODERS, WIDE_MDD, wide_checks

    entries = wide_checks(16384)
    assert len(entries["pamld_chunked"]) == len(entries["pamld_panel_sharded"]) == 1
    assert len(entries["mdd_classify"]) == 2 and len(entries["counters"]) == len(WIDE_DECODERS)
    assert len(WIDE_MDD) == 4 and len(entries["unpack_tokens"]) == 5
