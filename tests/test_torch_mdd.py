"""The port's MDD decoder (K6's plain version, CPU) and the MDD flagship
path against the JAX reference and the float64 oracle.

Tolerances: none. MDD is integer arithmetic on both sides, so decoded
index, distance and qcfail are byte-identical to the JAX device function
and to the oracle, and the decode step's decision blob and counters are
byte-identical to ``make_decode_step``'s; hybrid decisions equal the
strict engine's exactly (SAM records minus the f32 confidence tags)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pheniqs_tpu.decode.oracle import mdd_classify
from pheniqs_tpu.decode.spec import spec_from_ontology
from pheniqs_tpu.device import compile_instrument as jax_compile
from pheniqs_tpu.device.classify import mdd_classify_device as jax_mdd
from pheniqs_tpu.device.step import make_decode_step
from pheniqs_tpu.transform import SegmentBatch
from pheniqs_tpu_torch.device import classify, wire
from pheniqs_tpu_torch.device.flagship import mdd_flagship_ontology, synthetic_batch
from pheniqs_tpu_torch.device.instrument import carry_instrument, compile_instrument
from pheniqs_tpu_torch.device.step import DecodeStep
from pheniqs_tpu_torch.kernels import mdd as mdd_kernel
from test_device_classify import make_mdd_ontology, random_panel, simulate_reads
from test_hybrid import decisions
from test_torch_engine import _env

WIDTHS = [8, 8, 28]


def _observation(code, qual, lengths, half):
    return [
        (code[:, :half], qual[:, :half], lengths[:, 0]),
        (code[:, half:], qual[:, half:], lengths[:, 1]),
    ]


@pytest.mark.parametrize("qmt,short", [(0, False), (12, False), (0, True), (12, True)])
def test_mdd_device_matches_jax_and_oracle(qmt, short):
    """Tolerance 2 over two segments (test_device_classify.py::
    test_mdd_device_matches_oracle), with and without quality masking,
    on full-length observations and on observations cut short."""
    rng = np.random.default_rng(11 + qmt + short)
    panel = random_panel(rng, 16, 10)
    ontology = make_mdd_ontology(panel, tolerance=2, segments=2, qmt=qmt)
    spec = spec_from_ontology(ontology, "sample")
    code, qual, _ = simulate_reads(rng, panel, 512, error_rate=0.12)
    n = code.shape[0]
    half = 5
    lengths = np.full((n, 2), half, dtype=np.int32)
    if short:
        cut = rng.random((n, 2)) < 0.2
        lengths[cut] = rng.integers(0, half, size=int(cut.sum()))
        for s in range(2):
            beyond = np.arange(half)[None, :] >= lengths[:, s : s + 1]
            code[:, s * half : (s + 1) * half][beyond] = 0
            qual[:, s * half : (s + 1) * half][beyond] = 0
    qcfail = rng.random(n) < 0.05
    obs = _observation(code.astype(np.int32), qual.astype(np.int32), lengths, half)
    oracle = mdd_classify(
        spec, [SegmentBatch(code=c.astype(np.uint8), quality=q.astype(np.uint8), length=l) for c, q, l in obs],
        qcfail,
    )
    reference = jax_compile({"sample": ontology, "input segment cardinality": 1})
    theirs = jax_mdd(
        reference.decoders[0], [tuple(jnp.asarray(x) for x in o) for o in obs], jnp.asarray(qcfail)
    )
    ours = compile_instrument({"sample": ontology, "input segment cardinality": 1}, "cpu")
    mine = classify.mdd_classify_device(
        ours.decoders[0], [tuple(torch.from_numpy(x) for x in o) for o in obs], torch.from_numpy(qcfail)
    )
    for key in ("decoded", "distance", "qcfail", "branch", "argmax", "confidence"):
        assert mine[key].numpy().dtype == np.asarray(theirs[key]).dtype, key
        np.testing.assert_array_equal(mine[key].numpy(), np.asarray(theirs[key]), err_msg=key)
    np.testing.assert_array_equal(mine["decoded"].numpy(), oracle.decoded)
    np.testing.assert_array_equal(mine["distance"].numpy(), oracle.edit_distance)
    np.testing.assert_array_equal(mine["qcfail"].numpy(), oracle.qcfail)
    # the cases are not trivial: exact matches, scans within tolerance and misses
    decoded = mine["decoded"].numpy()
    assert (decoded == 0).any() and (mine["distance"].numpy() > 0).any() and (decoded > 0).mean() > 0.5


def _two_phase_case(rng, words, segments, tolerance, qmt, n, short=False, error_rate=0.12, n_rate=0.0):
    """Reads drawn from `words` (an MDD panel of `segments` equal
    segments), some cut short (their positions past the length zeroed, as
    K3 leaves them) and some with N (code 15): K6's two-phase twin, its
    plain version and JAX's mdd_classify_device on the same tokens."""
    ontology = make_mdd_ontology(words, tolerance=tolerance, segments=segments, qmt=qmt)
    code, qual, _ = simulate_reads(rng, words, n, error_rate=error_rate)
    code[rng.random(code.shape) < n_rate] = 15
    ws = code.shape[1] // segments
    lengths = np.full((n, segments), ws, dtype=np.int32)
    if short:
        cut = rng.random((n, segments)) < 0.2
        lengths[cut] = rng.integers(0, ws, size=int(cut.sum()))
        for s in range(segments):
            beyond = np.arange(ws)[None, :] >= lengths[:, s : s + 1]
            code[:, s * ws : (s + 1) * ws][beyond] = 0
            qual[:, s * ws : (s + 1) * ws][beyond] = 0
    qcfail = rng.random(n) < 0.05
    obs = [
        (code[:, s * ws : (s + 1) * ws].astype(np.int32), qual[:, s * ws : (s + 1) * ws].astype(np.int32),
         lengths[:, s])
        for s in range(segments)
    ]
    reference = jax_compile({"sample": ontology, "input segment cardinality": 1})
    theirs = jax_mdd(
        reference.decoders[0], [tuple(jnp.asarray(x) for x in o) for o in obs], jnp.asarray(qcfail)
    )
    dec = compile_instrument({"sample": ontology, "input segment cardinality": 1}, "cpu").decoders[0]
    args = (dec, torch.from_numpy(code), torch.from_numpy(qual), torch.from_numpy(lengths), torch.from_numpy(qcfail))
    twin = mdd_kernel.mdd_classify_two_phase(*args)
    plain = mdd_kernel.mdd_classify_plain(*args)
    for key in ("decoded", "distance", "qcfail", "branch", "argmax", "confidence"):
        assert twin[key].dtype == plain[key].dtype, key
        np.testing.assert_array_equal(twin[key].numpy(), plain[key].numpy(), err_msg=key)
        np.testing.assert_array_equal(twin[key].numpy(), np.asarray(theirs[key]), err_msg=key)
    return twin, code, lengths


@pytest.mark.parametrize("tolerance", [1, 2])
@pytest.mark.parametrize("qmt,short", [(0, False), (12, False), (0, True), (12, True)])
def test_mdd_two_phase_matches_plain_and_jax(tolerance, qmt, short):
    """K6's algorithm (the key table's lookup for reads at full length,
    then the first barcode within tolerance from the packed words) equals
    the plain version and JAX's mdd_classify_device byte for byte, with
    and without quality masking, on full and short observations."""
    rng = np.random.default_rng(40 + 4 * tolerance + qmt + short)
    twin, _, _ = _two_phase_case(rng, random_panel(rng, 16, 10), 2, tolerance, qmt, 512, short=short)
    decoded = twin["decoded"].numpy()
    exact = twin["exact"].numpy()
    # exact matches by lookup, scans within tolerance and misses
    assert exact.any() and (~exact & (decoded > 0)).any() and (decoded == 0).any()


@pytest.mark.parametrize("width,segments", [(5, 1), (16, 2), (24, 2), (64, 2)])
def test_mdd_two_phase_widths(width, segments):
    """Observations of 5, 16, 24 and 64 positions (2, 4, 6 and 16 words; the
    kernel's 4-, 8- and 16-word instances), reads with N (code 15), some
    cut short, at tolerance 1 with quality masking."""
    rng = np.random.default_rng(width)
    twin, _, _ = _two_phase_case(rng, random_panel(rng, 40, width), segments, 1, 15, 400, short=True,
                                 error_rate=0.03, n_rate=0.01)
    assert mdd_kernel.key_words(width) == (4 if width <= 16 else 8 if width <= 32 else 16)
    assert twin["exact"].any() and (twin["decoded"] == 0).any()


def test_mdd_two_phase_duplicated_barcode():
    """A panel holding one barcode three times: a read equal to it, or
    within tolerance of it, decodes to its lowest index."""
    rng = np.random.default_rng(77)
    words = random_panel(rng, 12, 10)
    words[6] = words[9] = words[2]
    twin, code, _ = _two_phase_case(rng, words, 2, 1, 0, 600, error_rate=0.05)
    from pheniqs_tpu_torch.iupac import encode_ascii

    copies = (code == encode_ascii(words[2])).all(axis=1)
    assert copies.any()
    assert (twin["decoded"].numpy()[copies] == 3).all()
    assert not np.isin(twin["decoded"].numpy(), [7, 10]).any()


def test_mdd_two_phase_exact_beats_earlier_within():
    """A read one mismatch from barcode 1 (within tolerance) and equal to
    barcode 4 decodes to 4 at distance 0: the exact match wins over an
    earlier barcode within tolerance; cut short by one position it is no
    longer exact and barcode 1 (first within tolerance) wins."""
    from pheniqs_tpu_torch.iupac import encode_ascii

    rng = np.random.default_rng(5)
    words = random_panel(rng, 8, 10)
    other = {"A": "C", "C": "G", "G": "T", "T": "A"}
    words[3] = words[0][:-1] + other[words[0][-1]]
    if words[3] in words[:3] + words[4:]:
        pytest.skip("the drawn panel already holds the variant")
    ontology = make_mdd_ontology(words, tolerance=1, segments=2)
    dec = compile_instrument({"sample": ontology, "input segment cardinality": 1}, "cpu").decoders[0]
    code = np.stack([encode_ascii(words[3])] * 2)
    qual = np.full_like(code, 30)
    lengths = np.array([[5, 5], [5, 4]], dtype=np.int32)
    code[1, 9] = 0
    args = [torch.from_numpy(x) for x in (code, qual, lengths)] + [torch.zeros(2, dtype=torch.bool)]
    twin = mdd_kernel.mdd_classify_two_phase(dec, *args)
    plain = mdd_kernel.mdd_classify_plain(dec, *args)
    for key in ("decoded", "distance", "qcfail"):
        np.testing.assert_array_equal(twin[key].numpy(), plain[key].numpy(), err_msg=key)
    assert twin["decoded"].tolist() == [4, 1] and twin["distance"].tolist() == [0, 0]
    assert twin["exact"].tolist() == [True, False]


def test_mdd_key_table():
    """The key table: sorted by (words, word 0 first, then index); every
    barcode of a panel without duplicates found at its own index, a
    duplicated barcode at its first index, a key outside the panel not
    found; the codec-order words pack position 4k + j into byte j of word
    k."""
    rng = np.random.default_rng(3)
    for width in (5, 16, 24, 64):
        nw = mdd_kernel.key_words(width)
        codes = np.array([1, 2, 4, 8], np.uint8)[rng.integers(4, size=(50, width))]
        codes[30] = codes[7]
        codes[44] = codes[7]
        table = mdd_kernel.key_table(codes)
        assert table.dtype == np.int32 and table.size == 2 * 50 * nw + 52
        words, keys, index = mdd_kernel.table_parts(torch.from_numpy(table), 50, nw)
        expect = np.zeros((50, nw), dtype=np.int64)
        for k in range(nw):
            for j in range(4):
                if 4 * k + j < width:
                    expect[:, k] |= codes[:, 4 * k + j].astype(np.int64) << (8 * j)
        np.testing.assert_array_equal(words.numpy(), expect)
        order = sorted(range(50), key=lambda b: (tuple(expect[b]), b))
        np.testing.assert_array_equal(index.numpy(), order)
        np.testing.assert_array_equal(keys.numpy(), expect[order])
        found = mdd_kernel.lookup(keys, index, words)
        # each barcode's first copy (30 and 44 copy 7; at 5 nt the draw may
        # repeat others)
        wanted = np.array([next(a for a in range(50) if (codes[a] == codes[b]).all()) for b in range(50)])
        assert wanted[30] == wanted[44] == 7
        np.testing.assert_array_equal(found.numpy(), wanted)
        outside = words[:3].clone()
        outside[:, 0] ^= 15  # no panel code has a 15 byte
        assert (mdd_kernel.lookup(keys, index, outside) == -1).all()
        below = torch.zeros((1, nw), dtype=torch.int64)
        above = torch.full((1, nw), 0xFFFFFFFF, dtype=torch.int64)
        assert int(mdd_kernel.lookup(keys, index, below)[0]) == -1
        assert int(mdd_kernel.lookup(keys, index, above)[0]) == -1


def test_mdd_key_table_on_every_instrument():
    """compile_instrument and carry_instrument both give an MDD decoder its
    key table (and no other decoder one)."""
    ontology = mdd_flagship_ontology()
    for instrument in (compile_instrument(ontology, "cpu"), carry_instrument(jax_compile(ontology), "cpu")):
        dec = instrument.decoders[0]
        assert dec.algorithm == "mdd"
        np.testing.assert_array_equal(dec.key_table.numpy(), mdd_kernel.key_table(dec.panel_codes_u8.numpy()))
        assert all(d.key_table is None for d in instrument.decoders[1:])


def test_mdd_flagship_ontology_compiles_with_tolerance_one():
    """Each 8 nt index set keeps a pairwise distance of at least 3, so the
    config compiler's Shannon bound admits tolerance [1, 1]."""
    from pheniqs_tpu_torch.config.compiler import minimum_distance

    ontology = mdd_flagship_ontology()
    sample = ontology["sample"]
    assert sample["algorithm"] == "mdd" and sample["distance tolerance"] == [1, 1]
    for s in range(2):
        words = {record["barcode"][s] for record in sample["codec"].values()}
        assert len(words) == 96
        assert minimum_distance(words, 8) >= 3
    spec = spec_from_ontology(sample, "sample")
    assert spec.panel.codes.shape == (96, 16)
    assert tuple(spec.distance_tolerance) == (1, 1)


@pytest.fixture(scope="module", params=["j4", 6])
def mdd_step_case(request):
    mode = request.param
    ontology = mdd_flagship_ontology()
    reference = jax_compile(ontology)
    ours = carry_instrument(reference, "cpu")
    batch = synthetic_batch(
        ontology, 4096, seed=31, error_rate=0.06,
        quality_binning="rta3" if mode == "j4" else None,
    )
    rng = np.random.default_rng(32)
    used = [batch["segments"][i] for i in reference.used_segments]
    for _, _, length in used:
        length[rng.random(4096) < 0.02] = rng.integers(0, 8)
    qcfail = rng.random(4096) < 0.03
    ccb = qcb = lut = None
    if mode == "j4":
        code = np.concatenate([c.ravel() for c, _, _ in used])
        qual = np.concatenate([q.ravel() for _, q, _ in used])
        pairs = np.unique((code.astype(np.int64) & 15) << 8 | np.minimum(qual, 63))
        ccb, qcb, lut_idx, lut_exact = wire.sense_joint_codebook(pairs)
        lut = (lut_idx, lut_exact)
    blob = wire.pack_h2d_blob(WIDTHS, used, qcfail, qual_bits=mode, qual_lut=lut)
    blob[-16:] = 0
    blob[-16:, -1] = wire.H2D_PAD | wire.H2D_QCFAIL
    jax_step = jax.jit(
        make_decode_step(
            reference, want_uncertain=True, want_counters=True,
            pack_outputs=True, h2d_widths=WIDTHS, qual_bits=mode,
        )
    )
    inputs = {"blob": jnp.asarray(blob)}
    if qcb is not None:
        inputs["qcb"] = jnp.asarray(qcb)
        inputs["ccb"] = jnp.asarray(ccb)
    packed, flat = jax_step(inputs)
    step = DecodeStep(ours, WIDTHS, mode, want_uncertain=True)
    mine_blob, mine_counters = step(
        torch.from_numpy(blob),
        None if ccb is None else torch.from_numpy(ccb),
        None if qcb is None else torch.from_numpy(qcb),
    )
    layout = wire.d2h_layout(ours, True)
    return (
        ours, layout,
        mine_blob.numpy().reshape(-1, layout["total"]),
        np.asarray(packed["blob"]).reshape(-1, layout["total"]),
        mine_counters.numpy(), np.asarray(flat),
    )


def test_mdd_step_decision_blob_matches(mdd_step_case):
    """MDD decided rows are byte-identical everywhere (never uncertain);
    the cellular PAMLD bytes as in test_torch_step.py."""
    ours, layout, mine, theirs, _, _ = mdd_step_case
    # int16 indices of both decoders, the cellular f32 confidence, the
    # qcfail bits, the uncertain byte
    assert mine.shape == theirs.shape == (4096, 10)
    assert ours.decoders[0].algorithm == "mdd"
    mdd_index = slice(0, 2)  # the sample decoder's int16 decoded index
    np.testing.assert_array_equal(mine[:, mdd_index], theirs[:, mdd_index])
    u = layout["uncertain_offset"]
    np.testing.assert_array_equal(mine[:, u], theirs[:, u])
    settled = mine[:, u] == 0
    np.testing.assert_array_equal(mine[settled, : layout["int_bytes"]], theirs[settled, : layout["int_bytes"]])
    qc = slice(layout["qcfail_offset"], layout["qcfail_offset"] + layout["qcfail_bytes"])
    np.testing.assert_array_equal(mine[settled, qc], theirs[settled, qc])
    # bit 0 (the MDD decoder's own qcfail) is exact on every row
    np.testing.assert_array_equal(mine[:, qc][:, 0] & 1, theirs[:, qc][:, 0] & 1)
    decoded = np.ascontiguousarray(mine[:, mdd_index]).view(np.int16)[:, 0]
    assert (decoded > 0).mean() > 0.8 and (decoded == 0).any()


def test_mdd_step_counters_match(mdd_step_case):
    """MDD's counter kind (count, pf count, distances) exact, like every
    integer column; confidence sums rtol 1e-5 (sum order)."""
    ours, _, _, _, mine, theirs = mdd_step_case
    assert mine.shape == theirs.shape
    offset = 0
    for position, name, size in wire.counter_layout(ours):
        a, b = mine[offset : offset + size], theirs[offset : offset + size]
        if name in ("accumulated_confidence", "accumulated_pf_confidence"):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
        if position == 0 and name == "accumulated_distance":
            assert a.sum() > 0
        offset += size


VARIANT = r"""
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import json, os
from pheniqs_tpu_torch.benchmark import run_e2e, synthesize_fastq_input
from pheniqs_tpu_torch.device import flagship
base, variant = sys.argv[1], sys.argv[2]
ontology = (flagship.mdd_flagship_ontology() if variant == "mdd"
            else flagship.whitelist_flagship_ontology(3000))
paths = synthesize_fastq_input(os.path.join(base, "in"), 4000, chunk=4096, ontology=ontology)
stats = {}
for fidelity, threads in (("strict", 1), ("hybrid", 2), ("fast", 2)):
    stats[fidelity] = run_e2e(paths, os.path.join(base, fidelity + ".sam"), fidelity=fidelity,
                              threads=threads, batch_size=2048, device="cpu", ontology=ontology)
assert not any(name == "jax" or name.startswith("jax.") for name, mod in sys.modules.items() if mod is not None)
print(json.dumps(stats))
"""


@pytest.mark.parametrize("variant", ["mdd", "whitelist"])
def test_port_variant_hybrid_identical_to_strict_without_jax(tmp_path, variant):
    """The MDD flagship (K6 path) and a 3000-barcode whitelist flagship
    (K7 path, above LARGE_PANEL_B) through run_e2e with jax unimportable:
    hybrid decisions equal the strict engine's; fast runs to the end."""
    result = subprocess.run(
        [sys.executable, "-c", VARIANT, str(tmp_path), variant],
        env=_env(), capture_output=True, text=True, timeout=600,
    )
    assert result.returncode == 0, result.stderr[-3000:]
    stats = json.loads(result.stdout.strip().splitlines()[-1])
    strict = decisions((tmp_path / "strict.sam").read_text())
    assert len(strict) == 4000
    assert decisions((tmp_path / "hybrid.sam").read_text()) == strict
    assert stats["hybrid"]["classified_fraction"] > 0.8
    assert stats["fast"]["reads"] == 4000
    assert len(decisions((tmp_path / "fast.sam").read_text())) == 4000


@pytest.mark.parametrize("fidelity", ["fast", "hybrid"])
def test_port_matches_strict_on_bdggg(reference_root, bdggg, fidelity):
    """test_fast_engine.py::test_fast_matches_strict_on_bdggg on the port
    (BDGGG's sample decoder is MDD): the same decisions as the reference's
    strict engine on the reference's own fixture, float tags within f32
    tolerance (fast) or equal decisions (hybrid). Needs the reference
    repository mounted, as the original does."""
    from test_fast_engine import run_mux, split_tags

    config = os.path.join(bdggg, "BDGGG_annotated.json")
    strict = run_mux(reference_root, config, "strict").stdout.split("\n")
    result = subprocess.run(
        [sys.executable, "-m", "pheniqs_tpu_torch", "mux", "--config", config,
         "--precision", "15", "--fidelity", fidelity],
        cwd=reference_root, env=_env(), capture_output=True, text=True, timeout=600,
    )
    assert result.returncode == 0, result.stderr[-4000:]
    port = result.stdout.split("\n")
    assert len(strict) == len(port)
    for s_line, p_line in zip(strict, port):
        if s_line.startswith("@"):
            assert p_line.startswith("@")
            continue
        s_fixed, s_floats = split_tags(s_line)
        p_fixed, p_floats = split_tags(p_line)
        assert s_fixed == p_fixed, (s_line, p_line)
        assert set(s_floats) == set(p_floats)
        for tag, value in s_floats.items():
            assert abs(value - p_floats[tag]) <= 5e-4 * abs(value) + 5e-6, (tag, value, p_floats[tag])


@pytest.mark.parametrize("variant", ["mdd", "whitelist"])
def test_port_cli_runs_variant(tmp_path, variant):
    """`python -m pheniqs_tpu_torch mux` runs both new paths at
    `--fidelity fast` and `hybrid` (PHENIQS_TORCH_DEVICE=cpu): hybrid
    decisions equal the reference CLI's strict ones."""
    from pheniqs_tpu_torch.benchmark import synthesize_fastq_input
    from pheniqs_tpu_torch.device import flagship
    from test_torch_engine import _run

    base = (flagship.mdd_flagship_ontology() if variant == "mdd"
            else flagship.whitelist_flagship_ontology(2000))
    paths = synthesize_fastq_input(str(tmp_path / "in"), 3000, chunk=4096, ontology=base)
    config = {
        "input": paths,
        "template": {"transform": {"token": ["0::"]}},
        "sample": base["sample"],
        "cellular": base["cellular"],
        "molecular": base["molecular"],
        "report url": "/dev/null",
    }
    strict, _ = _run(tmp_path, config, "pheniqs_tpu.cli.main", "strict", 1, "strict")
    fast, _ = _run(tmp_path, config, "pheniqs_tpu_torch", "fast", 2, "fast")
    hybrid, _ = _run(tmp_path, config, "pheniqs_tpu_torch", "hybrid", 2, "hybrid")
    assert len(decisions(strict)) == len(decisions(fast)) == 3000
    assert decisions(hybrid) == decisions(strict)
