"""The reference's PAMLD decision on a hand-made three-barcode panel, both
ways of summing it, against the formula worked by hand."""

import math

import numpy as np
import pytest
import torch

from demux_bench.reference import pamld

A, C, G = 1, 2, 4
PANEL = np.array([[A] * 4, [C] * 4, [G] * 4], dtype=np.uint8)
READS = np.array([[A, A, A, C], [C, C, G, C], [G, A, C, G]], dtype=np.uint8)
QUALS = np.array([[30, 30, 30, 20], [37, 37, 12, 37], [2, 2, 2, 2]], dtype=np.uint8)


def match(q):
    q = int(q)
    return -10 * math.log10(1 - 10 ** (-q / 10))


def by_hand(read, qual, noise, rbp):
    sigma = [sum(match(q) if o == e else int(q) for o, e, q in zip(read, row, qual)) for row in PANEL]
    p = [10 ** (-s / 10) * (1 - noise) / 3 for s in sigma]
    best = int(np.argmax(p))
    return best + 1, p[best] / (sum(p) + noise * rbp), 10 ** (-sigma[best] / 10)


def decide(ordered, threshold=0.95, rbp=1e-9, dtype=torch.float64):
    return pamld.classify(PANEL, 0.95 / 3, 0.05, rbp, threshold, 30, 0, READS, QUALS,
                          np.zeros(3, dtype=bool), dtype=dtype, ordered=ordered)


@pytest.mark.parametrize("ordered", [True, False])
def test_decision_as_worked_by_hand(ordered):
    out = decide(ordered)
    for k in range(3):
        decoded, confidence, _ = by_hand(READS[k], QUALS[k], 0.05, 1e-9)
        assert out["decoded"][k] == decoded
        assert out["confidence"][k] == pytest.approx(confidence, rel=1e-12)
    # read 0 is A with one error at q20; read 1 C with one at q12; read 2 at
    # q2 ties A and C exactly: the first wins, below the threshold it fails QC
    assert list(out["decoded"]) == [1, 2, 1] and list(out["qcfail"]) == [False, False, True]
    assert out["gap"][2] == 0
    assert out["gap"][0] == pytest.approx(90 + match(20) - (3 * match(30) + 20))


def test_noise_filter_and_threshold():
    # likelihood 10^-2.0 of read 0's barcode is below a random barcode
    # probability of 0.5: unclassified, confidence 0, QC fail
    out = decide(True, rbp=0.5)
    assert out["decoded"][0] == 0 and out["confidence"][0] == 0 and out["qcfail"][0]
    out = decide(True, threshold=1 - 1e-11)
    assert out["decoded"][1] == 2 and out["qcfail"][1]


def test_lower_precision_reads_otherwise():
    exact = decide(True)["confidence"]
    low = decide(True, dtype=torch.bfloat16)["confidence"]
    assert np.abs(exact - low).max() > 1e-4


def test_unclassified_renders_as_the_program_renders_it():
    from demux_bench import check, traffic

    config = {"segments": [4, 8, 8, 26], "decoders": [
        {"role": "sample", "algorithm": "pamld", "barcodes": 3, "tokens": [[1, 0, 8], [2, 0, 8]],
         "noise": 0.05, "confidence_threshold": 0.95, "random_barcode_probability": 1e-9,
         "high_quality_threshold": 30, "high_quality_distance_threshold": 0},
        {"role": "cellular", "algorithm": "pamld", "barcodes": 3, "tokens": [[3, 0, 16]],
         "noise": 0.05, "confidence_threshold": 0.95, "random_barcode_probability": 1e-9,
         "high_quality_threshold": 30, "high_quality_distance_threshold": 0}]}
    inst = traffic.instrument(config, 1)
    sample, cellular = inst.decoders
    ref = {"qcfail": np.array([True, False])}
    ref[id(sample)] = {"decoded": np.array([0, 2]), "confidence": np.array([0.0, 0.5])}
    ref[id(cellular)] = {"decoded": np.array([0, 3]), "confidence": np.array([0.0, 1.0])}
    answers = check.reference_answers(inst, ref, np.array([0, 1]))
    # the sample's read group "undetermined"; CB the panel's row 0, "=" a position
    assert list(answers.rg) == [b"undetermined", sample.strings()[1]]
    assert list(answers.cb) == [b"=" * 16, cellular.strings()[2]]
    assert list(answers.xb) == [0.0, 0.5] and list(answers.xc) == [0.0, 0.0]


def random_panel(rng, b, w, n, error=0.1):
    codes = np.array([A, C, G, 8], dtype=np.uint8)
    panel = codes[rng.integers(4, size=(b, w))]
    truth = panel[rng.integers(b, size=n)]
    wrong = rng.random((n, w)) < error
    reads = np.where(wrong, codes[rng.integers(4, size=(n, w))], truth).astype(np.uint8)
    quals = np.array([2, 12, 23, 37], dtype=np.uint8)[rng.integers(4, size=(n, w))]
    return panel, reads, quals


@pytest.mark.parametrize("chunk", [1, 7, 64, pamld.CHUNK])
@pytest.mark.parametrize("b", [1, 2, 63, 64, 65, 200])
def test_two_smallest_by_chunks(chunk, b):
    # ties included: sigma drawn from few values
    rng = np.random.default_rng(b * 100 + chunk)
    sigma = torch.as_tensor(rng.integers(0, 6, size=(50, b)).astype(np.float64))
    low, at, second = pamld._two_smallest(sigma.clone(), chunk)
    assert torch.equal(low, sigma.min(dim=1).values)
    assert torch.equal(at, torch.argmax((sigma == low[:, None]).to(torch.int8), dim=1))  # the first
    rest = sigma.clone()
    rest[torch.arange(50), at] = math.inf
    assert torch.equal(second, rest.min(dim=1).values)


def frozen_gemm(panel, reads, quals, **kwargs):
    """The gemm path as it was: the whole of classify with its two block
    functions swapped for the frozen ones."""
    from demux_bench.tests import frozen

    saved = pamld._gemm_sigma, pamld._summed_posterior, pamld._onehot
    pamld._gemm_sigma, pamld._summed_posterior = frozen._gemm_sigma, frozen._summed_posterior
    pamld._onehot = lambda e, dtype: e
    try:
        return pamld.classify(panel, 0.95 / panel.shape[0], 0.05, 1e-9, 0.95, 30, 0, reads, quals,
                              np.zeros(reads.shape[0], dtype=bool), ordered=False, **kwargs)
    finally:
        pamld._gemm_sigma, pamld._summed_posterior, pamld._onehot = saved


@pytest.mark.parametrize("b, chunk", [(3, pamld.CHUNK), (500, 64), (5000, 1024), (20000, pamld.CHUNK)])
def test_gemm_blocks_as_before(b, chunk, monkeypatch):
    # the same decisions, confidences, gaps and best sigma as the gemm
    # path before its blocks were rebuilt, to 1e-9 relative (a gap at a
    # tie to 1e-12 absolute), over chunks whole and ragged
    rng = np.random.default_rng(b)
    panel, reads, quals = random_panel(rng, b, 16, 3000)
    before = frozen_gemm(panel, reads, quals)
    monkeypatch.setattr(pamld, "CHUNK", chunk)
    after = pamld.classify(panel, 0.95 / b, 0.05, 1e-9, 0.95, 30, 0, reads, quals, np.zeros(3000, dtype=bool),
                           ordered=False)
    settled = before["gap"] > 1e-9
    assert np.array_equal(after["decoded"][settled], before["decoded"][settled])
    assert np.array_equal(after["qcfail"][settled], before["qcfail"][settled])
    for key in ("confidence", "sigma_best"):
        assert np.allclose(after[key], before[key], rtol=1e-9, atol=0)
    assert np.allclose(after["gap"], before["gap"], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("b", [5, 96, 384])
def test_gemm_as_the_ordered_sum(b):
    # on small panels the gemm path decides as the exact ordered one
    # wherever the two best lie farther apart than rounding
    rng = np.random.default_rng(b + 1)
    panel, reads, quals = random_panel(rng, b, 12, 2000)
    args = (panel, 0.95 / b, 0.05, 1e-9, 0.95, 30, 0, reads, quals, np.zeros(2000, dtype=bool))
    exact, gemm = pamld.classify(*args, ordered=True), pamld.classify(*args, ordered=False)
    settled = exact["gap"] > 1e-9
    assert settled.mean() > 0.5
    assert np.array_equal(gemm["decoded"][settled], exact["decoded"][settled])
    assert np.allclose(gemm["confidence"], exact["confidence"], rtol=1e-9, atol=0)
    assert np.allclose(gemm["sigma_best"], exact["sigma_best"], rtol=1e-9, atol=0)
