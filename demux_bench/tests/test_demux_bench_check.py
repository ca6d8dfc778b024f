"""The check's answers and counts: with one cellular decoder every answer
and every count is what it was before the counts became arrays and XC a
product (tests/frozen.py); with two, CB joins their barcodes and XC is one
less the product of their confidences, 0 where either is unclassified, as
the program tags a read; the traffic varies the first decoder of the
role its mix names, and no other."""

import numpy as np
import pytest

from demux_bench import check, traffic
from demux_bench.tests import frozen
from demux_bench.tests.shapes import small


@pytest.fixture(scope="module")
def tenx():
    cell = small("tenx-v2-fast")
    inst = traffic.instrument(cell.config, 31, cell.traffic)
    batches = traffic.pool(inst, cell.traffic, 31)
    return cell, inst, batches, check.reference(inst, batches)


def test_one_cellular_answers_as_before(tenx):
    cell, inst, batches, ref = tenx
    rows = np.arange(1024)
    for variant in (None, inst.variant(np.arange(1024) % 7 + 40)):
        got, want = check.reference_answers(inst, ref, rows, variant), frozen.reference_answers(inst, ref, rows, variant)
        for field in ("rg", "cb", "ox", "qcfail", "xb", "xc"):
            assert np.array_equal(getattr(got, field), getattr(want, field)), field


def test_one_cellular_counts_as_before(tenx):
    cell, inst, batches, ref = tenx
    sent = check.sends(inst, len(batches), 173)
    dicts = frozen.reference_counts(inst, ref, sent, 512)
    arrays = check.reference_counts(inst, ref, sent, 512)
    for position, (decoder, (count, pf)) in enumerate(zip(inst.pamld(), arrays)):
        keys = [b""] + decoder.strings().tolist()
        assert [dicts[(position, key)] for key in keys] == list(zip(count.tolist(), pf.tolist()))


def test_two_cellular_tags():
    cell = small("sci-rna-seq-small")
    inst = traffic.instrument(cell.config, 1, cell.traffic)
    umi, rt, pcr = inst.decoders
    ref = {"qcfail": np.array([False, True, True, False])}
    ref[id(umi)] = {"raw": np.frombuffer(b"ACGTACGT" * 4, dtype=np.uint8).reshape(4, 8)}
    ref[id(rt)] = {"decoded": np.array([3, 0, 5, 2]), "confidence": np.array([0.999, 0.0, 0.99, 0.9999])}
    ref[id(pcr)] = {"decoded": np.array([7, 4, 0, 1]), "confidence": np.array([0.998, 0.97, 0.0, 1.0])}
    answers = check.reference_answers(inst, ref, np.arange(4))
    assert list(answers.cb) == [rt.strings()[2] + pcr.strings()[6], b"=" * 10 + pcr.strings()[3],
                                rt.strings()[4] + b"=" * 20, rt.strings()[1] + pcr.strings()[0]]
    printed = [float("%g" % np.float32(1 - 0.999 * 0.998)), 0.0, 0.0, float("%g" % np.float32(1 - 0.9999))]
    assert list(answers.xc) == printed
    assert list(answers.rg) == [b"undetermined"] * 4 and list(answers.ox) == [b"ACGTACGT"] * 4


def test_traffic_varies_the_first_of_its_role():
    cell = small("sci-rna-seq-small")
    inst = traffic.instrument(cell.config, 1, cell.traffic)
    assert [d.variants is not None for d in inst.decoders] == [False, True, False]
    assert inst.varied() is inst.decoders[1]
    # the second cellular decoder's decisions are the same in every replay
    decoded = np.arange(193)
    assert np.array_equal(inst.decoders[2].remap(np.full(193, 17), decoded), decoded)
    cell.traffic["vary"]["role"] = "sample"
    with pytest.raises(ValueError, match="no sample decoder"):
        traffic.instrument(cell.config, 1, cell.traffic)
