"""The report's counts as the scan reads them are what json.load and the
count by dicts (tests/frozen.py) read: on a real report from a CPU run of
the program, and on reports written by json with zero counts, missing
keys, several cellular decoders, barcodes off the panel or listed twice,
in another order, without white space; whether one process scans or
several. The counts compared as arrays sum to what the dicts summed."""

import copy
import json
import os

import numpy as np
import pytest

from demux_bench import check, report, run, traffic
from demux_bench.tests import frozen
from demux_bench.tests.shapes import small


def same(a, b):
    assert a.incoming == b.incoming and len(a.decoders) == len(b.decoders)
    for x, y in zip(a.decoders, b.decoders):
        assert x.unclassified == y.unclassified
        assert np.array_equal(x.barcodes, y.barcodes)
        assert np.array_equal(x.count, y.count) and np.array_equal(x.pf, y.pf)


def expected_dict(inst, expected):
    out = {}
    for position, (decoder, (count, pf)) in enumerate(zip([d for d in check.chain(inst) if d.algorithm == "pamld"],
                                                          expected)):
        keys = [b""] + decoder.strings().tolist()
        out.update(zip(((position, key) for key in keys), zip(count.tolist(), pf.tolist())))
    return out


def agree(path, inst, expected, sent, allowance=0):
    """Every way of reading `path` gives the same counts, and the arrays'
    apart the dicts'."""
    with open(path) as stream:
        document = json.load(stream)
    whole = report.from_document(document, check.counted(inst))
    for workers in (1, 3):
        same(report.read(path, check.counted(inst), workers=workers), whole)
    before = frozen.report_apart(frozen.report_counts(inst, document), expected_dict(inst, expected),
                                 int(document.get("incoming", {}).get("count", 0)), sent, allowance)
    assert check.report_apart(inst, whole, expected, sent, allowance) == before
    return before


def entry(decoder, row, count, pf):
    word = decoder.strings()[row].decode()
    cuts = np.cumsum([0] + [end - start for _, start, end in decoder.tokens])
    out = {"barcode": [word[cuts[k]:cuts[k + 1]] for k in range(len(cuts) - 1)],
           "concentration": decoder.concentration(), "count": count, "index": row + 1, "pf count": pf,
           "pf fraction": pf / count if count else 0.0, "pf pooled fraction": 0.001, "pooled fraction": 0.001}
    if count:
        out.update({"average confidence": 0.9993, "average distance": 0.25, "estimated concentration": 0.001})
    if count > pf:
        out["low confidence count"] = count - pf
    if decoder.role == "sample":
        out.update(BC="-".join(out["barcode"]), ID=word, PU=word)
    return out


def document(inst, counts, reads):
    """A report of the program's shape over `counts`, (count, pf) arrays
    a PAMLD decoder (row 0 the unclassified)."""
    doc = {"incoming": {"count": reads, "pf count": reads, "pf fraction": 1.0}}
    pamld = iter(counts)
    for decoder in check.chain(inst):
        body = {"count": reads, "index": inst.decoders.index(decoder) + 1, "pf count": reads,
                "unclassified": {"count": 0, "index": 0, "pf count": 0, "pooled fraction": 0.0}}
        if decoder.algorithm == "pamld":
            count, pf = next(pamld)
            body["unclassified"].update({"count": int(count[0]), "pf count": int(pf[0])})
            body["classified"] = [entry(decoder, b, int(count[b + 1]), int(pf[b + 1]))
                                  for b in range(decoder.barcodes)]
        if decoder.role == "sample":
            doc["sample"] = body
        else:
            doc.setdefault(decoder.role, []).append(body)
    return doc


def counts_for(inst, seed):
    rng = np.random.default_rng(seed)
    out = []
    for decoder in (d for d in check.chain(inst) if d.algorithm == "pamld"):
        count = rng.integers(0, 50, size=decoder.barcodes + 1) * (rng.random(decoder.barcodes + 1) < 0.7)
        out.append((count, count - rng.integers(0, 2, size=count.shape) * (count > 0)))
    return out


def off_panel(doc, decoders):
    decoders[-1]["classified"][3]["barcode"] = ["A" * len("".join(decoders[-1]["classified"][3]["barcode"]))]


def twice(doc, decoders):
    decoders[-1]["classified"].insert(7, dict(decoders[-1]["classified"][2], count=999, **{"pf count": 990}))


EDITS = {
    "as written": lambda doc, decoders: None,
    "zero counts": lambda doc, decoders: [e.update({"count": 0, "pf count": 0}) for d in decoders
                                          for e in d.get("classified", [])],
    "no count": lambda doc, decoders: decoders[-1]["classified"][5].pop("count"),
    "no pf count": lambda doc, decoders: decoders[0]["classified"][1].pop("pf count"),
    "no unclassified": lambda doc, decoders: decoders[0].pop("unclassified"),
    "no classified": lambda doc, decoders: decoders[-1].pop("classified"),
    "no incoming": lambda doc, decoders: doc.pop("incoming"),
    "empty classified": lambda doc, decoders: decoders[0].update(classified=[]),
    "off the panel": off_panel,
    "listed twice": twice,
    "reversed": lambda doc, decoders: decoders[-1]["classified"].reverse(),
}


def decoders_of(doc):
    return ([doc["sample"]] if "sample" in doc else []) + doc.get("cellular", [])


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("edit", sorted(EDITS))
@pytest.mark.parametrize("workload", ["tenx-v2-fast", "sci-rna-seq-small"])
def test_edge_cases_read_as_json_reads_them(tmp_path, workload, edit, compact):
    cell = small(workload)
    inst = traffic.instrument(cell.config, 3, cell.traffic)
    counts = counts_for(inst, 4)
    doc = document(inst, counts, 5000)
    EDITS[edit](doc, decoders_of(doc))
    path = tmp_path / "report.json"
    path.write_text(json.dumps(doc, sort_keys=True, **({"separators": (",", ":")} if compact else {"indent": 4})))
    expected = counts_for(inst, 5)
    agree(str(path), inst, expected, 5000, allowance=3)
    # the program's shape (sorted keys, every key there) is scanned, not parsed whole
    scanned = report._scan_file(str(path), os.path.getsize(path), 1) is not None
    assert scanned == (edit not in ("no count", "no pf count"))


def test_unchanged_counts_are_not_apart(tmp_path):
    cell = small("sci-rna-seq-small")
    inst = traffic.instrument(cell.config, 3, cell.traffic)
    counts = counts_for(inst, 4)
    path = tmp_path / "report.json"
    path.write_text(json.dumps(document(inst, counts, 5000), indent=4, sort_keys=True))
    assert agree(str(path), inst, counts, 5000) == 0
    moved = copy.deepcopy(counts)
    moved[1][0][9] += 2  # the second cellular decoder's barcode 9 counted twice more
    assert agree(str(path), inst, moved, 5000) == 2


@pytest.fixture(scope="module")
def real_report(tmp_path_factory):
    """A CPU run of the whitelist's cell cut to a test's size, its report kept."""
    kept = tmp_path_factory.mktemp("real") / "report.json"
    rmtree = run.shutil.rmtree

    def keep(path, **kwargs):
        if os.path.exists(os.path.join(path, "report.json")):
            os.replace(os.path.join(path, "report.json"), kept)
        rmtree(path, **kwargs)

    cell = small("tenx-v2-fast")
    run.shutil.rmtree = keep
    try:
        outcome, numbers, _ = run.run_cell(cell, 20261019, 1.0, traced=False, device="cpu")
    finally:
        run.shutil.rmtree = rmtree
    return cell, outcome, numbers, str(kept)


def test_real_report_read_as_json_reads_it(real_report):
    cell, outcome, numbers, path = real_report
    inst = outcome.instrument
    assert report._scan_file(path, os.path.getsize(path), 1) is not None
    batches = traffic.pool(inst, cell.traffic, 20261019)
    ref = check.reference(inst, batches)
    n = cell.traffic["batch_size"]
    expected = check.reference_counts(inst, ref, check.sends(inst, len(batches), outcome.sent_batches), n)
    assert agree(path, inst, expected, outcome.sent_batches * n) == numbers["report_apart"] == 0
    with open(path) as stream:
        document = json.load(stream)
    dicts = frozen.report_counts(inst, document)
    read = report.read(path, check.counted(inst), workers=2)
    assert sum(d.count.size + 1 for d in read.decoders) == len(dicts)
    for position, counts in enumerate(read.decoders):
        assert dicts[(position, b"")] == counts.unclassified
        for key, c, p in zip(counts.barcodes.tolist(), counts.count.tolist(), counts.pf.tolist()):
            assert dicts[(position, key)] == (c, p)
