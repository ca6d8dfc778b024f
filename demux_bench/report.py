"""The counts the check reads from the program's JSON report, without
building its object tree: for each PAMLD decoder, the unclassified
entry's count and pass-filter count, and each classified entry's
barcode (its token strings joined), count and pass-filter count, as
arrays in the report's order; and the reads in.

A whitelist's report holds one object a barcode (about 470 bytes each,
3.2 GB at 6.8 M barcodes), so json.load would build a hundred million
objects. Here worker processes each scan a share of the file's bytes
for the classified entries, one regular expression an entry of the
shape the program writes (keys sorted, each once); the parent checks
that the entries they found tile every ``classified`` array whole, from
its ``[`` to its ``]``, and parses the rest of the report, with each such
array cut out, by json. A report in which any entry or array does not
take that shape is read by json.load whole, so what is read is what
json.load would give either way. The workers are spawned processes, so
a script that calls ``read`` on a large report runs it under its
``__main__`` check (``python -m demux_bench`` does).
"""

from __future__ import annotations

import json
import os
import re
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from multiprocessing import get_context

import numpy as np

_SCALAR = rb'[^,{}"\[\]]*+'
#: one classified entry as the program writes it, its keys in sorted
#: order, each once: read-group fields (a sample barcode's), averages,
#: the barcode's token strings, then count and pf count among the others;
#: the group after the entry says whether another follows (",") or the
#: array ends. Quantifiers are possessive: no white space is matched twice
ENTRY = re.compile(
    rb'\{(?:\s*+"[A-Z][A-Z0-9]"\s*+:\s*+"[^"\\]*+"\s*+,)*+'
    rb'(?:\s*+"average [a-z ]++"\s*+:\s*+' + _SCALAR + rb',)*+'
    rb'\s*+"barcode"\s*+:\s*+\[(\s*+"[A-Za-z]*+"(?:\s*+,\s*+"[A-Za-z]*+")*+\s*+)\]\s*+,'
    rb'\s*+"concentration"\s*+:\s*+' + _SCALAR + rb','
    rb'\s*+"count"\s*+:\s*+(\d++)\s*+,'
    rb'(?:\s*+"estimated concentration"\s*+:\s*+' + _SCALAR + rb',)?+'
    rb'\s*+"index"\s*+:\s*+\d++\s*+,'
    rb'(?:\s*+"low conditional confidence count"\s*+:\s*+\d++\s*+,)?+'
    rb'(?:\s*+"low confidence count"\s*+:\s*+\d++\s*+,)?+'
    rb'\s*+"pf count"\s*+:\s*+(\d++)'
    rb'(?:\s*+,\s*+"p(?!f count")[a-z ]++"\s*+:\s*+' + _SCALAR + rb')*+'
    rb'\s*+\}\s*+(?:(,)\s*+|\])'
)
ARRAY = re.compile(rb'"classified"\s*:\s*\[\s*')
#: bytes a worker reads past its share, so that an entry begun in it ends
PAD = 1 << 20
#: below this many bytes one process scans the whole report
ALONE = 64 << 20
WORKERS = 8


@dataclass
class Counts:
    """One decoder's counts as the report gives them."""

    unclassified: tuple[int, int]
    barcodes: np.ndarray  # (k,) bytes, each entry's token strings joined
    count: np.ndarray  # (k,) int64
    pf: np.ndarray  # (k,) int64


@dataclass
class Report:
    incoming: int
    decoders: list  # a Counts per PAMLD decoder, in the order asked for


def read(path: str, wanted: list[tuple[str, int]], workers: int | None = None) -> Report:
    """The report at `path`, its decoders (role, position among the
    role's decoders: ``cellular`` 1 is the second cellular decoder) in
    the order `wanted` gives."""
    size = os.path.getsize(path)
    workers = workers or (1 if size < ALONE else min(WORKERS, os.cpu_count() or 1))
    found = _scan_file(path, size, workers)
    if found is not None:
        skeleton, entries = found
        try:
            return from_document(json.loads(skeleton), wanted, entries)
        except (ValueError, TypeError, KeyError, IndexError):
            pass
    with open(path, "rb") as stream:
        return from_document(json.load(stream), wanted)


def from_document(document: dict, wanted: list[tuple[str, int]], entries: list | None = None) -> Report:
    """The counts of a parsed report; with `entries`, of its skeleton,
    where each classified array the scan found is replaced by its number
    in `entries`."""
    decoders = []
    for role, position in wanted:
        if role == "sample":
            entry = document.get("sample", {})
        else:
            listed = document.get(role, [])
            entry = listed[position] if position < len(listed) else {}
        unclassified = entry.get("unclassified", {})
        classified = entry.get("classified", [])
        if entries is not None and classified:
            if not (len(classified) == 1 and type(classified[0]) is int):
                raise ValueError("a classified array the scan did not take")
            barcodes, count, pf = entries[classified[0]]
        else:
            barcodes = np.array(["".join(e["barcode"]).encode() for e in classified], dtype=bytes)
            count = np.array([int(e.get("count", 0)) for e in classified], dtype=np.int64)
            pf = np.array([int(e.get("pf count", 0)) for e in classified], dtype=np.int64)
        decoders.append(Counts((int(unclassified.get("count", 0)), int(unclassified.get("pf count", 0))),
                               barcodes, count, pf))
    return Report(int(document.get("incoming", {}).get("count", 0)), decoders)


def _scan_file(path: str, size: int, workers: int):
    """(the report with each classified array's entries cut out, the
    entries of each array), or None where the entries found do not tile
    every array whole."""
    shares = [(size * k // workers, size * (k + 1) // workers) for k in range(workers)]
    if workers == 1:
        parts = [scan(path, *shares[0])]
    else:
        with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as pool:
            parts = list(pool.map(scan, [path] * workers, *zip(*shares)))
    arrays, starts, ends, more, count, pf, barcodes = (np.concatenate(column) for column in zip(*parts))
    if not arrays.size:
        return None
    pieces, entries, at = [], [], 0
    first = np.searchsorted(starts, arrays)
    with open(path, "rb") as stream:
        def take(lo, hi):
            stream.seek(lo)
            return stream.read(hi - lo)

        for k, (opened, i) in enumerate(zip(arrays.tolist(), first.tolist())):
            if take(opened, opened + 1) == b"]":  # an empty array
                entries.append((barcodes[:0], count[:0], pf[:0]))
                continue
            if i >= starts.size or starts[i] != opened:
                return None
            # the array's entries: each ends where the next begins, the
            # last with the array's "]"
            closing = np.flatnonzero(~more[i:])
            if not closing.size:
                return None
            last = i + int(closing[0])
            if not np.array_equal(ends[i:last], starts[i + 1:last + 1]):
                return None
            pieces += [take(at, opened), str(k).encode()]
            at = int(ends[last]) - 1
            entries.append((barcodes[i:last + 1], count[i:last + 1], pf[i:last + 1]))
        pieces.append(take(at, size))
    return b"".join(pieces), entries


def scan(path: str, lo: int, hi: int):
    """In the bytes lo..hi of the report: where each classified array's
    first entry may begin (after its ``[``), and each classified entry
    that begins there: its start and end (past the comma and space that
    follow it, or past the array's ``]``), whether another follows, its
    count, pf count and barcode."""
    with open(path, "rb") as stream:
        stream.seek(lo)
        region = stream.read(hi - lo + PAD)
    share = hi - lo
    arrays = [lo + m.end() for m in ARRAY.finditer(region, 0, share + PAD) if m.start() < share]
    starts, ends, more, count, pf, barcodes = [], [], [], [], [], []
    for m in ENTRY.finditer(region):
        if m.start() >= share:
            break
        listed, c, p, comma = m.groups()
        starts.append(lo + m.start())
        ends.append(lo + m.end())
        more.append(comma is not None)
        count.append(int(c))
        pf.append(int(p))
        barcodes.append(listed.translate(None, b' \t\r\n",'))
    return (np.array(arrays, dtype=np.int64), np.array(starts, dtype=np.int64), np.array(ends, dtype=np.int64),
            np.array(more, dtype=bool), np.array(count, dtype=np.int64), np.array(pf, dtype=np.int64),
            np.array(barcodes, dtype=bytes))
