"""How ``correct`` is decided: the answers of the program's timed path held
to the reference's for the same reads.

The answers are each record's decisions as the SAM tags render them
(RG: the sample barcode or ``undetermined``; CB: the cellular barcodes
joined, ``=`` a position of one unclassified; OX: the UMI as read; the
QC-fail flag) and the decoders' confidences (XB, XC: 1 - confidence as a
float32 printed with ``%g``, absent at 0 or 1; XC's confidence the
product of the cellular decoders'), and the report's counts a barcode.
Numbers compared, each against its limit in the cell's traffic file:

- ``missing``: records of the captured range that never came or came
  out of order, and records sent but never written;
- ``decisions_apart``: compared records whose RG, CB, OX or QC flag
  differ from the reference's;
- ``confidence_gap``: the widest gap between a compared record's XB or
  XC and the reference's;
- ``report_apart``: the report's counts (each barcode's count and pass
  filter count, and the reads in) apart from the reference's over every
  read sent, less what reads set aside may move;
- ``shm_left``: /dev/shm files the program left behind.

A cell whose configuration states float32 decisions (``--fidelity
fast``) sets aside reads within ``sigma_tolerance`` (phred units) of a
tie between its two best barcodes or of the random barcode threshold,
or within ``confidence_tolerance`` of the confidence threshold, where
float32 may rightly decide otherwise; one that states float64 decisions
sets both to 0 and compares every read.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .reference import pamld
from .report import Counts, Report
from .traffic import CODE_TO_ASCII, Batch, Instrument, parse_name

QCFAIL = 0x200
ORDER = {"sample": 0, "molecular": 1, "cellular": 2}


@dataclass
class Answers:
    """Per compared read: decisions and confidences as the tags give them."""

    rg: np.ndarray
    cb: np.ndarray
    ox: np.ndarray
    qcfail: np.ndarray
    xb: np.ndarray
    xc: np.ndarray


def chain(inst: Instrument):
    """The decoders in the program's order: sample, molecular, cellular."""
    return sorted(inst.decoders, key=lambda d: ORDER[d.role])


def reference(inst: Instrument, batches: list[Batch], dtype=torch.float64, device="cpu") -> dict:
    """Every decoder's decisions for every pool read, in the chain's order
    (each decoder's QC fail state passed to the next)."""
    order = chain(inst)
    positions = {id(d): i for i, d in enumerate(inst.decoders)}
    n = sum(b.observations[0][0].shape[0] for b in batches)
    qcfail = np.zeros(n, dtype=bool)
    out = {}
    for decoder in order:
        code = np.concatenate([b.observations[positions[id(decoder)]][0] for b in batches])
        qual = np.concatenate([b.observations[positions[id(decoder)]][1] for b in batches])
        if decoder.algorithm != "pamld":
            out[id(decoder)] = {"raw": CODE_TO_ASCII[code], "qcfail": qcfail.copy()}
            continue
        spec = decoder.spec
        result = pamld.classify(
            decoder.codes, decoder.concentration(), spec["noise"],
            spec["random_barcode_probability"], spec["confidence_threshold"],
            spec["high_quality_threshold"], spec["high_quality_distance_threshold"],
            code, qual, qcfail, dtype=dtype, device=device,
        )
        qcfail = result["qcfail"]
        out[id(decoder)] = result
    out["qcfail"] = qcfail
    return out


def settled(inst: Instrument, ref: dict, check: dict) -> np.ndarray:
    """Reads whose every PAMLD decision lies farther from a tie or a
    threshold than the cell's tolerances."""
    sigma_tol = check["sigma_tolerance"]
    conf_tol = check["confidence_tolerance"]
    keep = np.ones(ref["qcfail"].shape[0], dtype=bool)
    for decoder in inst.pamld():
        r = ref[id(decoder)]
        noise_sigma = -10.0 * math.log10(decoder.spec["random_barcode_probability"])
        keep &= r["gap"] >= sigma_tol
        keep &= np.abs(r["sigma_best"] - noise_sigma) >= sigma_tol
        keep &= np.abs(r["confidence"] - decoder.spec["confidence_threshold"]) >= conf_tol
    return keep


def _printed(confidence: np.ndarray) -> np.ndarray:
    """1 - confidence as the tag prints it (float32, %g), 0 where absent."""
    value = (1.0 - confidence).astype(np.float32)
    shown = (confidence > 0) & (confidence < 1)
    return np.array([float("%g" % v) if s else 0.0 for v, s in zip(value.tolist(), shown)])


def reference_answers(inst: Instrument, ref: dict, rows: np.ndarray,
                      variant: np.ndarray | None = None) -> Answers:
    """What the reference's decisions render as, for pool reads `rows`
    written through the traffic's maps `variant` (none: as drawn). CB
    joins the cellular decoders' barcodes in order; XC is one less the
    product of their confidences, 0 where any is unclassified (the
    program's combined cellular confidence)."""
    rg = np.full(rows.shape[0], b"undetermined", dtype=object)
    cb = np.full(rows.shape[0], b"", dtype=object)
    ox = np.full(rows.shape[0], b"", dtype=object)
    xb = np.zeros(rows.shape[0])
    cellular = np.ones(rows.shape[0])
    for decoder in chain(inst):
        r = ref[id(decoder)]
        if decoder.algorithm != "pamld":
            raw = r["raw"][rows]
            ox = ox + np.array([row.tobytes() for row in raw], dtype=object)
            continue
        decoded = r["decoded"][rows]
        if variant is not None:
            decoded = decoder.remap(variant, decoded)
        # an unclassified barcode renders as its panel row 0: BAM code 0, "="
        strings = np.where(decoded > 0, decoder.strings()[np.maximum(decoded, 1) - 1],
                           b"=" * decoder.width).astype(object)
        if decoder.role == "sample":
            rg = np.where(decoded > 0, strings, b"undetermined")
            xb = _printed(r["confidence"][rows])
        else:
            cb = cb + strings
            cellular = np.where(decoded > 0, cellular * r["confidence"][rows], 0.0)
    return Answers(rg, cb, ox, ref["qcfail"][rows], xb, _printed(cellular))


def parse_records(data: bytes, first: int, count: int, batch: int, pool: int):
    """(pool index and replay of each record, Answers, missing) of `count`
    SAM records that should be stream records first..first + count - 1."""
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    rows, replay, rg, cb, ox, qcfail, xb, xc = [], [], [], [], [], [], [], []
    missing = max(0, count - len(lines))
    for k, line in enumerate(lines[:count]):
        fields = line.split(b"\t")
        stream = first + k
        j, i = divmod(stream, batch)
        want = (j // pool, (j % pool) * batch + i)
        try:
            got = parse_name(fields[0])
        except ValueError:
            got = None
        if got != want:
            missing += 1
            continue
        tags = {field[:2]: field[5:] for field in fields[11:]}
        replay.append(want[0])
        rows.append(want[1])
        rg.append(tags.get(b"RG", b""))
        cb.append(tags.get(b"CB", b""))
        ox.append(tags.get(b"OX", b""))
        qcfail.append(bool(int(fields[1]) & QCFAIL))
        xb.append(float(tags.get(b"XB", 0)))
        xc.append(float(tags.get(b"XC", 0)))
    answers = Answers(np.array(rg, dtype=object), np.array(cb, dtype=object),
                      np.array(ox, dtype=object), np.array(qcfail, dtype=bool),
                      np.array(xb), np.array(xc))
    return np.array(rows, dtype=np.int64), np.array(replay, dtype=np.int64), answers, missing


def apart_rows(program: Answers, ref: Answers, keep: np.ndarray) -> np.ndarray:
    """The rows `keep` marks whose RG, CB, OX or QC flag differ."""
    apart = ((program.rg != ref.rg) | (program.cb != ref.cb) | (program.ox != ref.ox)
             | (program.qcfail != ref.qcfail))
    return np.flatnonzero(apart & keep)


def confidence_gap(program: Answers, ref: Answers, keep: np.ndarray) -> float:
    """The widest gap between XB or XC over the rows `keep` marks."""
    gap = np.maximum(np.abs(program.xb - ref.xb), np.abs(program.xc - ref.xc))
    return float(gap[keep].max()) if keep.any() else 0.0


def describe(inst: Instrument, ref: dict, rows: np.ndarray, program: Answers, wanted: Answers,
             apart: np.ndarray, limit: int = 5) -> list:
    """What the first records apart said, beside the reference's margins."""
    out = []
    for k in apart[:limit]:
        entry = {"pool_read": int(rows[k])}
        for side, answers in (("program", program), ("reference", wanted)):
            entry[side] = [answers.rg[k].decode(), answers.cb[k].decode(), answers.ox[k].decode(),
                           bool(answers.qcfail[k]), answers.xb[k], answers.xc[k]]
        for decoder in inst.pamld():
            r = ref[id(decoder)]
            entry.setdefault(decoder.role, []).append({"confidence": float(r["confidence"][rows[k]]),
                                                       "gap": float(r["gap"][rows[k]]),
                                                       "sigma_best": float(r["sigma_best"][rows[k]])})
        out.append(entry)
    return out


def replays(pool_reads: int, batch: int, sent_batches: int) -> np.ndarray:
    """How many times each pool read was sent."""
    pool = pool_reads // batch
    per_batch = np.array([(sent_batches - p + pool - 1) // pool for p in range(pool)])
    return np.repeat(per_batch, batch)


def sends(inst: Instrument, pool: int, sent_batches: int) -> dict:
    """{(pool batch, map): times sent} over the stream's first
    `sent_batches` batches."""
    out: dict = {}
    for j in range(sent_batches):
        key = (j % pool, int(inst.variant(j // pool)))
        out[key] = out.get(key, 0) + 1
    return out


def counted(inst: Instrument) -> list[tuple[str, int]]:
    """Where the report keeps each PAMLD decoder's counts, in the chain's
    order: its role, and its position among that role's decoders."""
    order = chain(inst)
    return [(d.role, [e for e in order if e.role == d.role].index(d)) for d in order if d.algorithm == "pamld"]


def reference_counts(inst: Instrument, ref: dict, sent: dict, batch: int) -> list:
    """Each PAMLD decoder's (count, pf count) a panel row (row 0 the
    unclassified) over every read sent (`sent` as ``sends`` gives it), in
    the chain's order. A pool batch's counts are taken once; a varied
    decoder's maps permute whole orbits of its panel, so the replays of a
    batch add its counts of each orbit to the orbits the maps send it to:
    one product by a (maps x maps) matrix of how many times each orbit
    went where."""
    out = []
    for decoder in (d for d in chain(inst) if d.algorithm == "pamld"):
        r = ref[id(decoder)]
        size = decoder.barcodes + 1
        count, pf = np.zeros(size, dtype=np.int64), np.zeros(size, dtype=np.int64)
        for p in sorted({p for p, _ in sent}):
            rows = slice(p * batch, (p + 1) * batch)
            decoded = r["decoded"][rows]
            times = sum(k for (q, _), k in sent.items() if q == p)
            if decoder.variants is not None:
                maps = decoder.variants.size
                moved = np.zeros((maps, maps))  # [to, from]: times an orbit went there
                for (q, v), k in sent.items():
                    if q == p:
                        moved[decoder.variants.compose[v], np.arange(maps)] += k
            for total, seen in ((count, decoded), (pf, decoded[~r["qcfail"][rows]])):
                histogram = np.bincount(seen, minlength=size)
                if decoder.variants is None:
                    total += times * histogram
                    continue
                total[0] += times * histogram[0]
                # whole counts well under 2^53: the float64 product is exact
                total[1:] += np.rint(moved @ histogram[1:].reshape(maps, -1)).astype(np.int64).reshape(-1)
        out.append((count, pf))
    return out


def as_report(inst: Instrument, counts: list, reads: int) -> Report:
    """Counts as a report that lists every barcode of every panel gives
    them."""
    decoders = [Counts((int(c[0]), int(p[0])), d.strings(), c[1:], p[1:])
                for d, (c, p) in zip((d for d in chain(inst) if d.algorithm == "pamld"), counts)]
    return Report(reads, decoders)


def _counts_apart(strings: np.ndarray, got: Counts, count: np.ndarray, pf: np.ndarray) -> int:
    """The summed gaps between a decoder's counts in a report and the
    reference's, each barcode (and the unclassified, b"") taken by its
    sequence: a barcode on one side only counts whole, and where the
    report lists one twice its last entry stands."""
    if got.barcodes.shape == strings.shape and bool((got.barcodes == strings).all()):
        return int(abs(got.unclassified[0] - count[0]) + abs(got.unclassified[1] - pf[0])
                   + np.abs(got.count - count[1:]).sum() + np.abs(got.pf - pf[1:]).sum())
    keys = np.concatenate([np.array([b""]), got.barcodes])
    values = np.stack([np.concatenate([[got.unclassified[0]], got.count]),
                       np.concatenate([[got.unclassified[1]], got.pf])], axis=1).astype(np.int64)
    keys, last = np.unique(keys[::-1], return_index=True)
    values = values[::-1][last]
    wanted = np.concatenate([np.array([b""]), strings])
    expected = np.stack([count, pf], axis=1).astype(np.int64)
    width = np.dtype(f"S{max(keys.dtype.itemsize, wanted.dtype.itemsize)}")
    keys, wanted = keys.astype(width), wanted.astype(width)
    order = np.argsort(wanted)
    at = np.minimum(np.searchsorted(wanted[order], keys), wanted.size - 1)
    hit = wanted[order][at] == keys
    matched = order[at[hit]]
    alone = np.ones(wanted.size, dtype=bool)
    alone[matched] = False
    return int(np.abs(values[hit] - expected[matched]).sum() + values[~hit].sum() + expected[alone].sum())


def report_apart(inst: Instrument, program: Report, expected: list, sent: int, allowance: int) -> int:
    """The report's counts (each barcode's count and pf count, and the
    reads in) apart from the reference's over every read sent, less what
    reads set aside may move."""
    total = abs(program.incoming - sent)
    for decoder, got, (count, pf) in zip((d for d in chain(inst) if d.algorithm == "pamld"),
                                         program.decoders, expected):
        total += _counts_apart(decoder.strings(), got, count, pf)
    return max(0, total - allowance)


def compare(inst: Instrument, batches: list[Batch], check: dict, kept: bytes, first: int,
            count: int, batch: int, sent_batches: int, records_out: int, report: Report,
            device="cpu") -> tuple[dict, dict]:
    """(numbers compared, what was compared) for one run."""
    ref = reference(inst, batches, device=device)
    keep_pool = settled(inst, ref, check)
    rows, replay, program, missing = parse_records(kept, first, count, batch, len(batches))
    missing += abs(sent_batches * batch - records_out)
    wanted = reference_answers(inst, ref, rows, inst.variant(replay))
    keep = keep_pool[rows]
    apart = apart_rows(program, wanted, keep)
    gap = confidence_gap(program, wanted, keep)
    weights = replays(keep_pool.shape[0], batch, sent_batches)
    allowance = int((weights * ~keep_pool).sum()) * 4 * len(inst.pamld())
    expected = reference_counts(inst, ref, sends(inst, len(batches), sent_batches), batch)
    counts = report_apart(inst, report, expected, sent_batches * batch, allowance)
    numbers = {"missing": missing, "decisions_apart": int(apart.size), "confidence_gap": gap,
               "report_apart": counts}
    seen = {"records_compared": int(keep.sum()), "records_set_aside": int((~keep).sum()),
            "pool_set_aside": int((~keep_pool).sum()), "report_allowance": allowance,
            "apart": describe(inst, ref, rows, program, wanted, apart)}
    return numbers, seen


def control(inst: Instrument, batches: list[Batch], check: dict, sent_batches: int,
            device="cpu", dtype=torch.bfloat16) -> tuple[dict, dict]:
    """The numbers compared when the reference, computed in `dtype`, takes
    the program's place: its answers for every pool read and its counts
    over `sent_batches` batches, held to the float64 reference's."""
    batch = batches[0].observations[0][0].shape[0]
    ref = reference(inst, batches, device=device)
    low = reference(inst, batches, dtype=dtype, device=device)
    keep = settled(inst, ref, check)
    rows = np.arange(keep.shape[0])
    program, wanted = reference_answers(inst, low, rows), reference_answers(inst, ref, rows)
    apart = apart_rows(program, wanted, keep).size
    gap = confidence_gap(program, wanted, keep)
    weights = replays(keep.shape[0], batch, sent_batches)
    allowance = int((weights * ~keep).sum()) * 4 * len(inst.pamld())
    sent = sends(inst, len(batches), sent_batches)
    reads = sent_batches * batch
    counts = report_apart(inst, as_report(inst, reference_counts(inst, low, sent, batch), reads),
                          reference_counts(inst, ref, sent, batch), reads, allowance)
    numbers = {"missing": 0, "decisions_apart": apart, "confidence_gap": gap, "report_apart": counts}
    return numbers, {"records_compared": int(keep.sum()), "records_set_aside": int((~keep).sum())}
