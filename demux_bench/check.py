"""How ``correct`` is decided: the answers of the program's timed path held
to the reference's for the same reads.

The answers are each record's decisions as the SAM tags render them
(RG: the sample barcode or ``undetermined``; CB: the cellular barcode,
``=`` a position when unclassified; OX: the UMI as read; the QC-fail flag) and the
decoders' confidences (XB, XC: 1 - confidence as a float32 printed with
``%g``, absent at 0 or 1), and the report's counts a barcode. Numbers
compared, each against its limit in the cell's traffic file:

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
    written through the traffic's maps `variant` (none: as drawn)."""
    rg = np.full(rows.shape[0], b"undetermined", dtype=object)
    cb = np.full(rows.shape[0], b"", dtype=object)
    ox = np.full(rows.shape[0], b"", dtype=object)
    xb = np.zeros(rows.shape[0])
    xc = np.zeros(rows.shape[0])
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
        strings = np.concatenate([[b"=" * decoder.width], decoder.strings()]).astype(object)
        if decoder.role == "sample":
            rg = np.where(decoded > 0, strings[decoded], b"undetermined")
            xb = _printed(r["confidence"][rows])
        else:
            cb = cb + strings[decoded]
            xc = _printed(r["confidence"][rows])
    return Answers(rg, cb, ox, ref["qcfail"][rows], xb, xc)


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
            entry[decoder.role] = {"confidence": float(r["confidence"][rows[k]]),
                                   "gap": float(r["gap"][rows[k]]),
                                   "sigma_best": float(r["sigma_best"][rows[k]])}
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


def reference_counts(inst: Instrument, ref: dict, sent: dict, batch: int) -> dict:
    """{(decoder position, barcode or b""): (count, pf count)} over every
    read sent (`sent` as ``sends`` gives it); b"" stands for the
    unclassified."""
    out = {}
    for position, decoder in enumerate(d for d in chain(inst) if d.algorithm == "pamld"):
        r = ref[id(decoder)]
        size = decoder.barcodes + 1
        count = np.zeros(size, dtype=np.int64)
        pf = np.zeros(size, dtype=np.int64)
        for (p, v), times in sent.items():
            rows = slice(p * batch, (p + 1) * batch)
            decoded = decoder.remap(v, r["decoded"][rows])
            count += times * np.bincount(decoded, minlength=size)
            pf += times * np.bincount(decoded[~r["qcfail"][rows]], minlength=size)
        keys = [b""] + decoder.strings().tolist()
        out.update(zip(((position, key) for key in keys), zip(count.tolist(), pf.tolist())))
    return out


def report_counts(inst: Instrument, report: dict) -> dict:
    """The same counts from the program's report, its barcodes by sequence."""
    out = {}
    cellular = iter(report.get("cellular", []))
    for position, decoder in enumerate(d for d in chain(inst) if d.algorithm == "pamld"):
        entry = report.get("sample", {}) if decoder.role == "sample" else next(cellular, {})
        unclassified = entry.get("unclassified", {})
        out[(position, b"")] = (int(unclassified.get("count", 0)), int(unclassified.get("pf count", 0)))
        for barcode in entry.get("classified", []):
            key = "".join(barcode["barcode"]).encode()
            out[(position, key)] = (int(barcode.get("count", 0)), int(barcode.get("pf count", 0)))
    return out


def report_apart(program: dict, expected: dict, reads_in: int, sent: int, allowance: int) -> int:
    total = abs(reads_in - sent)
    for key in set(program) | set(expected):
        a = program.get(key, (0, 0))
        b = expected.get(key, (0, 0))
        total += abs(a[0] - b[0]) + abs(a[1] - b[1])
    return max(0, total - allowance)


def compare(inst: Instrument, batches: list[Batch], check: dict, kept: bytes, first: int,
            count: int, batch: int, sent_batches: int, records_out: int, report: dict,
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
    counts = report_apart(report_counts(inst, report), expected,
                          int(report.get("incoming", {}).get("count", 0)), sent_batches * batch, allowance)
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
    counts = report_apart(reference_counts(inst, low, sent, batch), reference_counts(inst, ref, sent, batch),
                          reads, reads, allowance)
    numbers = {"missing": 0, "decisions_apart": apart, "confidence_gap": gap, "report_apart": counts}
    return numbers, {"records_compared": int(keep.sum()), "records_set_aside": int((~keep).sum())}
