"""The harness's rendering, report counting and float64 gemm path as they
were before they were rebuilt over arrays, kept verbatim: the tests hold
the rebuilt ones to these, byte for byte or number for number."""

import json
import math

import numpy as np
import torch

from demux_bench.check import Answers, _printed, chain
from demux_bench.reference.phred import PHRED_BASE, STRICT_CODES
from demux_bench.traffic import Decoder, Instrument, token_string


def _decoder_json(decoder: Decoder, index: int) -> dict:
    spec = decoder.spec
    out = {"algorithm": decoder.algorithm, "index": index,
           "transform": {"token": [token_string(t) for t in decoder.tokens]}}
    if decoder.algorithm != "pamld":
        return out
    widths = [end - start for _, start, end in decoder.tokens]
    cuts = np.cumsum([0] + widths)
    strings = [s.decode() for s in decoder.strings()]
    concentration = decoder.concentration()
    # a codec is a JSON object: the program takes its barcodes in the
    # order of their sorted keys ("1", "10", "100", ...), which decides a
    # tie; the panel's row i gets the i-th key in that order
    keys = sorted(str(i + 1) for i in range(len(strings)))
    out["codec"] = {
        key: {
            "barcode": [word[cuts[k]:cuts[k + 1]] for k in range(len(widths))],
            "concentration": concentration,
            "index": int(key),
        }
        for key, word in zip(keys, strings)
    }
    out.update({
        "noise": spec["noise"],
        "confidence threshold": spec["confidence_threshold"],
        "random barcode probability": spec["random_barcode_probability"],
        "high quality threshold": spec["high_quality_threshold"],
        "high quality distance threshold": spec["high_quality_distance_threshold"],
    })
    if decoder.role == "sample":
        out["multiplexing classifier"] = True
    return out


def instruction_text(inst: Instrument, inputs: list[str], output: str, report: str) -> str:
    """The program's instruction (the shape of ``benchmark.instruction``):
    reads from `inputs`, segment 0 out as one SAM record, the report to
    `report`. One string: json.dump would stream a whitelist-sized codec
    through the pure-Python encoder."""
    body: dict = {
        "input": list(inputs),
        "template": {"transform": {"token": ["0::"]}},
        "output": [output],
        "report url": report,
    }
    for index, decoder in enumerate(inst.decoders, start=1):
        entry = _decoder_json(decoder, index)
        if decoder.role == "sample":
            body["sample"] = entry
        else:
            body.setdefault(decoder.role, []).append(entry)
    return json.dumps(body)


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


def _gemm_sigma(lut, e, o, q):
    """(n, B): the panel's one-hot rows times each read's (position, base)
    cost table."""
    bases = torch.as_tensor(STRICT_CODES, device=e.device)
    if not bool(torch.isin(e, bases).all()):
        raise ValueError("the gemm sum takes panels of A, C, G and T only")
    table = lut[q[:, :, None], bases[None, None, :], o[:, :, None]]  # (n, W, 4)
    onehot = (e[:, :, None] == bases[None, None, :]).to(lut.dtype)  # (B, W, 4)
    return table.reshape(table.shape[0], -1) @ onehot.reshape(onehot.shape[0], -1).T


def _summed_posterior(sigma, concentration, adjusted_noise):
    """The normaliser a plain sum; the two smallest sigma by two passes
    (sigma is overwritten)."""
    base = torch.tensor(PHRED_BASE, dtype=sigma.dtype, device=sigma.device)
    conditional = torch.pow(base, sigma)
    best, index = torch.max(conditional, dim=1)
    total = conditional.sum(dim=1) * concentration + adjusted_noise
    result = _decision(conditional, torch.where(best > 0, index + 1, 0), best * concentration / total)
    del conditional
    low, at = sigma.min(dim=1)
    if sigma.shape[1] > 1:
        sigma.scatter_(1, at[:, None], math.inf)
        result["gap"] = sigma.min(dim=1).values - low
    else:
        result["gap"] = torch.full_like(low, math.inf)
    result["sigma_best"] = low
    return result


def _decision(conditional, index, confidence):
    rows = torch.arange(conditional.shape[0], device=conditional.device)
    chosen = conditional[rows, torch.clamp(index - 1, min=0)]
    return {
        "decoded": index,
        "confidence": confidence,
        "conditional": torch.where(index > 0, chosen, torch.zeros_like(chosen)),
    }
