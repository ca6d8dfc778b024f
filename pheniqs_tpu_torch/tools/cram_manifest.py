"""Externally verifiable CRAM fixture set + sha256 manifest.

The container this framework is built in has no htslib, so the CRAM
writer's bytes can only be cross-validated in-tree (independent mini
codec, BAM round trips). This tool closes the same-author loop for
anyone OUTSIDE the container: it deterministically regenerates the
fixture set checked into ``tests/data/cram_manifest/`` — every byte a
pure function of fixed seeds, no clock, no environment — together with
a ``MANIFEST.json`` recording each file's sha256 and the exact htslib
one-liners that validate the writer's output against samtools
(see docs/cram_validation.md).

The reference delegates all of this to htslib (reference hts.h:42-299,
hts.cpp:160-240); these fixtures are how this reimplementation proves
interchange with that ecosystem.

Usage:
    python -m pheniqs_tpu_torch.tools.cram_manifest <output-directory>
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

BAM_TO_ASCII = "=ACMGRSVTWYHKDBN"


def _reference_sequences():
    rng = np.random.default_rng(2026)
    ref1 = "".join(rng.choice(list("ACGT"), size=500))
    ref2 = "".join(rng.choice(list("ACGT"), size=300))
    return ref1, ref2


def _unmapped_header():
    return (
        "@HD\tVN:1.6\tSO:unknown\n"
        "@RG\tID:BDGGG:1:AGGCATG\tSM:alpha\tPU:AGGCATG\n"
        "@RG\tID:undetermined\tSM:alpha\tPU:undetermined\n"
        "@PG\tID:pheniqs-tpu\tPN:pheniqs-tpu\n"
    )


def _mapped_header(ref1: str, ref2: str):
    return (
        "@HD\tVN:1.6\tSO:coordinate\n"
        f"@SQ\tSN:chr1\tLN:{len(ref1)}\n"
        f"@SQ\tSN:chr2\tLN:{len(ref2)}\n"
        "@RG\tID:rg0\tSM:beta\n"
    )


def write_unmapped_demux(path: str):
    """Per-record CRAM intake: demux-shaped unmapped records with the
    framework's full tag block across two read groups and >1 slice."""
    from ..io.cram import CramWriter
    from ..io.sam import AuxTags
    from ..iupac import ASCII_TO_BAM

    rng = np.random.default_rng(41)
    n = 600
    with open(path, "wb") as stream:
        writer = CramWriter(stream, _unmapped_header(), level=5)
        writer.RECORDS_PER_SLICE = 256  # 3 containers
        for i in range(n):
            length = int(rng.integers(24, 37))
            seq = "".join(
                "ACGTN"[j] for j in rng.integers(0, 5, size=length)
            )
            code = ASCII_TO_BAM[np.frombuffer(seq.encode(), np.uint8)]
            qual = rng.integers(2, 42, size=length).astype(np.uint8)
            tags = AuxTags()
            tags.RG = "BDGGG:1:AGGCATG" if i % 3 else "undetermined"
            tags.BC = "AGGCATG"
            tags.QT = "IIIIIII"
            if i % 2 == 0:
                tags.XB = float(np.float32(0.25 + (i % 8) * 0.0625))
            if i % 5 == 0:
                tags.RX = "ACGT"
                tags.QX = "IIII"
            if i % 7 == 0:
                tags.FI = (i % 3) + 1
                tags.TC = 3
            flag = 0x4D if i % 2 else 0x8E  # both carry FLAG_UNMAPPED
            flag |= 0x200 if i % 11 == 0 else 0
            writer.write_record(
                f"M02455:162:1:{i}", flag, code, qual, length, tags
            )
        writer.close()
    return n


def write_v31_demux(path: str):
    """CRAM 3.1: the same demux record shape written with the 3.1
    codecs — rANS Nx16 base/quality series + tok3 tokenized names
    (io/rans_nx16.py, io/tok3.py). `samtools view` on any htslib >= 1.12
    build reads 3.1, so this fixture lets an external party validate
    the new codecs exactly like the 3.0 ones."""
    from ..io.cram import CramWriter
    from ..io.sam import AuxTags
    from ..iupac import ASCII_TO_BAM

    rng = np.random.default_rng(53)
    n = 600
    with open(path, "wb") as stream:
        writer = CramWriter(stream, _unmapped_header(), level=5,
                            version=(3, 1))
        writer.RECORDS_PER_SLICE = 256
        for i in range(n):
            length = int(rng.integers(24, 37))
            seq = "".join(
                "ACGTN"[j] for j in rng.integers(0, 5, size=length)
            )
            code = ASCII_TO_BAM[np.frombuffer(seq.encode(), np.uint8)]
            qual = rng.choice(
                np.array([2, 12, 23, 37], dtype=np.uint8), size=length
            )
            tags = AuxTags()
            tags.RG = "BDGGG:1:AGGCATG" if i % 3 else "undetermined"
            tags.BC = "AGGCATG"
            tags.QT = "IIIIIII"
            if i % 2 == 0:
                tags.XB = float(np.float32(0.25 + (i % 8) * 0.0625))
            flag = 0x4D if i % 2 else 0x8E
            writer.write_record(
                f"M02455:162:31:{1101 + i % 4}:{1000 + i}", flag, code,
                qual, length, tags,
            )
        writer.close()
    return n


def write_mapped_mixed(path: str, fasta_path: str):
    """Reference-based mapped records covering every feature class the
    writer emits: perfect match, substitutions, insertion+soft clip,
    deletion, skip, ambiguity bases, hard clip + mate fields, and an
    interleaved unmapped record."""
    from ..io.cram import CramWriter
    from ..io.hts import HtsRecord
    from ..iupac import ASCII_TO_BAM

    ref1, ref2 = _reference_sequences()
    with open(fasta_path, "w") as stream:
        stream.write(f">chr1\n{ref1}\n>chr2\n{ref2}\n")

    rng = np.random.default_rng(43)

    def rec(name, ref_id, pos, cigar, seq, mapq=37, flag=0, aux=None,
            next_ref=-1, next_pos=-1, tlen=0):
        code = ASCII_TO_BAM[np.frombuffer(seq.encode(), np.uint8)]
        qual = rng.integers(10, 40, size=len(seq)).astype(np.uint8)
        return HtsRecord(
            name.encode(), flag, code, qual, aux or {},
            ref_id=ref_id, pos=pos, mapq=mapq, cigar=cigar,
            next_ref=next_ref, next_pos=next_pos, tlen=tlen,
        )

    seq1 = list(ref1[100:140])
    seq1[5] = "A" if seq1[5] != "A" else "G"
    seq1[20] = "T" if seq1[20] != "T" else "C"
    seq5 = list(ref2[10:30])
    seq5[3] = "N"
    records = [
        rec("match", 0, 10, [("M", 40)], ref1[10:50]),
        rec("subst", 0, 100, [("M", 40)], "".join(seq1),
            aux={"NM": 2, "XB": 0.25, "CO": "hello"}),
        rec("indel", 0, 200, [("S", 5), ("M", 20), ("I", 4), ("M", 20)],
            "ACGTA" + ref1[200:220] + "GGGG" + ref1[220:240]),
        rec("deleted", 1, 50, [("M", 10), ("D", 7), ("M", 10)],
            ref2[50:60] + ref2[67:77]),
        rec("skipped", 1, 100, [("M", 8), ("N", 30), ("M", 8)],
            ref2[100:108] + ref2[138:146]),
        rec("ambig", 1, 10, [("M", 20)], "".join(seq5)),
        rec("mate", 0, 300, [("H", 3), ("M", 25)], ref1[300:325],
            flag=0x1 | 0x20, next_ref=0, next_pos=400, tlen=125,
            aux={"RG": "rg0"}),
        rec("unmapped", -1, -1, None, "ACGTACGTNN", mapq=0, flag=0x4),
    ]
    with open(path, "wb") as stream:
        writer = CramWriter(
            stream, _mapped_header(ref1, ref2), level=5,
            reference=fasta_path,
        )
        for record in records:
            writer.write_hts_record(record)
        writer.close()
    return len(records)


def write_batch_columnar(path: str):
    """The vectorized columnar intake (write_batch), byte-compatible with
    the per-record path — one TD line, a slice boundary crossed."""
    from ..io.cram import CramWriter

    rng = np.random.default_rng(47)
    n = 600
    w = 36
    lengths = rng.integers(20, w + 1, size=n).astype(np.int64)
    alphabet = np.array([1, 2, 4, 8, 15], dtype=np.uint8)
    codes = alphabet[rng.integers(len(alphabet), size=(n, w))]
    quals = rng.integers(2, 42, size=(n, w)).astype(np.uint8)
    names = [b"M02455:162:2:%d" % i for i in range(n)]
    flags = np.where(np.arange(n) % 2 == 0, 0x4D, 0x8E).astype(np.int64)
    rg = (np.arange(n) % 2).astype(np.int64)
    bc = np.frombuffer(b"AGGCATG" * n, dtype=np.uint8).reshape(n, 7).copy()
    qt = [b"IIIIIII"] * n
    xb = (rng.random(n).astype(np.float32) * np.float32(0.5))
    with open(path, "wb") as stream:
        writer = CramWriter(stream, _unmapped_header(), level=5)
        writer.RECORDS_PER_SLICE = 256
        writer.write_batch(
            names, flags, codes, quals, lengths, rg,
            [(b"BC", "Z", bc), (b"QT", "Z", qt), (b"XB", "f", xb)],
        )
        writer.close()
    return n


_B_SUBTYPES = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I",
               "f": "f"}


def _render_b_array(raw: bytes) -> str:
    """SAM text for a 'B' array tag's raw BAM value bytes: subtype char,
    int32 count, packed values -> 'c,1,2,3' (htslib sam.c semantics;
    floats print with %g like scalar 'f' tags)."""
    import struct

    subtype = chr(raw[0])
    (count,) = struct.unpack_from("<i", raw, 1)
    values = struct.unpack_from(f"<{count}{_B_SUBTYPES[subtype]}", raw, 5)
    if subtype == "f":
        body = ",".join(f"{v:g}" for v in values)
    else:
        body = ",".join(str(v) for v in values)
    return f"{subtype},{body}" if count else subtype


def render_sam(cram_path: str, reference: str | None = None) -> str:
    """SAM text for a CRAM as htslib renders it (``samtools view -h
    --no-PG``): stored tag order, integer tags printed as 'i', floats
    as %g, RG appended last (htslib cram_decode.c appends RG after the
    stored tag block)."""
    from ..io.cram import _decode_tag_value, read_cram, read_cram_header

    header_text, references = read_cram_header(cram_path)
    sq_names = [name for name, _ in references]
    lines = [header_text if header_text.endswith("\n") else header_text + "\n"]
    for record in read_cram(cram_path, reference=reference):
        code = record.code
        seq = (
            "".join(BAM_TO_ASCII[int(c)] for c in code) if len(code) else "*"
        )
        quality = record.quality
        if len(quality) == 0 or (quality == 0xFF).all():
            qual = "*"
        else:
            qual = "".join(chr(int(q) + 33) for q in quality)
        rname = sq_names[record.ref_id] if record.ref_id >= 0 else "*"
        pos = record.pos + 1 if record.pos >= 0 else 0
        if record.cigar:
            cigar = "".join(f"{ln}{op}" for op, ln in record.cigar)
        else:
            cigar = "*"
        if record.next_ref < 0:
            rnext = "*"
        elif record.next_ref == record.ref_id and record.ref_id >= 0:
            rnext = "="
        else:
            rnext = sq_names[record.next_ref]
        pnext = record.next_pos + 1 if record.next_pos >= 0 else 0
        fields = [
            record.name.decode(), str(record.flag), rname, str(pos),
            str(record.mapq), cigar, rnext, str(pnext), str(record.tlen),
            seq, qual,
        ]
        for key, value in (record.raw_tags or []):
            tag = key[:2].decode()
            kind = chr(key[2])
            if kind == "B":
                fields.append(f"{tag}:B:{_render_b_array(value)}")
                continue
            decoded = _decode_tag_value(kind, value)
            if kind in "cCsSiI":
                fields.append(f"{tag}:i:{decoded}")
            elif kind == "f":
                fields.append(f"{tag}:f:{decoded:g}")
            elif kind == "A":
                fields.append(f"{tag}:A:{decoded}")
            elif kind == "H":
                fields.append(f"{tag}:H:{decoded}")
            else:
                fields.append(f"{tag}:Z:{decoded}")
        if "RG" in record.aux:
            fields.append(f"RG:Z:{record.aux['RG']}")
        lines.append("\t".join(fields) + "\n")
    return "".join(lines)


def zlib_canary() -> str:
    """sha256 of a fixed gzip member: identifies the local zlib build's
    exact output bytes. The .cram fixtures are byte-reproducible only
    under a zlib whose canary matches the manifest's (gzip output is
    deterministic per build, not across builds — e.g. zlib-ng); the SAM
    truths and the samtools validation are build-independent."""
    import gzip

    member = gzip.compress(b"pheniqs-tpu zlib canary" * 32,
                           compresslevel=5, mtime=0)
    return hashlib.sha256(member).hexdigest()


def sha256(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as stream:
        for chunk in iter(lambda: stream.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def generate(outdir: str) -> dict:
    os.makedirs(outdir, exist_ok=True)
    counts = {}
    counts["unmapped_demux.cram"] = write_unmapped_demux(
        os.path.join(outdir, "unmapped_demux.cram")
    )
    counts["mapped_mixed.cram"] = write_mapped_mixed(
        os.path.join(outdir, "mapped_mixed.cram"),
        os.path.join(outdir, "ref.fa"),
    )
    counts["batch_columnar.cram"] = write_batch_columnar(
        os.path.join(outdir, "batch_columnar.cram")
    )
    counts["v31_demux.cram"] = write_v31_demux(
        os.path.join(outdir, "v31_demux.cram")
    )
    for name, reference in (
        ("unmapped_demux", None),
        ("mapped_mixed", os.path.join(outdir, "ref.fa")),
        ("batch_columnar", None),
        ("v31_demux", None),
    ):
        sam = render_sam(os.path.join(outdir, f"{name}.cram"), reference)
        with open(os.path.join(outdir, f"{name}.sam"), "w") as stream:
            stream.write(sam)

    files = {}
    # explicit list: hashing whatever else happens to sit in outdir would
    # silently attest stray files into the manifest
    names = [
        "batch_columnar.cram", "batch_columnar.sam",
        "mapped_mixed.cram", "mapped_mixed.sam",
        "ref.fa",
        "unmapped_demux.cram", "unmapped_demux.sam",
        "v31_demux.cram", "v31_demux.sam",
    ]
    for name in names:
        path = os.path.join(outdir, name)
        files[name] = {
            "sha256": sha256(path),
            "bytes": os.path.getsize(path),
        }
        if name in counts:
            files[name]["records"] = counts[name]
    manifest = {
        "generator": "python -m pheniqs_tpu_torch.tools.cram_manifest <dir>",
        "cram_version": "3.0",
        "zlib_canary_sha256": zlib_canary(),
        "determinism": (
            "every byte is a pure function of fixed seeds; gzip members "
            "use mtime=0. Regeneration is byte-identical for a given "
            "zlib build (gzip output may differ across zlib versions; "
            "the sha256s pin THESE files, the SAM truths are "
            "version-independent)"
        ),
        "external_validation": [
            "samtools quickcheck -v unmapped_demux.cram mapped_mixed.cram batch_columnar.cram v31_demux.cram",
            "samtools view -h --no-PG unmapped_demux.cram | diff - unmapped_demux.sam",
            "samtools view -h --no-PG -T ref.fa mapped_mixed.cram | diff - mapped_mixed.sam",
            "samtools view -h --no-PG batch_columnar.cram | diff - batch_columnar.sam",
            "samtools view -h --no-PG v31_demux.cram | diff - v31_demux.sam  # CRAM 3.1: rANS Nx16 + tok3 (htslib >= 1.12)",
        ],
        "files": files,
    }
    with open(os.path.join(outdir, "MANIFEST.json"), "w") as stream:
        json.dump(manifest, stream, indent=2, sort_keys=False)
        stream.write("\n")
    return manifest


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 5
    manifest = generate(argv[0])
    for name, meta in manifest["files"].items():
        print(f"{meta['sha256']}  {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
