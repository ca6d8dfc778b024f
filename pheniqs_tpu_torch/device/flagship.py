"""Synthetic flagship workload, NumPy only (port of
``pheniqs_tpu.device.flagship``, whose module imports JAX when it loads).

The instrument models a dual-index Illumina + single-cell run: a PAMLD
sample decoder over a 96-barcode i7+i5 panel, a PAMLD cellular decoder
over a 384-barcode 16 nt panel and a naive molecular (UMI) extractor, on
4-segment reads (150 + 8 + 8 + 26 nt). ``tests/test_torch_instrument.py``
holds both functions identical to the originals for the same seed.

Three variants run the port's other decoders and kernel instances on the
same reads: ``mdd_flagship_ontology`` demultiplexes samples by minimum
distance (MDD, the bcl2fastq-style decoder Illumina index sets are
designed for), ``whitelist_flagship_ontology`` replaces the cellular panel
with a 737,280-barcode 16 nt whitelist, the size of 10x Genomics' 3' v2
whitelist (``737K-august-2016.txt``), ``wide_flagship_ontology``
widens the cellular barcode past the 64 positions the PAMLD kernels once
held in registers (synthetic: no published single-cell design reads a
barcode that long), and ``wide_mdd_ontology`` gives the MDD sample decoder
a barcode of 12 segments and 130 positions read from segment 0 (synthetic
too: no published index design is that long or has that many segments).
"""

from __future__ import annotations

import numpy as np

BASES = np.array(list("ACGT"))
#: BAM 4-bit codes for A/C/G/T
BASE_CODES = np.array([1, 2, 4, 8], dtype=np.uint8)

#: NovaSeq RTA3 quality bins: q<=2 -> 2, 3..14 -> 12, 15..30 -> 23, >=31 -> 37
RTA3_VALUES = (2, 12, 23, 37)

SEGMENT_WIDTHS = (150, 8, 8, 26)

#: barcodes of 10x Genomics' 3' v2 cell barcode whitelist (737K-august-2016.txt)
WHITELIST_BARCODES = 737_280


def rta3_bin(qual: np.ndarray) -> np.ndarray:
    """Quantize Phred qualities to the NovaSeq RTA3 four-value alphabet."""
    binned = np.full(qual.shape, 37, dtype=np.uint8)
    binned[qual <= 30] = 23
    binned[qual <= 14] = 12
    binned[qual <= 2] = 2
    return binned


def _random_words(rng: np.random.Generator, count: int, length: int) -> list[str]:
    seen: set[str] = set()
    words: list[str] = []
    while len(words) < count:
        word = "".join(rng.choice(BASES, size=length))
        if word not in seen:
            seen.add(word)
            words.append(word)
    return words


def _codec(words: list[str], segments: list[int], noise: float) -> dict:
    codec = {}
    for i, word in enumerate(words):
        barcode = []
        offset = 0
        for width in segments:
            barcode.append(word[offset : offset + width])
            offset += width
        codec[str(i + 1)] = {
            "barcode": barcode,
            "concentration": (1.0 - noise) / len(words),
            "index": i + 1,
        }
    return codec


def flagship_ontology(
    sample_barcodes: int = 96,
    cellular_barcodes: int = 384,
    seed: int = 20260816,
) -> dict:
    """Compiled-instruction-shaped ontology for the flagship instrument.

    Read layout (4 segments, the NovaSeq dual-index single-cell shape):
      segment 0: 150 nt biological,  segment 1: 8 nt i7,
      segment 2: 8 nt i5,            segment 3: 26 nt (16 cell + 10 UMI).
    """
    rng = np.random.default_rng(seed)
    sample_words = _random_words(rng, sample_barcodes, 16)
    cell_words = _random_words(rng, cellular_barcodes, 16)
    sample_noise = 0.05
    cell_noise = 0.05
    return {
        "input segment cardinality": 4,
        "output segment cardinality": 1,
        "sample": {
            "algorithm": "pamld",
            "index": 1,
            "multiplexing classifier": True,
            "codec": _codec(sample_words, [8, 8], sample_noise),
            "noise": sample_noise,
            "confidence threshold": 0.95,
            "random barcode probability": 1.0 / 4**16,
            "high quality threshold": 30,
            "high quality distance threshold": 0,
            "transform": {"token": ["1::8", "2::8"]},
        },
        "cellular": [
            {
                "algorithm": "pamld",
                "index": 2,
                "codec": _codec(cell_words, [16], cell_noise),
                "noise": cell_noise,
                "confidence threshold": 0.95,
                "random barcode probability": 1.0 / 4**16,
                "high quality threshold": 30,
                "high quality distance threshold": 0,
                "transform": {"token": ["3::16"]},
            }
        ],
        "molecular": [
            {
                "algorithm": "naive",
                "index": 3,
                "transform": {"token": ["3:16:26"]},
            }
        ],
    }


def _distant_words(rng: np.random.Generator, count: int, length: int, distance: int) -> list[str]:
    """`count` words drawn one by one, each kept only at Hamming distance
    >= `distance` from every word kept before it (rejection sampling)."""
    kept = np.zeros((0, length), dtype=np.int64)
    while kept.shape[0] < count:
        word = rng.integers(4, size=length)
        if kept.shape[0] == 0 or (kept != word[None, :]).sum(axis=1).min() >= distance:
            kept = np.concatenate([kept, word[None, :]])
    return ["".join(BASES[row]) for row in kept]


def mdd_flagship_ontology(
    sample_barcodes: int = 96,
    cellular_barcodes: int = 384,
    seed: int = 20260816,
) -> dict:
    """The flagship with an MDD sample decoder: `sample_barcodes` dual-index
    8+8 nt barcodes whose i7 and i5 sets each keep a pairwise distance of
    at least 3, so the config compiler's Shannon bound admits the distance
    tolerance [1, 1] that Illumina index sets are designed for; the quality
    masking threshold stays at the reference default (0). The cellular
    PAMLD decoder and the UMI are the flagship's."""
    ontology = flagship_ontology(sample_barcodes, cellular_barcodes, seed)
    rng = np.random.default_rng(seed + 1)
    i7 = _distant_words(rng, sample_barcodes, 8, 3)
    i5 = _distant_words(rng, sample_barcodes, 8, 3)
    sample = ontology["sample"]
    sample["algorithm"] = "mdd"
    sample["codec"] = _codec([a + b for a, b in zip(i7, i5)], [8, 8], sample["noise"])
    sample["distance tolerance"] = [1, 1]
    sample["quality masking threshold"] = 0
    return ontology


def _unique_words(rng: np.random.Generator, count: int, length: int) -> list[str]:
    """`count` distinct random words, drawn in bulk."""
    draws = rng.integers(4, size=(count + count // 8 + 64, length), dtype=np.uint8)
    keys = np.zeros(draws.shape[0], dtype=np.uint64)
    for column in range(length):
        keys = keys * np.uint64(4) + draws[:, column].astype(np.uint64)
    _, first = np.unique(keys, return_index=True)
    chosen = draws[np.sort(first)[:count]]
    if chosen.shape[0] < count:
        raise ValueError(f"could not draw {count} distinct {length}-mers")
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)[chosen]
    return [word.decode() for word in letters.view(f"S{length}")[:, 0]]


def whitelist_flagship_ontology(
    cellular_barcodes: int = WHITELIST_BARCODES,
    sample_barcodes: int = 96,
    seed: int = 20260816,
) -> dict:
    """The flagship with its cellular panel replaced by a synthetic
    `cellular_barcodes` x 16 nt whitelist drawn from `seed` (the 10x 3' v2
    size by default: the real list is not in the repository, and the
    panel's size and width are what set the work). The sample decoder is
    the flagship's PAMLD 96."""
    ontology = flagship_ontology(sample_barcodes, 1, seed)
    cellular = ontology["cellular"][0]
    words = _unique_words(np.random.default_rng(seed + 2), cellular_barcodes, 16)
    cellular["codec"] = _codec(words, [16], cellular["noise"])
    return ontology


def wide_flagship_ontology(
    cellular_barcodes: int = 384,
    width: int = 96,
    seed: int = 20260816,
) -> dict:
    """The flagship with a `width`-nt cellular barcode: segment 3 becomes
    `width` + 10 nt (the barcode, then the 10 nt UMI), the cellular decoder
    a PAMLD panel of `cellular_barcodes` random `width`-mers drawn from
    `seed` (noise and random barcode probability the flagship's), token
    "3::`width`", the UMI "3:`width`:`width + 10`". The sample decoder is the
    flagship's PAMLD 96 dual-index 8+8 nt. ``synthetic_batch`` draws
    segment 3 from the cellular panel's width."""
    ontology = flagship_ontology(96, 1, seed)
    cellular = ontology["cellular"][0]
    words = _unique_words(np.random.default_rng(seed + 3), cellular_barcodes, width)
    cellular["codec"] = _codec(words, [width], cellular["noise"])
    cellular["transform"] = {"token": [f"3::{width}"]}
    ontology["molecular"][0]["transform"] = {"token": [f"3:{width}:{width + 10}"]}
    return ontology


def wide_mdd_ontology(
    segments: int = 12,
    width: int = 130,
    tolerance: int = 2,
    sample_barcodes: int = 96,
    seed: int = 20260816,
) -> dict:
    """The MDD flagship with a sample barcode of `segments` segments and
    `width` positions, read from the first `width` nt of segment 0 (the
    segments as even as they divide, the first ones a position longer),
    each segment's words drawn at pairwise distance >= 2 * `tolerance` + 1
    so that the config compiler admits the distance tolerance `tolerance`
    on every segment. ``synthetic_batch`` draws segment 0's first `width`
    nt from the sample panel. The cellular PAMLD decoder and the UMI are
    the flagship's."""
    ontology = mdd_flagship_ontology(sample_barcodes, 384, seed)
    widths = [width // segments + (1 if s < width % segments else 0) for s in range(segments)]
    starts = np.concatenate([[0], np.cumsum(widths)[:-1]])
    rng = np.random.default_rng(seed + 5)
    words = [_distant_words(rng, sample_barcodes, w, 2 * tolerance + 1) for w in widths]
    sample = ontology["sample"]
    sample["codec"] = _codec(["".join(parts) for parts in zip(*words)], widths, sample["noise"])
    sample["distance tolerance"] = [tolerance] * segments
    sample["transform"] = {"token": [f"0:{s}:{s + w}" for s, w in zip(starts, widths)]}
    return ontology


def panel_codes(ontology: dict) -> tuple[np.ndarray, np.ndarray]:
    """(sample, cellular) (B, W) uint8 panel codes of an ontology, as
    ``synthetic_batch`` draws from them."""
    from ..decode.spec import spec_from_ontology

    return (
        np.asarray(spec_from_ontology(ontology["sample"], "sample").panel.codes, dtype=np.uint8),
        np.asarray(
            spec_from_ontology(ontology["cellular"][0], "cellular").panel.codes, dtype=np.uint8
        ),
    )


def synthetic_batch(
    ontology: dict,
    n: int,
    seed: int = 7,
    error_rate: float = 0.02,
    segment_widths: tuple[int, ...] | None = None,
    quality_binning: str | None = "rta3",
    panels: tuple[np.ndarray, np.ndarray] | None = None,
) -> dict:
    """Simulate a NumPy read batch drawn from the ontology's panels
    (RTA3-binned qualities by default; ``quality_binning=None`` keeps a
    rich Sanger-scale alphabet). ``panels`` is ``panel_codes(ontology)``,
    computed once by a caller that draws many batches. The segment widths
    are the flagship's, segment 3 the cellular panel's width + 10 (26 on
    the flagship), unless ``segment_widths`` gives them. Returns
    ``{"segments": [(code, quality, length), ...], "qcfail": (n,) bool}``
    with int32 arrays."""
    rng = np.random.default_rng(seed)
    segments = []
    sample_codes, cell_codes = panels if panels is not None else panel_codes(ontology)
    if segment_widths is None:
        segment_widths = SEGMENT_WIDTHS[:3] + (cell_codes.shape[1] + 10,)
    draw_sample = sample_codes[rng.integers(sample_codes.shape[0], size=n)]
    draw_cell = cell_codes[rng.integers(cell_codes.shape[0], size=n)]

    def noisy(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        qual = rng.integers(12, 41, size=codes.shape).astype(np.uint8)
        err = rng.random(codes.shape) < error_rate
        sub = BASE_CODES[rng.integers(4, size=codes.shape)]
        code = np.where(err, sub, codes).astype(np.uint8)
        qual = np.where(err, rng.integers(2, 20, size=codes.shape), qual).astype(
            np.uint8
        )
        return code, qual

    # a sample barcode other than the dual index (wide_mdd_ontology) is
    # read from the start of segment 0; the index reads are then random
    dual_index = sample_codes.shape[1] == 16
    for s, width in enumerate(segment_widths):
        if s == 0:
            code = BASE_CODES[rng.integers(4, size=(n, width))]
            qual = rng.integers(20, 41, size=(n, width)).astype(np.uint8)
            if not dual_index:
                w = sample_codes.shape[1]
                code[:, :w], qual[:, :w] = noisy(draw_sample)
        elif s in (1, 2) and not dual_index:
            code, qual = noisy(BASE_CODES[rng.integers(4, size=(n, width))])
        elif s == 1:
            code, qual = noisy(draw_sample[:, :8])
        elif s == 2:
            code, qual = noisy(draw_sample[:, 8:])
        else:
            cell_code, cell_qual = noisy(draw_cell)
            umi = BASE_CODES[rng.integers(4, size=(n, 10))]
            umi_qual = rng.integers(20, 41, size=(n, 10)).astype(np.uint8)
            code = np.concatenate([cell_code, umi], axis=1)
            qual = np.concatenate([cell_qual, umi_qual], axis=1)
        if quality_binning == "rta3":
            qual = rta3_bin(qual)
        segments.append(
            (
                code.astype(np.int32),
                qual.astype(np.int32),
                np.full(n, width, dtype=np.int32),
            )
        )
    return {
        "segments": segments,
        "qcfail": np.zeros(n, dtype=bool),
    }
