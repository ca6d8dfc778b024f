"""Traffic: the instrument's panels, its instruction and the pool of reads,
all drawn from one seed, NumPy only.

A frozen copy of the program's synthetic flagship workload
(``pheniqs_tpu_torch/device/flagship.py``: ``flagship_ontology``,
``whitelist_flagship_ontology`` and ``synthetic_batch``), generalised so
that a configuration file gives the segment widths and the decoders, and
rendered into FASTQ here rather than by the program's native writer.

Every read is fixed width, so a batch of one segment renders into one
(n, 21 + 2w) byte matrix: ``@`` + a 15-byte name + sequence + ``+`` +
qualities. The name is ``r<replay:6>i<index:7>``: the pool's reads are
replayed with the replay digits rewritten, so names stay unique.

A traffic mix may name a decoder whose barcodes differ from one replay
to the next (``vary``): its panel is drawn closed under a group of maps
(``Variants``), and replay r writes each read's barcode through map
r mod |group|, so no observation of that decoder comes twice within
|group| replays, and the reference's decisions for the pool give every
replay's. Its reads come from the first ``barcodes`` // |group| orbits
of the panel (a library's cells), a set the maps keep.
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field

import numpy as np

#: BAM 4-bit codes of A, C, G, T
BASE_CODES = np.array([1, 2, 4, 8], dtype=np.uint8)
#: BAM 4-bit code -> ASCII letter
CODE_TO_ASCII = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)
LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)
#: ASCII letter -> index into ACGT
ASCII_TO_INDEX = np.zeros(256, dtype=np.uint8)
ASCII_TO_INDEX[LETTERS] = np.arange(4, dtype=np.uint8)
#: the 24 permutations of ACGT as index maps, the identity first
LETTER_MAPS = np.array(list(itertools.permutations(range(4))), dtype=np.uint8)

NAME_WIDTH = 15
REPLAY_DIGITS = 6
INDEX_DIGITS = 7
#: offset of the replay digits in a rendered record (after "@r")
REPLAY_AT = 2


def rta3_bin(qual: np.ndarray) -> np.ndarray:
    """NovaSeq RTA3 bins: q <= 2 -> 2, 3..14 -> 12, 15..30 -> 23, >= 31 -> 37."""
    binned = np.full(qual.shape, 37, dtype=np.uint8)
    binned[qual <= 30] = 23
    binned[qual <= 14] = 12
    binned[qual <= 2] = 2
    return binned


def word_keys(words: np.ndarray) -> np.ndarray:
    """(...,) uint64 keys of (..., W) words of indices into ACGT, W <= 32."""
    keys = np.zeros(words.shape[:-1], dtype=np.uint64)
    for column in range(words.shape[-1]):
        keys = keys * np.uint64(4) + words[..., column].astype(np.uint64)
    return keys


def unique_words(rng: np.random.Generator, count: int, length: int) -> np.ndarray:
    """`count` distinct random words of `length` bases, (count, length)
    uint8 indices into ACGT, drawn in bulk."""
    draws = rng.integers(4, size=(count + count // 8 + 64, length), dtype=np.uint8)
    _, first = np.unique(word_keys(draws), return_index=True)
    chosen = draws[np.sort(first)[:count]]
    if chosen.shape[0] < count:
        raise ValueError(f"could not draw {count} distinct {length}-mers")
    return chosen


@dataclass
class Variants:
    """A group of maps of W-base words: one of the 24 permutations of A, C,
    G and T with a rotation of the positions by a multiple of
    W / rotations; map v is permutation v mod 24 with rotation v // 24.

    PAMLD's cost of a position depends only on its quality and on whether
    the read's base matches the barcode's, so one map applied to a read
    (bases and qualities) and to every barcode leaves each sigma, the
    confidence and the decision as they were: a mapped read decodes to
    the mapped barcode."""

    width: int
    rotations: int

    def __post_init__(self):
        if self.width % self.rotations or self.width > 32:
            raise ValueError("a varied decoder's width must be at most 32 and divide into its rotations")
        index = {tuple(m): k for k, m in enumerate(LETTER_MAPS.tolist())}
        letters = [[index[tuple(LETTER_MAPS[a][LETTER_MAPS[b]].tolist())] for b in range(24)]
                   for a in range(24)]
        v = np.arange(self.size)
        # map a after map b: the permutations composed, the rotations added
        self.compose = (((v[:, None] // 24 + v[None, :] // 24) % self.rotations) * 24
                        + np.array(letters)[v[:, None] % 24, v[None, :] % 24])

    @property
    def size(self) -> int:
        return 24 * self.rotations

    def shift(self, v: int) -> int:
        return (v // 24) * (self.width // self.rotations)

    def apply(self, v: int, words: np.ndarray) -> np.ndarray:
        """Map v of (..., W) words of indices into ACGT."""
        return np.roll(LETTER_MAPS[v % 24][words], self.shift(v), axis=-1)


def closed_words(rng: np.random.Generator, count: int, variants: Variants) -> np.ndarray:
    """`count` distinct words closed under `variants`: count / |group|
    random words, each with its |group| images, the images of map v in
    rows v * (count / |group|) onwards."""
    if count % variants.size:
        raise ValueError(f"{count} barcodes do not split into orbits of {variants.size}")
    base = count // variants.size
    draws = rng.integers(4, size=(base + base // 8 + 64, variants.width), dtype=np.uint8)
    keys = word_keys(np.stack([variants.apply(v, draws) for v in range(variants.size)], axis=1))
    ordered = np.sort(keys, axis=1)
    whole = (np.diff(ordered, axis=1) > 0).all(axis=1)  # every image distinct
    # two words' orbits are one or disjoint: a word is new where its least image is
    _, first = np.unique(np.where(whole, ordered[:, 0], np.uint64(0)), return_index=True)
    chosen = np.sort(first[whole[first]])[:base]
    if chosen.shape[0] < base:
        raise ValueError(f"could not draw {base} orbits of {variants.width}-mers")
    return np.concatenate([variants.apply(v, draws[chosen]) for v in range(variants.size)])


def token_string(token: list[int]) -> str:
    segment, start, end = token
    return f"{segment}:{start if start else ''}:{end}"


@dataclass
class Decoder:
    """One decoder of the instrument as the configuration file gives it,
    with its panel drawn from the seed (PAMLD only)."""

    role: str
    algorithm: str
    tokens: list
    spec: dict
    words: np.ndarray | None = None  # (B, W) indices into ACGT
    variants: Variants | None = None  # the maps its barcodes go through, replay to replay
    library: int | None = None  # the barcodes its reads come from (orbits of the maps); None: all

    @property
    def width(self) -> int:
        return sum(end - start for _, start, end in self.tokens)

    @property
    def barcodes(self) -> int:
        return 0 if self.words is None else self.words.shape[0]

    @property
    def codes(self) -> np.ndarray:
        """(B, W) BAM codes of the panel, in codec order."""
        return BASE_CODES[self.words]

    def strings(self) -> np.ndarray:
        """(B,) the panel's words as bytes."""
        return LETTERS[self.words].view(f"S{self.width}")[:, 0]

    def concentration(self) -> float:
        return (1.0 - self.spec["noise"]) / self.barcodes

    def draw(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """The panel rows (0-based) of `n` reads' barcodes, uniform over the
        library."""
        if self.library is None:
            return rng.integers(self.barcodes, size=n)
        base = self.barcodes // self.variants.size
        orbits = self.library // self.variants.size
        return rng.integers(self.variants.size, size=n) * base + rng.integers(orbits, size=n)

    def remap(self, variant: np.ndarray, decoded: np.ndarray) -> np.ndarray:
        """The decision under map `variant` (per read) of a read decoded as
        `decoded` (1-based panel rows, 0 unclassified)."""
        if self.variants is None:
            return decoded
        base = self.barcodes // self.variants.size
        row = np.maximum(decoded, 1) - 1
        mapped = self.variants.compose[variant, row // base] * base + row % base + 1
        return np.where(decoded > 0, mapped, 0)


@dataclass
class Instrument:
    segments: list[int]
    decoders: list[Decoder] = field(default_factory=list)

    def pamld(self) -> list[Decoder]:
        return [d for d in self.decoders if d.algorithm == "pamld"]

    def varied(self) -> Decoder | None:
        return next((d for d in self.decoders if d.variants is not None), None)

    def variant(self, replay):
        """The map of replay(s) `replay`: 0, the identity, where nothing varies."""
        varied = self.varied()
        return replay % varied.variants.size if varied is not None else replay * 0


def instrument(config: dict, seed: int, plan: dict | None = None) -> Instrument:
    """The configuration's decoders with their panels drawn from `seed`;
    the one that the traffic mix `plan` varies (``vary``: its role, its
    rotations and the barcodes its reads come from) drawn closed under its
    maps: the first decoder of that role, and no other."""
    vary = (plan or {}).get("vary")
    varied = None
    if vary is not None:
        roles = [entry["role"] for entry in config["decoders"]]
        if vary["role"] not in roles:
            raise ValueError(f"no {vary['role']} decoder for the traffic to vary")
        varied = roles.index(vary["role"])
    rng = np.random.default_rng([seed, 1])
    decoders = []
    for at, entry in enumerate(config["decoders"]):
        decoder = Decoder(entry["role"], entry["algorithm"], entry["tokens"], entry)
        if at == varied:
            if decoder.algorithm != "pamld" or len(decoder.tokens) != 1:
                raise ValueError("a varied decoder is a PAMLD decoder over one token")
            decoder.variants = Variants(decoder.width, vary["rotations"])
            decoder.words = closed_words(rng, entry["barcodes"], decoder.variants)
            decoder.library = vary["barcodes"]
            if decoder.library % decoder.variants.size or decoder.library > decoder.barcodes:
                raise ValueError("a varied decoder's library is whole orbits of its panel")
        elif decoder.algorithm == "pamld":
            decoder.words = unique_words(rng, entry["barcodes"], decoder.width)
        elif decoder.algorithm != "naive":
            raise ValueError(f"unknown algorithm {decoder.algorithm!r}")
        decoders.append(decoder)
    return Instrument(list(config["segments"]), decoders)


def _decoder_json(decoder: Decoder, index: int, codec: str) -> dict:
    """A decoder's entry of the instruction, `codec` standing in for its
    codec (PAMLD only), which ``_codec_chunks`` renders."""
    spec = decoder.spec
    out = {"algorithm": decoder.algorithm, "index": index,
           "transform": {"token": [token_string(t) for t in decoder.tokens]}}
    if decoder.algorithm != "pamld":
        return out
    out["codec"] = codec
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


def sorted_keys(count: int) -> tuple[np.ndarray, np.ndarray]:
    """1..count in the order of their decimal strings ("1", "10", "100",
    ..., "2", ...), and how many digits each has: a codec is a JSON
    object, the program takes its barcodes in the order of their sorted
    keys, which decides a tie, and the panel's row i gets the i-th key in
    that order."""
    numbers = np.arange(1, count + 1, dtype=np.int64)
    width = len(str(count))
    places = np.ones(count, dtype=np.int64)
    for power in range(1, width):
        places += numbers >= 10 ** power
    # two keys' strings compare as their digits padded with zeros to the
    # width do, the shorter (a prefix of the other) first
    order = np.argsort(numbers * 10 ** (width - places) * (width + 1) + places)
    return numbers[order], places[order]


def _codec_chunks(decoder: Decoder, rows: int = 1 << 19):
    """The decoder's codec as json.dumps writes it, in pieces of `rows`
    barcodes: ``{"<key>": {"barcode": [<token strings>], "concentration":
    <c>, "index": <key>}, ...}``, its keys sorted as strings. Each piece
    is a matrix of fixed-width rows, blank key digits taken out."""
    count = decoder.barcodes
    if count == 0:
        yield b"{}"
        return
    keys, places = sorted_keys(count)
    width = len(str(count))
    text = LETTERS[decoder.words]
    pieces = [b'"', width, b'": {"barcode": [']
    at = 0
    for k, (_, start, end) in enumerate(decoder.tokens):
        pieces += [b", " if k else b"", b'"', (at, at + end - start), b'"']
        at += end - start
    pieces += [b'], "concentration": ' + repr(decoder.concentration()).encode() + b', "index": ', width,
               b"}", b", "]
    layout, slots, columns = [], [], []
    for piece in pieces:
        begin = sum(len(x) for x in layout)
        if isinstance(piece, bytes):
            layout.append(np.frombuffer(piece, dtype=np.uint8))
        elif isinstance(piece, int):  # a key's digits
            slots.append(begin)
            layout.append(np.zeros(piece, dtype=np.uint8))
        else:  # a token's bases
            columns.append((begin, piece))
            layout.append(np.zeros(piece[1] - piece[0], dtype=np.uint8))
    template = np.concatenate(layout)
    yield b"{"
    for lo in range(0, count, rows):
        hi = min(count, lo + rows)
        n = hi - lo
        block = np.tile(template, (n, 1))
        keep = np.ones(block.shape, dtype=bool)
        # the keys' digits left-aligned: those of the keys padded with zeros
        left = digits(keys[lo:hi] * 10 ** (width - places[lo:hi]), width)
        blank = np.arange(width) >= places[lo:hi, None]
        for slot in slots:
            block[:, slot:slot + width] = left
            keep[:, slot:slot + width] = ~blank
        for begin, (a, b) in columns:
            block[:, begin:begin + b - a] = text[lo:hi, a:b]
        if hi == count:
            keep[-1, -2:] = False
        yield block[keep].tobytes()
    yield b"}"


def instruction_chunks(inst: Instrument, inputs: list[str], output: str, report: str):
    """The program's instruction (the shape of ``benchmark.instruction``):
    reads from `inputs`, segment 0 out as one SAM record, the report to
    `report`, as the bytes of json.dumps of it, in pieces: a whitelist's
    codec is rendered by NumPy, never held as objects."""
    body: dict = {
        "input": list(inputs),
        "template": {"transform": {"token": ["0::"]}},
        "output": [output],
        "report url": report,
    }
    # json.dumps writes all but the codecs, each a marker string in its place
    codecs = {}
    for index, decoder in enumerate(inst.decoders, start=1):
        marker = f"\0codec {index}"
        entry = _decoder_json(decoder, index, marker)
        if "codec" in entry:
            codecs[json.dumps(marker)] = decoder
        if decoder.role == "sample":
            body["sample"] = entry
        else:
            body.setdefault(decoder.role, []).append(entry)
    text = json.dumps(body)
    at = 0
    for marker, decoder in sorted(codecs.items(), key=lambda item: text.index(item[0])):
        found = text.index(marker)
        yield text[at:found].encode()
        yield from _codec_chunks(decoder)
        at = found + len(marker)
    yield text[at:].encode()


def write_instruction(path: str, inst: Instrument, inputs: list[str], output: str, report: str):
    with open(path, "wb") as stream:
        for chunk in instruction_chunks(inst, inputs, output, report):
            stream.write(chunk)


def instruction_text(inst: Instrument, inputs: list[str], output: str, report: str) -> str:
    return b"".join(instruction_chunks(inst, inputs, output, report)).decode()


@dataclass
class Batch:
    """One pool batch: each segment's rendered FASTQ records, and what the
    reference needs of the reads (each decoder's observation)."""

    records: list[np.ndarray]  # per segment, (n, 21 + 2w) uint8
    observations: list[tuple[np.ndarray, np.ndarray]]  # per decoder, (code, qual)


def synthetic_reads(inst: Instrument, n: int, rng: np.random.Generator, error_rate: float):
    """(codes, quals): per segment (n, w) uint8 BAM codes and RTA3-binned
    qualities. Each PAMLD decoder's barcode is drawn uniformly from its
    panel (or its library) and written, with substitution errors, over its
    tokens; every other base is random with qualities 20-40."""
    codes = [BASE_CODES[rng.integers(4, size=(n, w))] for w in inst.segments]
    quals = [rng.integers(20, 41, size=(n, w)).astype(np.uint8) for w in inst.segments]
    for decoder in inst.pamld():
        drawn = decoder.codes[decoder.draw(rng, n)]
        qual = rng.integers(12, 41, size=drawn.shape).astype(np.uint8)
        err = rng.random(drawn.shape) < error_rate
        sub = BASE_CODES[rng.integers(4, size=drawn.shape)]
        code = np.where(err, sub, drawn).astype(np.uint8)
        qual = np.where(err, rng.integers(2, 20, size=drawn.shape), qual).astype(np.uint8)
        at = 0
        for segment, start, end in decoder.tokens:
            codes[segment][:, start:end] = code[:, at:at + end - start]
            quals[segment][:, start:end] = qual[:, at:at + end - start]
            at += end - start
    return codes, [rta3_bin(q) for q in quals]


def observation(decoder: Decoder, codes, quals) -> tuple[np.ndarray, np.ndarray]:
    """A decoder's (code, qual) observation: its tokens side by side."""
    code = np.hstack([codes[s][:, a:b] for s, a, b in decoder.tokens])
    qual = np.hstack([quals[s][:, a:b] for s, a, b in decoder.tokens])
    return np.ascontiguousarray(code), np.ascontiguousarray(qual)


def digits(values: np.ndarray, width: int) -> np.ndarray:
    """(n, width) ASCII digits of non-negative integers."""
    out = np.empty((values.shape[0], width), dtype=np.uint8)
    rest = values.astype(np.int64)
    for column in range(width - 1, -1, -1):
        out[:, column] = 48 + rest % 10
        rest //= 10
    return out


def render(code: np.ndarray, qual: np.ndarray, first: int) -> np.ndarray:
    """Fixed-width FASTQ records of reads `first`.. of the pool, replay 0."""
    n, w = code.shape
    rows = np.empty((n, 21 + 2 * w), dtype=np.uint8)
    rows[:, 0] = ord("@")
    rows[:, 1] = ord("r")
    rows[:, REPLAY_AT:REPLAY_AT + REPLAY_DIGITS] = ord("0")
    rows[:, 8] = ord("i")
    rows[:, 9:16] = digits(np.arange(first, first + n), INDEX_DIGITS)
    rows[:, 16] = 10
    rows[:, 17:17 + w] = CODE_TO_ASCII[code]
    rows[:, 17 + w] = 10
    rows[:, 18 + w] = ord("+")
    rows[:, 19 + w] = 10
    rows[:, 20 + w:20 + 2 * w] = qual + 33
    rows[:, 20 + 2 * w] = 10
    return rows


def pool(inst: Instrument, traffic: dict, seed: int) -> list[Batch]:
    """The cell's pool: `pool_batches` distinct batches of `batch_size`
    reads, each drawn from its own stream of `seed`."""
    n = traffic["batch_size"]
    if traffic["pool_batches"] * n >= 10 ** INDEX_DIGITS:
        raise ValueError("the pool holds more reads than a name can number")
    batches = []
    for p in range(traffic["pool_batches"]):
        rng = np.random.default_rng([seed, 2, p])
        codes, quals = synthetic_reads(inst, n, rng, traffic["error_rate"])
        batches.append(Batch(
            [render(c, q, p * n) for c, q in zip(codes, quals)],
            [observation(d, codes, quals) for d in inst.decoders],
        ))
    return batches


def set_replay(rows: np.ndarray, replay: int):
    """Rewrite the replay digits of every record of a rendered batch."""
    if replay >= 10 ** REPLAY_DIGITS:
        raise ValueError("replay count passes the name's digits")
    rows[:, REPLAY_AT:REPLAY_AT + REPLAY_DIGITS] = digits(np.array([replay]), REPLAY_DIGITS)[0]


def vary_rows(rows: np.ndarray, decoder: Decoder, v: int) -> np.ndarray:
    """A copy of a segment's rendered records with the varied decoder's
    token (bases and qualities) written through map v."""
    if v == 0:
        return rows
    _, start, end = decoder.tokens[0]
    w = (rows.shape[1] - 21) // 2
    out = rows.copy()
    bases = ASCII_TO_INDEX[rows[:, 17 + start:17 + end]]
    out[:, 17 + start:17 + end] = LETTERS[decoder.variants.apply(v, bases)]
    out[:, 20 + w + start:20 + w + end] = np.roll(rows[:, 20 + w + start:20 + w + end],
                                                  decoder.variants.shift(v), axis=1)
    return out


class Stream:
    """What the pipes carry: batch j of a segment is pool batch j % P in
    replay j // P, its names numbered for the replay and, where the mix
    varies a decoder, that decoder's token written through the replay's
    map."""

    def __init__(self, inst: Instrument, batches: list[Batch]):
        self.inst = inst
        self.batches = batches
        self.varied = inst.varied()

    def records(self, j: int, segment: int) -> np.ndarray:
        """Batch j of `segment` as written. Rewrites the pool's replay
        digits in place: one thread a segment."""
        replay = j // len(self.batches)
        rows = self.batches[j % len(self.batches)].records[segment]
        set_replay(rows, replay)
        if self.varied is not None and self.varied.tokens[0][0] == segment:
            rows = vary_rows(rows, self.varied, self.inst.variant(replay))
        return rows


def parse_name(name: bytes) -> tuple[int, int]:
    """(replay, pool index) of a read name."""
    return int(name[1:1 + REPLAY_DIGITS]), int(name[2 + REPLAY_DIGITS:])
