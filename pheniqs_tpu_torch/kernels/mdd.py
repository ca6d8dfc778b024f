"""K6: the MDD classify of one decoder (csrc/mdd.cu).

``mdd_classify`` decides, per read, by minimum distance decoding: the
first barcode that matches exactly, else the first barcode in codec order
whose per-segment errors are within the decoder's distance tolerance (not
the closest), with that barcode's total error as the distance. On a CUDA
tensor it launches the kernel; on a CPU tensor it runs the plain version
below, the torch port of ``pheniqs_tpu.device.classify.mdd_classify_device``.
Both are integer-only, so they agree byte for byte with each other and
with the f64 oracle (``pheniqs_tpu.decode.oracle.mdd_classify``).

The kernel resolves exact matches by a lookup in the decoder's key table
(``key_table``, built once at set-up) and scans the panel, a warp at a
time, only for the other reads; ``mdd_classify_two_phase`` is that
algorithm in torch, for the tests. It takes any number of segments (its
segment table, ``segment_table``, is a device array made once per decoder)
and any width: up to 64 positions an instance keeps a read in registers;
past it the wide instance stages a warp's pending reads as bit planes and
scans (read, barcode) pairs against the panel's planes, which the key
table carries (``key_table``).
"""

from __future__ import annotations

import numpy as np
import torch

#: launches of the CUDA kernel in this process
launches = 0
#: the dynamic shared memory a block may take on the H100, by opt-in, and
#: the shares of it the key table and the segment table may take
#: (csrc/mdd.cu PHQ_MDD_SMEM_MAX, PHQ_MDD_SHARED_TABLE,
#: PHQ_MDD_SHARED_SEGMENTS); the warps of a block (PHQ_MDD_WARPS)
SHARED_LIMIT = 227 * 1024
SHARED_TABLE = 40 * 1024
SHARED_SEGMENTS = 8 * 1024
WARPS = 8
#: the wide instance (past 64 positions): the most reads a warp stages at
#: once (PHQ_MDD_BATCH_MAX), and the shared bytes its block's batches may
#: take before the batch shrinks (to one read at the least)
BATCH_MAX = 32
BATCH_BYTES = 48 * 1024
#: the widest observation of the register instances
REGISTER_WIDTH = 64


def key_words(w: int) -> int:
    """The 32-bit words the kernel packs a W-position observation into
    (NW: its register instances take 4, 8 or 16; past 64 positions the
    wide instance takes whole 16-position runs)."""
    for nw in (4, 8, 16):
        if w <= 4 * nw:
            return nw
    return 4 * -(-w // 16)


def mask_words(w: int) -> int:
    """The 64-bit words of a segment's position mask in the segment table:
    one up to 64 positions, none past it (the wide instance counts on each
    segment's range)."""
    return 1 if w <= REGISTER_WIDTH else 0


def groups(w: int) -> int:
    """The wide instance's groups of 32 positions."""
    return -(-w // 32)


def panel_planes(panel_codes) -> int:
    """The bit planes of a panel in the key table past 64 positions: 4
    where every code is below 16 (the IUPAC codes), else 8."""
    return 4 if int(np.asarray(panel_codes).max(initial=0)) < 16 else 8


def decoder_planes(dec) -> int:
    """The bit planes of a decoder's key table past 64 positions (from its
    size), 4 where it has none yet."""
    w, b = sum(dec.segment_widths), dec.barcode_count
    if dec.key_table is None or w <= REGISTER_WIDTH:
        return 4
    return (dec.key_table.numel() - 2 * b * key_words(w) - 4 * -(-b // 4)) // (groups(w) * b)


def read_words(w: int, planes: int) -> int:
    """The words of a read the wide instance stages (csrc/mdd.cu
    PhqWideRead): per group 8 (4 planes, the OR of its codes' high bits,
    its in-range and low-quality masks, a pad word) or 12 (8 planes, the
    masks, two pad words), then its result, distance, row and a pad."""
    return groups(w) * (8 if planes == 4 else 12) + 4


def batch_reads(w: int, planes: int) -> int:
    """The reads a warp of the wide instance stages at once: BATCH_MAX
    where a block's batches fit BATCH_BYTES, fewer where they do not, one
    at the least."""
    read = 4 * read_words(w, planes)
    return max(1, min(BATCH_MAX, BATCH_BYTES // (WARPS * read)))


def shared_bytes(barcodes: int, widths, planes: int = 4) -> int:
    """The dynamic shared bytes of K6's block for a decoder of `barcodes`
    barcodes (of `planes` bit planes past 64 positions) and observation
    segments `widths` (csrc/mdd.cu phq_mdd): past 64 positions each
    warp's batch of staged reads (a byte a position at one read a batch),
    and the part of the key table its instance reads and the segment table
    where each fits its share and beside the batches. Past SHARED_LIMIT,
    from 29,025 positions at any number of barcodes, no block holds it."""
    w = sum(widths)
    nw = key_words(w)
    index = 4 * -(-barcodes // 4)
    if w > REGISTER_WIDTH:
        table = 4 * (barcodes * nw + index + groups(w) * planes * barcodes)
    else:
        table = 4 * (2 * barcodes * nw + index)
    segments = 4 * len(widths) * (4 + 2 * mask_words(w))
    buffers = WARPS * 4 * batch_reads(w, planes) * read_words(w, planes) if w > REGISTER_WIDTH else 0
    table = table if table <= SHARED_TABLE and table + buffers <= SHARED_LIMIT else 0
    segments = 16 * -(-segments // 16)
    segments = segments if segments <= SHARED_SEGMENTS and table + segments + buffers <= SHARED_LIMIT else 0
    return table + segments + buffers


def segment_table(widths, tolerance) -> np.ndarray:
    """K6's segment table of a decoder's observation segments `widths`
    (side by side) and their distance `tolerance`: per segment one row of
    int32 (start, width, tolerance, 0) followed by its position mask as
    mask_words little-endian 64-bit words."""
    w = sum(widths)
    mw = mask_words(w)
    rows = np.zeros((len(widths), 4 + 2 * mw), dtype=np.int32)
    start = 0
    for s, (width, tol) in enumerate(zip(widths, tolerance)):
        rows[s, :3] = start, width, tol
        bits = ((1 << width) - 1) << start
        for m in range(mw):
            rows[s, 4 + 2 * m : 6 + 2 * m] = np.array([(bits >> (64 * m)) & (2**64 - 1)], dtype=np.uint64).view(
                np.int32)
        start += width
    return rows.reshape(-1)


_SEGMENT_TABLES: dict = {}


def _device_segments(dec, device) -> torch.Tensor:
    """The decoder's segment table on `device`, made once."""
    widths = tuple(dec.segment_widths)
    tolerance = tuple(dec.distance_tolerance or (0,) * len(widths))
    key = (widths, tolerance, str(device))
    if key not in _SEGMENT_TABLES:
        _SEGMENT_TABLES[key] = torch.from_numpy(segment_table(widths, tolerance)).to(device)
    return _SEGMENT_TABLES[key]


def pack_words(codes, nw: int):
    """(N, W) codes (uint8 or integer) -> (N, nw) int64 words, position
    4k + j in byte j of word k, zero past W: the kernel's packing of a
    read and of the panel."""
    codes = torch.as_tensor(codes).to(torch.int64)
    n, w = codes.shape
    padded = torch.zeros((n, 4 * nw), dtype=torch.int64, device=codes.device)
    padded[:, :w] = codes
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=codes.device)
    return (padded.view(n, nw, 4) << shifts).sum(dim=2)


def key_table(codes: np.ndarray) -> np.ndarray:
    """K6's key table of a (B, W) panel of codes, one flat int32 array:
    the B x NW panel words in codec order, the same keys sorted by (words
    in order, word 0 first as unsigned, then barcode index), and the
    0-based barcode index of each sorted key, padded to whole 16-byte
    words. With duplicated barcodes the lowest index sorts first, so a
    lower-bound search finds it. Past 64 positions the panel's bit planes
    follow (plane_words), [group][barcode][plane], which the wide instance
    scans."""
    codes = np.asarray(codes)
    b, w = codes.shape
    nw = key_words(w)
    words = pack_words(torch.from_numpy(codes.astype(np.int64)), nw).numpy().astype(np.uint32)
    order = np.lexsort([np.arange(b)] + [words[:, k] for k in reversed(range(nw))])
    index = np.zeros(-(-b // 4) * 4, dtype=np.int32)
    index[:b] = order
    parts = [words.ravel().view(np.int32), words[order].ravel().view(np.int32), index]
    if w > REGISTER_WIDTH:
        parts.append(plane_words(codes, panel_planes(codes)).transpose(0, 2, 1).ravel().view(np.int32))
    return np.concatenate(parts)


def plane_words(codes, planes: int) -> np.ndarray:
    """(G, planes, N) uint32 bit planes of (N, W) codes: bit j of word
    [g, q, i] is bit q of the code at position 32g + j of row i (zero past
    W)."""
    codes = np.asarray(codes).astype(np.uint32)
    n, w = codes.shape
    g = groups(w)
    padded = np.zeros((n, 32 * g), dtype=np.uint32)
    padded[:, :w] = codes
    bits = (padded.reshape(n, g, 32, 1) >> np.arange(planes, dtype=np.uint32)) & 1
    words = (bits << np.arange(32, dtype=np.uint32)[:, None]).sum(axis=2, dtype=np.uint64).astype(np.uint32)
    return np.ascontiguousarray(words.transpose(1, 2, 0))


def key_table_tensor(panel_codes_u8: torch.Tensor) -> torch.Tensor:
    """``key_table`` of a decoder's (B, W) uint8 panel, on its device."""
    return torch.from_numpy(key_table(panel_codes_u8.cpu().numpy())).to(panel_codes_u8.device)


def table_parts(table, b: int, nw: int):
    """(words (B, NW), sorted keys (B, NW), sorted index (B,)), all int64,
    of a key table."""
    flat = torch.as_tensor(table).cpu().to(torch.int64) & 0xFFFFFFFF
    words = flat[: b * nw].view(b, nw)
    keys = flat[b * nw : 2 * b * nw].view(b, nw)
    return words, keys, flat[2 * b * nw : 2 * b * nw + b]


def table_planes(table, b: int, w: int):
    """(G, planes, B) int64 bit planes of a key table past 64 positions
    (stored [group][barcode][plane])."""
    flat = torch.as_tensor(table).cpu().to(torch.int64) & 0xFFFFFFFF
    at = 2 * b * key_words(w) + 4 * -(-b // 4)
    return flat[at:].view(groups(w), b, -1).transpose(1, 2)


def key_order(keys, words):
    """-1, 0 or 1 per row as `keys` (N, NW) sort before, equal to or after
    `words` (N, NW), word 0 first."""
    differs = keys != words
    first = torch.argmax(differs.to(torch.uint8), dim=1)[:, None]
    before = torch.gather(keys, 1, first)[:, 0] < torch.gather(words, 1, first)[:, 0]
    return torch.where(differs.any(dim=1), torch.where(before, -1, 1), 0)


def lookup(keys, index, words):
    """The first barcode (0-based) whose key equals each row of `words`
    (N, NW), else -1: the lower bound of the sorted keys, as the kernel
    searches it."""
    b = keys.shape[0]
    n = words.shape[0]
    lo = torch.zeros(n, dtype=torch.int64)
    hi = torch.full((n,), b, dtype=torch.int64)
    while bool((lo < hi).any()):
        searching = lo < hi
        mid = (lo + hi) // 2
        before = key_order(keys[mid.clamp(max=b - 1)], words) < 0
        lo = torch.where(searching & before, mid + 1, lo)
        hi = torch.where(searching & ~before, mid, hi)
    at = lo.clamp(max=b - 1)
    found = (lo < b) & (key_order(keys[at], words) == 0)
    return torch.where(found, index[at], -1)


def nonzero_nibbles(x):
    """One bit per nonzero byte of each 32-bit word in `x` (int64), in
    byte order: the kernel's mismatch test."""
    high = (((x & 0x7F7F7F7F) + 0x7F7F7F7F) | x) & 0x80808080
    return (((high >> 7) * 0x00204081) >> 21) & 15


def mdd_classify_two_phase(dec, obs_code, obs_qual, lengths, qcfail_in) -> dict:
    """K6's algorithm in torch (CPU; for the tests): the reads at full
    length look their packed key up in the decoder's key table, a hit
    being the first exact match; every other read takes the first barcode
    in codec order within tolerance, its errors counted as the kernel
    counts them: from the packed words up to 64 positions, past it from
    the key table's bit planes (the read's 8 planes; with a 4-plane panel
    any code of 16 or more a mismatch), each read's first barcode found
    in the wide instance's order (pair_walk). The results of
    ``mdd_classify_plain`` plus ``exact``, the reads the lookup resolved."""
    n, w = obs_code.shape
    b = dec.barcode_count
    nw = key_words(w)
    words, keys, index = table_parts(dec.key_table, b, nw)
    widths = list(dec.segment_widths)
    tolerance = dec.distance_tolerance or tuple(0 for _ in widths)
    starts = np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(int)
    lengths = lengths.cpu().to(torch.int64)
    read = pack_words(obs_code.cpu(), nw)
    full = (lengths == torch.tensor(widths)).all(dim=1)
    result = torch.full((n,), -1, dtype=torch.int64)
    exact = torch.zeros(n, dtype=torch.bool)
    if bool(full.any()):
        rows = full.nonzero()[:, 0]
        found = lookup(keys, index, read[rows])
        result[rows] = found
        exact[rows] = found >= 0
    distance = torch.zeros(n, dtype=torch.int64)
    pending = (~exact).nonzero()[:, 0]
    m = pending.numel()
    span = 4 * nw if w <= REGISTER_WIDTH else 32 * groups(w)
    positions = torch.arange(span)
    segment = torch.full((span,), -1, dtype=torch.int64)
    for s, (start, width) in enumerate(zip(starts, widths)):
        segment[start : start + width] = s
    in_range = torch.zeros((m, span), dtype=torch.bool)
    for s, (start, width) in enumerate(zip(starts, widths)):
        length = lengths[pending, s].clamp(0, width)
        in_range |= (positions >= start) & (positions < start + length[:, None])
    quality = torch.zeros((m, span), dtype=torch.int64)
    quality[:, :w] = obs_qual.cpu()[pending].to(torch.int64)
    low = in_range & (quality < dec.quality_masking_threshold)
    if w <= REGISTER_WIDTH:
        # (pending, B, NW) words of read ^ barcode, their nonzero bytes as
        # position bits
        nibbles = nonzero_nibbles(read[pending][:, None, :] ^ words[None, :, :])
        mismatch = ((nibbles[..., None] >> torch.arange(4)) & 1).bool().view(m, b, span)
    else:
        # (G, pending, B) words of the planes' XORs, one bit a position
        panel = table_planes(dec.key_table, b, w)
        planes = panel.shape[1]
        mine = torch.from_numpy(plane_words(obs_code.cpu()[pending].numpy(), 8).astype(np.int64))
        words32 = torch.zeros((groups(w), m, b), dtype=torch.int64)
        for q in range(planes):
            words32 |= mine[:, q, :, None] ^ panel[:, q, None, :]
        if planes == 4:
            words32 |= (mine[:, 4] | mine[:, 5] | mine[:, 6] | mine[:, 7])[:, :, None]
        mismatch = ((words32[..., None] >> torch.arange(32)) & 1).bool().permute(1, 2, 0, 3).reshape(m, b, span)
    errors = (mismatch & in_range[:, None, :]) | low[:, None, :]
    within = torch.ones((m, b), dtype=torch.bool)
    total = torch.zeros((m, b), dtype=torch.int64)
    for s in range(len(widths)):
        count = (errors & (segment == s)).sum(dim=2)
        within &= count <= tolerance[s]
        total += count
    if w <= REGISTER_WIDTH:
        any_within = within.any(dim=1)
        first = torch.argmax(within.to(torch.uint8), dim=1)
    else:
        first = pair_walk(within, batch_reads(w, panel.shape[1]))
        any_within = first >= 0
        first = first.clamp(min=0)
    result[pending] = torch.where(any_within, first, -1)
    distance[pending] = torch.where(any_within, torch.gather(total, 1, first[:, None])[:, 0], 0)
    decoded = (result + 1).to(torch.int32)
    return {
        "decoded": decoded,
        "confidence": torch.zeros(n, dtype=torch.float32),
        "distance": distance.to(torch.int32),
        "qcfail": qcfail_in.cpu() | (decoded == 0),
        "branch": torch.zeros(n, dtype=torch.int8),
        "argmax": decoded.clone(),
        "exact": exact,
    }


def pair_walk(within, batch: int, lanes: int = 32):
    """The wide instance's scan order over a warp's pending reads (rows of
    `within`, (M, B) bool: the pair within every segment's tolerance): a
    batch of `batch` reads at a time, their (read, barcode) pairs in order,
    `lanes` a round; a read's first hit in a round is its lowest lane that
    hits, and a round whose last read hit moves on to the next read.
    Returns each read's first barcode within tolerance, -1 for none (the
    first True of its row, whatever the order)."""
    m, b = within.shape
    flat = within.reshape(-1).tolist()
    first = [-1] * m
    for k0 in range(0, m, batch):
        kb = min(batch, m - k0)
        pairs, pos = kb * b, 0
        while pos < pairs:
            hits = [pos + lane < pairs and flat[k0 * b + pos + lane] for lane in range(lanes)]
            for lane in range(lanes):
                k, bc = divmod(pos + lane, b)
                low = max(k * b - pos, 0)
                if hits[lane] and not any(hits[low:lane]):
                    first[k0 + k] = bc
            k_last = min(pos + lanes - 1, pairs - 1) // b
            pos = (k_last + 1) * b if any(hits[max(k_last * b - pos, 0):]) else pos + lanes
    return torch.tensor(first, dtype=torch.int64)


def mdd_classify_plain(dec, obs_code, obs_qual, lengths, qcfail_in) -> dict:
    """``obs_code``/``obs_qual`` (N, W) integer tensors, the observation
    segments side by side in ``dec.segment_widths`` order; ``lengths``
    (N, S) the in-read length of each segment. Returns (N,) tensors:
    decoded, argmax (= decoded), distance (int32), branch (int8, PASS),
    confidence (f32, 0) and the chained qcfail."""
    n = obs_code.shape[0]
    device = obs_code.device
    b = dec.barcode_count
    tolerance = dec.distance_tolerance or tuple(0 for _ in dec.segment_widths)
    within = torch.ones((n, b), dtype=torch.bool, device=device)
    exact = torch.ones((n, b), dtype=torch.bool, device=device)
    total_error = torch.zeros((n, b), dtype=torch.int32, device=device)
    offset = 0
    for s, ws in enumerate(dec.segment_widths):
        code = obs_code[:, offset : offset + ws].to(torch.int32)
        quality = obs_qual[:, offset : offset + ws].to(torch.int32)
        codes = dec.panel_codes[:, offset : offset + ws]  # (B, Ws)
        offset += ws
        length = lengths[:, s].to(torch.int32)
        in_range = torch.arange(ws, device=device)[None, :] < length[:, None]  # (N, Ws)
        mismatch = (code[:, None, :] != codes[None, :, :]) & in_range[:, None, :]
        mismatches = mismatch.sum(dim=2, dtype=torch.int32)
        if dec.quality_masking_threshold > 0:
            masked = (quality < dec.quality_masking_threshold) & in_range
            errors = (mismatch | masked[:, None, :]).sum(dim=2, dtype=torch.int32)
        else:
            errors = mismatches
        within &= errors <= tolerance[s]
        total_error += errors
        exact &= (length[:, None] == ws) & (mismatches == 0)

    exact_any = exact.any(dim=1)
    exact_first = torch.argmax(exact.to(torch.uint8), dim=1)  # first True
    scan_any = within.any(dim=1)
    scan_first = torch.argmax(within.to(torch.uint8), dim=1)
    decoded = torch.where(
        exact_any, exact_first + 1, torch.where(scan_any, scan_first + 1, 0)
    ).to(torch.int32)
    distance = torch.where(
        ~exact_any & scan_any,
        torch.gather(total_error, 1, scan_first[:, None])[:, 0],
        0,
    ).to(torch.int32)
    return {
        "decoded": decoded,
        "confidence": torch.zeros(n, dtype=torch.float32, device=device),
        "distance": distance,
        "qcfail": qcfail_in | (decoded == 0),
        "branch": torch.zeros(n, dtype=torch.int8, device=device),
        "argmax": decoded.clone(),
    }


def _ints(dec, n: int, ld_obs: int, ld_len: int) -> np.ndarray:
    """csrc/mdd.cu PhqMddParams; past 64 positions the panel's planes (from
    the key table's size) and the reads a warp stages at once."""
    widths = list(dec.segment_widths)
    w, b = sum(widths), dec.barcode_count
    planes = batch = 0
    if w > REGISTER_WIDTH:
        planes = decoder_planes(dec)
        batch = batch_reads(w, planes)
    return np.array([n, b, w, len(widths), ld_obs, ld_len, dec.quality_masking_threshold, key_words(w), planes,
                     batch], dtype=np.int32)


def mdd_classify(dec, obs_code, obs_qual, lengths, qcfail_in, *, out=None) -> dict:
    """K6 for one MDD decoder. On CUDA, ``obs_code``/``obs_qual`` are (N, W)
    uint8 rows of unit column stride and ``lengths`` (N, S) int32 of unit
    column stride (views into the unpack outputs are fine); ``out`` receives
    the results in place (the decode step's stacked rows)."""
    if obs_code.device.type == "cpu":
        result = mdd_classify_plain(dec, obs_code, obs_qual, lengths, qcfail_in)
        if out is not None:
            for key, value in result.items():
                out[key].copy_(value)
            return out
        return result
    if obs_code.device.type != "cuda":
        raise ValueError(f"mdd_classify: unsupported device {obs_code.device}")
    global launches
    from .build import library
    from .pamld import empty_result

    n, w = obs_code.shape
    segments = len(dec.segment_widths)
    if w != sum(dec.segment_widths):
        raise ValueError(f"mdd_classify: an observation of {w} positions for segments of {dec.segment_widths}")
    for name, t in (("obs_code", obs_code), ("obs_qual", obs_qual)):
        if t.dtype != torch.uint8 or t.stride(1) != 1 or t.stride(0) != obs_code.stride(0):
            raise ValueError(f"mdd_classify: {name} must be uint8 rows of unit column stride")
    if lengths.dtype != torch.int32 or lengths.shape != (n, segments) or lengths.stride(1) != 1:
        raise ValueError("mdd_classify: lengths must be (N, S) int32 of unit column stride")
    if qcfail_in.dtype != torch.bool or qcfail_in.shape[0] != n or not qcfail_in.is_contiguous():
        raise ValueError("mdd_classify: qcfail_in must be contiguous (N,) bool")
    if dec.key_table is None or dec.key_table.device != obs_code.device:
        raise ValueError("mdd_classify: the decoder's key table must lie on the observation's device")
    if out is None:
        out = empty_result(n, obs_code.device)
    stream = torch.cuda.current_stream(obs_code.device).cuda_stream
    _launch(library(), dec, obs_code, obs_qual, lengths, qcfail_in, out, stream)
    launches += 1
    return {k: v for k, v in out.items() if k != "uncertain"}


def _launch(lib, dec, obs_code, obs_qual, lengths, qcfail_in, out, stream):
    """Run the kernel of `lib` (no device checks, no count)."""
    from .build import check

    ints = _ints(dec, obs_code.shape[0], obs_code.stride(0), lengths.stride(0))
    status = lib.phq_mdd(
        ints.ctypes.data, obs_code.data_ptr(), obs_qual.data_ptr(),
        lengths.data_ptr(), qcfail_in.data_ptr(), dec.key_table.data_ptr(),
        _device_segments(dec, obs_code.device).data_ptr(), out["decoded"].data_ptr(), out["argmax"].data_ptr(),
        out["distance"].data_ptr(), out["branch"].data_ptr(),
        out["confidence"].data_ptr(), out["qcfail"].data_ptr(), stream,
    )
    check(status, "mdd_classify")
