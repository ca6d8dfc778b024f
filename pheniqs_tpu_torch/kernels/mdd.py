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
and any width: up to 128 positions an instance keeps a read in registers,
past it the looped instance stages it in shared memory.
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


def key_words(w: int) -> int:
    """The 32-bit words the kernel packs a W-position observation into
    (NW: its register instances take 4, 8, 16 or 32; past 128 positions
    the looped instance takes whole 16-position runs)."""
    for nw in (4, 8, 16, 32):
        if w <= 4 * nw:
            return nw
    return 4 * -(-w // 16)


def mask_words(w: int) -> int:
    """The 64-bit words of a segment's position mask in the segment table
    (csrc/mdd.cu phq_mdd_mask_words): one up to 64 positions, two up to
    128, none for the looped instance (it counts on each segment's range)."""
    nw = key_words(w)
    return 1 if nw <= 16 else 2 if nw == 32 else 0


def shared_bytes(barcodes: int, widths) -> int:
    """The dynamic shared bytes of K6's block for a decoder of `barcodes`
    barcodes and observation segments `widths` (csrc/mdd.cu phq_mdd): the
    key table and the segment table where each fits its share, and past
    128 positions each warp's staged read (10 bytes a position). Past
    SHARED_LIMIT, from 19,361 positions (one barcode) or 23,233, no block
    holds it."""
    w = sum(widths)
    nw = key_words(w)
    table = 4 * (2 * barcodes * nw + 4 * -(-barcodes // 4))
    segments = 4 * len(widths) * (4 + 2 * mask_words(w))
    total = (table if table <= SHARED_TABLE else 0) + (16 * -(-segments // 16) if segments <= SHARED_SEGMENTS else 0)
    if w > 128:
        total += WARPS * 4 * (nw + 4 * ((4 * nw + 63) // 64))
    return total


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
    lower-bound search finds it."""
    codes = np.asarray(codes)
    b, w = codes.shape
    nw = key_words(w)
    words = pack_words(torch.from_numpy(codes.astype(np.int64)), nw).numpy().astype(np.uint32)
    order = np.lexsort([np.arange(b)] + [words[:, k] for k in reversed(range(nw))])
    index = np.zeros(-(-b // 4) * 4, dtype=np.int32)
    index[:b] = order
    return np.concatenate([words.ravel().view(np.int32), words[order].ravel().view(np.int32), index])


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
    in codec order within tolerance, its errors counted from the packed
    words as the kernel counts them. The results of ``mdd_classify_plain``
    plus ``exact``, the reads the lookup resolved."""
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
    positions = torch.arange(4 * nw)
    segment = torch.full((4 * nw,), -1, dtype=torch.int64)
    for s, (start, width) in enumerate(zip(starts, widths)):
        segment[start : start + width] = s
    in_range = torch.zeros((pending.numel(), 4 * nw), dtype=torch.bool)
    for s, (start, width) in enumerate(zip(starts, widths)):
        length = lengths[pending, s].clamp(0, width)
        in_range |= (positions >= start) & (positions < start + length[:, None])
    quality = torch.zeros((pending.numel(), 4 * nw), dtype=torch.int64)
    quality[:, :w] = obs_qual.cpu()[pending].to(torch.int64)
    low = in_range & (quality < dec.quality_masking_threshold)
    # (pending, B, NW) words of read ^ barcode, their nonzero bytes as
    # position bits
    nibbles = nonzero_nibbles(read[pending][:, None, :] ^ words[None, :, :])
    mismatch = ((nibbles[..., None] >> torch.arange(4)) & 1).bool().view(pending.numel(), b, 4 * nw)
    errors = (mismatch & in_range[:, None, :]) | low[:, None, :]
    within = torch.ones((pending.numel(), b), dtype=torch.bool)
    total = torch.zeros((pending.numel(), b), dtype=torch.int64)
    for s in range(len(widths)):
        count = (errors & (segment == s)).sum(dim=2)
        within &= count <= tolerance[s]
        total += count
    any_within = within.any(dim=1)
    first = torch.argmax(within.to(torch.uint8), dim=1)
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
    widths = list(dec.segment_widths)
    return np.array([n, dec.barcode_count, sum(widths), len(widths), ld_obs, ld_len,
                     dec.quality_masking_threshold, key_words(sum(widths))], dtype=np.int32)


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
