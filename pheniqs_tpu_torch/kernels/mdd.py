"""K6: the MDD classify of one decoder (csrc/mdd.cu).

``mdd_classify`` decides, per read, by minimum distance decoding: the
first barcode that matches exactly, else the first barcode in codec order
whose per-segment errors are within the decoder's distance tolerance (not
the closest), with that barcode's total error as the distance. On a CUDA
tensor it launches the kernel; on a CPU tensor it runs the plain version
below, the torch port of ``pheniqs_tpu.device.classify.mdd_classify_device``.
Both are integer-only, so they agree byte for byte with each other and
with the f64 oracle (``pheniqs_tpu.decode.oracle.mdd_classify``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import ConfigurationError

#: launches of the CUDA kernel in this process
launches = 0

#: the kernel's limits (csrc/mdd.cu)
MAX_SEGMENTS = 8
MAX_WIDTH = 64


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
    tolerance = dec.distance_tolerance or tuple(0 for _ in widths)
    starts = np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(int)
    ints = [n, dec.barcode_count, sum(widths), len(widths), ld_obs, ld_len,
            dec.quality_masking_threshold]
    for start, width, tol in zip(starts, widths, tolerance):
        ints += [int(start), width, tol]
    return np.array(ints, dtype=np.int32)


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
    from .build import check, library
    from .pamld import empty_result

    n, w = obs_code.shape
    segments = len(dec.segment_widths)
    if segments > MAX_SEGMENTS or w > MAX_WIDTH or w != sum(dec.segment_widths):
        raise ConfigurationError(
            f"MDD observation of {segments} segments, {w} positions: the kernel "
            f"takes up to {MAX_SEGMENTS} segments and {MAX_WIDTH} positions"
        )
    for name, t in (("obs_code", obs_code), ("obs_qual", obs_qual)):
        if t.dtype != torch.uint8 or t.stride(1) != 1 or t.stride(0) != obs_code.stride(0):
            raise ValueError(f"mdd_classify: {name} must be uint8 rows of unit column stride")
    if lengths.dtype != torch.int32 or lengths.shape != (n, segments) or lengths.stride(1) != 1:
        raise ValueError("mdd_classify: lengths must be (N, S) int32 of unit column stride")
    if qcfail_in.dtype != torch.bool or qcfail_in.shape[0] != n or not qcfail_in.is_contiguous():
        raise ValueError("mdd_classify: qcfail_in must be contiguous (N,) bool")
    if out is None:
        out = empty_result(n, obs_code.device)
    ints = _ints(dec, n, obs_code.stride(0), lengths.stride(0))
    stream = torch.cuda.current_stream(obs_code.device).cuda_stream
    status = library().phq_mdd(
        ints.ctypes.data, obs_code.data_ptr(), obs_qual.data_ptr(),
        lengths.data_ptr(), qcfail_in.data_ptr(), dec.panel_codes_u8.data_ptr(),
        out["decoded"].data_ptr(), out["argmax"].data_ptr(),
        out["distance"].data_ptr(), out["branch"].data_ptr(),
        out["confidence"].data_ptr(), out["qcfail"].data_ptr(), stream,
    )
    check(status, "mdd_classify")
    launches += 1
    return {k: v for k, v in out.items() if k != "uncertain"}
