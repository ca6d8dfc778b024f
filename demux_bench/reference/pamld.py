"""PAMLD decoding (phred-adjusted maximum likelihood), plain PyTorch.

For a read and each barcode b: sigma_b, the summed substitution cost of
its positions (``phred.substitution_lut``); its likelihood
p_b = 10^(-sigma_b / 10) times the barcode's prior concentration. The
decoded barcode is the first largest p_b; its confidence is
p_best / (sum_b p_b + noise * random barcode probability). A read whose
decoded barcode's likelihood is not above the random barcode probability
is unclassified (decoded 0, confidence 0, QC fail); one whose confidence
is not above the threshold keeps its barcode and fails QC.

Two ways to sum, one result:

- ``ordered``: each sigma summed over the positions in order and the
  normaliser over the barcodes in codec order, both Kahan-compensated,
  the first largest p_b strictly kept (the reference Pheniqs loop,
  pamld.cpp). Its decisions are the exact float64 decoder's, ties
  included. Costs reads x barcodes x positions gathers: small panels.
- ``gemm``: sigma as a product of the panel's one-hot rows and each
  read's (position, base) cost table; the normaliser a plain sum. Sums
  in another order, so read near a tie or a threshold it is not exact:
  each result carries the margins (``gap``, ``sigma_best``,
  ``confidence``) that let a comparison set such reads aside. A block's
  (reads, barcodes) sigma is read three times past the product: once
  for the two smallest (by chunks of barcodes, the runner-up then found
  in the best one's chunk alone), once to turn it into likelihoods in
  place, once to sum them.

``dtype`` is float64 for the reference and bfloat16 for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .phred import PHRED_BASE, STRICT_CODES, substitution_lut

_LUT = substitution_lut()
#: barcodes a chunk of the gemm path's search for the two smallest sigma
CHUNK = 8192


def classify(
    panel: np.ndarray,
    concentration: float,
    noise: float,
    random_barcode_probability: float,
    threshold: float,
    hq_threshold: int,
    hq_distance_threshold: int,
    obs_code: np.ndarray,
    obs_qual: np.ndarray,
    qcfail_in: np.ndarray,
    dtype=torch.float64,
    device="cpu",
    ordered: bool | None = None,
) -> dict:
    """Decode every read of (obs_code, obs_qual) ((N, W) BAM codes and
    qualities) against `panel` ((B, W) BAM codes). Returns NumPy arrays:
    ``decoded`` (1-based, 0 unclassified), ``confidence`` (float64 of
    `dtype`'s result), ``qcfail`` (after this decoder), ``gap`` (second
    smallest sigma less the smallest), ``sigma_best`` (the smallest)."""
    n, w = obs_code.shape
    b = panel.shape[0]
    if ordered is None:
        ordered = b <= 4096
    lut = torch.as_tensor(_LUT, dtype=dtype, device=device)
    e = torch.as_tensor(panel.astype(np.int64), device=device)
    adjusted_noise = noise * random_barcode_probability
    onehot = None if ordered else _onehot(e, lut.dtype)
    out = {key: [] for key in ("decoded", "confidence", "gap", "sigma_best", "conditional")}
    # ordered: the gather in blocks of ~2^25 (read, barcode, position)
    # terms, the barcode loop over blocks of ~2^27 (read, barcode) pairs;
    # gemm: blocks of ~2^29 pairs
    rows = max(1, (1 << 27) // b) if ordered else max(1, (1 << 29) // b)
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        if ordered:
            gather = max(1, (1 << 25) // (b * w))
            sigma = torch.cat([_ordered_sigma(lut, e, *_reads(obs_code, obs_qual, a, min(hi, a + gather), device))
                               for a in range(lo, hi, gather)])
            result = _ordered_posterior(sigma, concentration, adjusted_noise)
            low = torch.topk(sigma, min(2, b), dim=1, largest=False).values
            result["sigma_best"] = low[:, 0]
            result["gap"] = low[:, 1] - low[:, 0] if b > 1 else torch.full_like(low[:, 0], math.inf)
        else:
            sigma = _gemm_sigma(lut, onehot, *_reads(obs_code, obs_qual, lo, hi, device))
            result = _summed_posterior(sigma, concentration, adjusted_noise)
        for key in out:
            out[key].append(result[key].to(torch.float64).cpu().numpy())
        del sigma, result
    decoded = np.concatenate(out["decoded"]).astype(np.int32)
    confidence = np.concatenate(out["confidence"])
    conditional = np.concatenate(out["conditional"])
    passed_noise = conditional > random_barcode_probability
    passed_confidence = confidence > threshold
    qcfail = qcfail_in | ~passed_noise | (passed_noise & ~passed_confidence)
    if hq_distance_threshold > 0:
        chosen = panel[np.maximum(decoded - 1, 0)]
        hq = ((chosen != obs_code) & (obs_qual >= hq_threshold)).sum(axis=1)
        qcfail |= passed_noise & passed_confidence & (hq >= hq_distance_threshold)
    decoded[~passed_noise] = 0
    confidence[~passed_noise] = 0.0
    return {
        "decoded": decoded,
        "confidence": confidence,
        "qcfail": qcfail,
        "gap": np.concatenate(out["gap"]),
        "sigma_best": np.concatenate(out["sigma_best"]),
    }


def _reads(obs_code, obs_qual, lo, hi, device):
    return (torch.as_tensor(obs_code[lo:hi].astype(np.int64), device=device),
            torch.as_tensor(obs_qual[lo:hi].astype(np.int64), device=device))


def _ordered_sigma(lut, e, o, q):
    """(n, B): the costs gathered per (read, barcode, position) and summed
    over the positions in order, Kahan-compensated."""
    index = (q[:, None, :] * 256 + e[None, :, :] * 16 + o[:, None, :])
    terms = lut.reshape(-1)[index]
    sigma = torch.zeros(terms.shape[:2], dtype=lut.dtype, device=lut.device)
    compensation = torch.zeros_like(sigma)
    for j in range(terms.shape[2]):
        y = terms[:, :, j] - compensation
        t = sigma + y
        compensation = (t - sigma) - y
        sigma = t
    return sigma


def _ordered_posterior(sigma, concentration, adjusted_noise):
    """Strict argmax and the Kahan normaliser over the barcodes in codec
    order, the noise term added last."""
    base = torch.tensor(PHRED_BASE, dtype=sigma.dtype, device=sigma.device)
    conditional = torch.pow(base, sigma)
    prior = conditional * concentration
    n, b = prior.shape
    total = torch.zeros(n, dtype=sigma.dtype, device=sigma.device)
    compensation = torch.zeros_like(total)
    best = torch.zeros_like(total)
    index = torch.zeros(n, dtype=torch.int64, device=sigma.device)
    for j in range(b):
        p = prior[:, j]
        y = p - compensation
        t = total + y
        compensation = (t - total) - y
        total = t
        better = p > best
        best = torch.where(better, p, best)
        index = torch.where(better, j + 1, index)
    total = total + (adjusted_noise - compensation)
    return _decision(conditional, index, best / total)


def _onehot(e, dtype):
    """(B, W * 4): each barcode's one-hot row over (position, base)."""
    bases = torch.as_tensor(STRICT_CODES, device=e.device)
    if not bool(torch.isin(e, bases).all()):
        raise ValueError("the gemm sum takes panels of A, C, G and T only")
    return (e[:, :, None] == bases[None, None, :]).to(dtype).reshape(e.shape[0], -1)


def _gemm_sigma(lut, onehot, o, q):
    """(n, B): the panel's one-hot rows times each read's (position, base)
    cost table."""
    bases = torch.as_tensor(STRICT_CODES, device=o.device)
    table = lut[q[:, :, None], bases[None, None, :], o[:, :, None]]  # (n, W, 4)
    return table.reshape(table.shape[0], -1) @ onehot.T


def _two_smallest(sigma, chunk: int | None = None):
    """(smallest, its first index, the smallest of the others) of each row
    of `sigma`, reading it once: the least of each chunk of `chunk`
    barcodes, then the runner-up from the best chunk's own values and
    the other chunks' least."""
    n, b = sigma.shape
    chunk = min(chunk or CHUNK, b)
    whole = b // chunk * chunk
    parts = []
    if whole:
        parts.append(sigma[:, :whole].view(n, b // chunk, chunk).min(dim=2))
    if whole < b:
        tail = sigma[:, whole:].min(dim=1)
        parts.append((tail.values[:, None], tail.indices[:, None]))
    lows = torch.cat([p[0] for p in parts], dim=1)  # (n, chunks)
    ats = torch.cat([p[1] for p in parts], dim=1)
    low, best_chunk = lows.min(dim=1)
    start = best_chunk * chunk
    at = start + ats.gather(1, best_chunk[:, None])[:, 0]
    if b == 1:
        return low, at, torch.full_like(low, math.inf)
    columns = start[:, None] + torch.arange(chunk, device=sigma.device)
    inside = sigma.gather(1, columns.clamp(max=b - 1))
    inside.masked_fill_((columns >= b) | (columns == at[:, None]), math.inf)
    lows.scatter_(1, best_chunk[:, None], math.inf)
    return low, at, torch.minimum(inside.min(dim=1).values, lows.min(dim=1).values)


def _summed_posterior(sigma, concentration, adjusted_noise):
    """The normaliser a plain sum; the decision the first smallest sigma
    (sigma is overwritten with the likelihoods)."""
    base = torch.tensor(PHRED_BASE, dtype=sigma.dtype, device=sigma.device)
    low, at, second = _two_smallest(sigma)
    best = torch.pow(base, low)
    torch.pow(base, sigma, out=sigma)
    total = sigma.sum(dim=1) * concentration + adjusted_noise
    index = torch.where(best > 0, at + 1, 0)
    return {
        "decoded": index,
        "confidence": best * concentration / total,
        "conditional": torch.where(index > 0, best, torch.zeros_like(best)),
        "gap": second - low,
        "sigma_best": low,
    }


def _decision(conditional, index, confidence):
    rows = torch.arange(conditional.shape[0], device=conditional.device)
    chosen = conditional[rows, torch.clamp(index - 1, min=0)]
    return {
        "decoded": index,
        "confidence": confidence,
        "conditional": torch.where(index > 0, chosen, torch.zeros_like(chosen)),
    }
