"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit) and the work of the kernels the per-layer metrics read: a copy of
``chip_smoke.py``'s ``bound`` and ``classify_work`` arithmetic."""

from __future__ import annotations

F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def pamld_ops(reads: int, barcodes: int, width: int) -> int:
    """Useful operations of PAMLD over `reads` reads and a panel of
    `barcodes` x `width`: per (read, barcode) a match and a strictness
    compare and two f32 adds a position, then four operations of the
    posterior (exp, product, sum, compare)."""
    return 4 * reads * barcodes * (width + 1)


def pamld_bytes(reads: int, barcodes: int, width: int) -> int:
    """Bytes PAMLD needs: the observation read, the panel and its
    concentrations read, seven (N,) results written."""
    return 2 * reads * width + barcodes * width + 4 * barcodes + 2 * reads + 19 * reads


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the f32 peak and the bytes over the memory bandwidth."""
    return max(ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
