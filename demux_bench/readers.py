"""Arithmetic that more than one metric reader shares."""

from __future__ import annotations

import sys

from .roofline import F32_OPS_PER_S, bound_s, pamld_bytes, pamld_ops

#: the kernels of the program's PAMLD tile loop (K1, K7), by name
PAMLD_KERNEL = "phq_pamld"


def idle_share(run) -> float | None:
    """Percent of the traced window in which the card ran nothing."""
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def pamld_work(run) -> tuple[int, int]:
    """(operations, bytes) of every PAMLD decoder over the window's records."""
    ops = nbytes = 0
    for decoder in run.instrument.pamld():
        ops += pamld_ops(run.window_records, decoder.barcodes, decoder.width)
        nbytes += pamld_bytes(run.window_records, decoder.barcodes, decoder.width)
    return ops, nbytes


def pamld_roofline(run) -> float | None:
    """Percent of the PAMLD tile loop's bound that its kernels reach in the
    window: the least time the card could take for the window's PAMLD
    work over the device time of the kernels named phq_pamld*."""
    if run.trace is None:
        return None
    kernels = run.trace.seconds_by_name(lambda name: PAMLD_KERNEL in name)
    seconds = sum(entry[1] for entry in kernels.values())
    if seconds <= 0:
        return None
    batches = run.window_records / run.cell.traffic["batch_size"]
    found = {name[:60]: round(entry[0] / batches, 3) for name, entry in kernels.items()}
    print(f"pamld launches found a batch in the window: {found}", file=sys.stderr)
    return 100.0 * bound_s(*pamld_work(run)) / seconds


def step_mfu(run) -> float | None:
    """Percent of the card's f32 peak that the window's useful PAMLD
    operations fill over the seconds in which the card ran anything (the
    union of every kernel, copy and memset in the traced window)."""
    if run.trace is None:
        return None
    busy = run.trace.busy_s()
    if busy <= 0:
        return None
    return 100.0 * pamld_work(run)[0] / (F32_OPS_PER_S * busy)
