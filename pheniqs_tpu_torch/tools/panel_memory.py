"""Measure the device footprint and step cost of large barcode panels.

Port of ``pheniqs_tpu.tools.panel_memory``. The panel-sharding threshold
(``PHENIQS_TP_THRESHOLD``, device/distributed.py) is still the TPU's; this
tool gives it data. For each panel size it builds a synthetic whitelist
decoder on the device with the instrument compiler's own
``_panel_matrices``, runs the production classify (``pamld_classify_device``:
K7 above 1024 barcodes) over one batch, and reports:

  * ``resident_bytes``: what the decoder holds on the device, by tensor
    (int32 and uint8 panel codes, the (5W, B) f32 likelihood matrix that
    only the plain versions read, the concentrations), (25 W + 4) B bytes
  * ``allocated_growth``: the growth of ``torch.cuda.memory_allocated``
    while the panel is built (``requested_growth``: of the bytes asked for,
    before the allocator's rounding), and the allocator's counts before
    and after the batch (``max_memory_allocated``, its peak reset between
    sizes)
  * steady per-batch latency (CUDA events), reads/s and the decoded share

Run on the card: ``python -m pheniqs_tpu_torch.tools.panel_memory``
(``--device cpu`` on a machine without one: the memory counts are then
the tensors' sizes alone, and the times are the CPU's).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

#: the decoder's device tensors, as the instrument compiler places them
RESIDENT = ("panel_codes", "panel_codes_u8", "likelihood_matrix", "concentration")


def synthetic_panel_decoder(b: int, w: int, seed: int = 7, device="cuda"):
    """A DeviceDecoder of a synthetic whitelist: B barcodes of width W
    with uniform concentration (the reference tool's draws), its tensors
    built by the compiler's ``_panel_matrices`` on `device`, bypassing the
    config compiler (panel construction is what is being measured, not
    parsing)."""
    from ..device.instrument import LARGE_PANEL_B, STRICT_CODES, DeviceDecoder, _panel_matrices

    if b <= LARGE_PANEL_B:
        raise ValueError(f"panels of {b} barcodes take K1, not the chunked path this tool measures")
    rng = np.random.default_rng(seed)
    codes = np.array(STRICT_CODES, dtype=np.int64)[rng.integers(4, size=(b, w))]
    noise = 0.05
    concentration = np.full(b, (1.0 - noise) / b, dtype=np.float32)
    panel_codes, panel_codes_u8, matrix, concentration = _panel_matrices(codes, concentration, device)
    return DeviceDecoder(
        algorithm="pamld",
        classifier_type="cellular",
        index=1,
        multiplexing=False,
        plans=[],
        segment_widths=[w],
        barcode_count=b,
        width=w,
        panel_codes=panel_codes,
        panel_codes_u8=panel_codes_u8,
        likelihood_matrix=matrix,
        concentration=concentration,
        noise=noise,
        confidence_threshold=0.95,
        random_barcode_probability=0.25**w,
    )


def panel_instrument(dec, device):
    """A one-decoder DeviceInstrument around `dec` on `device`."""
    from ..device.instrument import DeviceInstrument, analytic_tpq_epsilon, tpq_constants

    return DeviceInstrument(
        decoders=[dec],
        multiplexing_index=0,
        input_segment_cardinality=1,
        device=device,
        tpq_constants=torch.from_numpy(tpq_constants()).to(device),
        tpq_analytic_eps=analytic_tpq_epsilon(device),
    )


def resident_bytes(dec) -> dict:
    """Bytes of each tensor `dec` holds on its device, and their total."""
    parts = {name: getattr(dec, name).nbytes for name in RESIDENT}
    parts["total"] = sum(parts.values())
    return parts


def allocator_slack(resident: dict) -> int:
    """The most by which the growth of ``memory_allocated`` may exceed
    `resident` (resident_bytes): the CUDA caching allocator rounds every
    block up to 512 B, and a block above 1 MiB may keep a remainder below
    1 MiB that its segment does not split off."""
    return sum(512 + (1 << 20 if size > 1 << 20 else 0) for name, size in resident.items() if name != "total")


def _memory(device):
    if device.type != "cuda":
        return None
    return {
        "allocated": torch.cuda.memory_allocated(device),
        # the bytes asked for, before the allocator rounds them up
        "requested": torch.cuda.memory_stats(device).get("requested_bytes.all.current"),
        "peak_allocated": torch.cuda.max_memory_allocated(device),
        "reserved": torch.cuda.memory_reserved(device),
    }


def measure(b: int, w: int, n: int, iters: int, device, rng) -> dict:
    """One panel size's row: build the decoder on `device`, classify `n`
    reads drawn from it (2 % of positions substituted, qualities 20-39)
    `iters` times over two resident buffers."""
    from ..device.classify import pamld_classify_device
    from ..device.instrument import STRICT_CODES

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()  # the panel's blocks come from fresh segments where they can
        torch.cuda.reset_peak_memory_stats(device)
    before = _memory(device)
    dec = synthetic_panel_decoder(b, w, device=device)
    built = _memory(device)
    instrument = panel_instrument(dec, device)

    # reads drawn FROM the panel so decode rates are realistic
    pick = rng.integers(b, size=n)
    obs_code = dec.panel_codes.cpu().numpy()[pick]
    flip = rng.random((n, w)) < 0.02
    obs_code = np.where(flip, np.array(STRICT_CODES)[rng.integers(4, size=(n, w))], obs_code)
    obs_qual = rng.integers(20, 40, size=(n, w))
    buffers = [
        tuple(torch.from_numpy(np.roll(x, k, axis=0).astype(np.uint8)).to(device) for x in (obs_code, obs_qual))
        for k in range(2)
    ]
    qcfail = torch.zeros(n, dtype=torch.bool, device=device)

    def run(i):
        return pamld_classify_device(instrument, dec, *buffers[i % 2], qcfail)

    decoded = run(0)["decoded"]
    decoded_fraction = float((decoded > 0).float().mean())
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for i in range(iters):
            run(i)
        end.record()
        torch.cuda.synchronize(device)
        latency = start.elapsed_time(end) / 1e3 / iters
    else:
        clock = time.perf_counter()
        for i in range(iters):
            run(i)
        latency = (time.perf_counter() - clock) / iters
    after = _memory(device)
    resident = resident_bytes(dec)
    return {
        "panel_b": b,
        "width": w,
        "batch": n,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "resident_bytes": resident["total"],
        "resident": resident,
        "allocated_growth": None if before is None else built["allocated"] - before["allocated"],
        "requested_growth": None if before is None or before["requested"] is None
        else built["requested"] - before["requested"],
        "memory_before": before,
        "memory_after": after,
        "latency_s": round(latency, 6),
        "reads_per_s": round(n / latency, 1),
        "decoded_fraction": round(decoded_fraction, 4),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description="device footprint / cost of large barcode panels")
    parser.add_argument("--sizes", default="65536,262144,1048576", help="comma-separated panel cardinalities")
    parser.add_argument("--width", type=int, default=16)
    parser.add_argument("--batch", type=int, default=131072)
    parser.add_argument("--iters", type=int, default=6)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from ..device.instrument import resolve_device

    device = resolve_device(args.device)
    rng = np.random.default_rng(3)
    rows = []
    for b in (int(x) for x in args.sizes.split(",")):
        row = measure(b, args.width, args.batch, args.iters, device, rng)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
