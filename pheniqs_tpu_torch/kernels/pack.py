"""K5: the packed device->host decision blob (csrc/pack.cu).

``pack_outputs`` writes, per read and in ``device.wire.d2h_layout`` order,
the int16 (int32 for panels of 32000+ barcodes) decoded index of each
pamld/mdd decoder, the raw f32 confidence of each pamld decoder, the
chained qcfail bits and, in hybrid mode, the uncertain byte
(uncertain_any | forced), as one contiguous (N * total,) uint8 tensor.
On a CPU tensor the plain version below builds the same bytes with torch
views (the port of the pack_outputs block of
``pheniqs_tpu.device.step.make_decode_step``).
"""

from __future__ import annotations

import torch

from ..device.wire import d2h_layout
from ..errors import ConfigurationError
from . import MAX_DECODERS, Decisions, uncertain_mask
from .counters import uncertain_any

#: launches of the CUDA kernel in this process
launches = 0


def pack_outputs_plain(instrument, decisions: Decisions, forced, want_uncertain: bool):
    layout = d2h_layout(instrument, want_uncertain)
    n = decisions.decoded.shape[1]
    parts = []
    if layout["decoded_positions"]:
        dtype = torch.int32 if layout["wide"] else torch.int16
        ints = torch.stack(
            [decisions.decoded[k].to(dtype) for k in layout["decoded_positions"]], dim=1
        )
        parts.append(ints.view(torch.uint8).reshape(n, -1))
    if layout["confidence_positions"]:
        floats = torch.stack(
            [decisions.confidence[k] for k in layout["confidence_positions"]], dim=1
        )
        parts.append(floats.view(torch.uint8).reshape(n, -1))
    d = len(instrument.decoders)
    qc_bytes = []
    for byte in range(layout["qcfail_bytes"]):
        bits = torch.zeros(n, dtype=torch.uint8, device=decisions.qcfail.device)
        for bit in range(min(8, d - byte * 8)):
            bits |= decisions.qcfail[byte * 8 + bit].to(torch.uint8) << bit
        qc_bytes.append(bits)
    parts.append(torch.stack(qc_bytes, dim=1))
    if want_uncertain:
        unsure = uncertain_any(instrument, decisions, forced, True)
        parts.append(unsure.to(torch.uint8)[:, None])
    return torch.cat(parts, dim=1).reshape(-1)


def _launch(lib, instrument, decisions: Decisions, forced, want_uncertain, out, stream):
    """Run the kernel (no device checks, no count)."""
    from .build import check

    layout = d2h_layout(instrument, want_uncertain)
    d, n = decisions.decoded.shape
    status = lib.phq_pack(
        n, d,
        sum(1 << k for k in layout["decoded_positions"]),
        sum(1 << k for k in layout["confidence_positions"]),
        layout["index_size"], layout["qcfail_bytes"], int(want_uncertain),
        uncertain_mask(instrument, want_uncertain), layout["total"],
        decisions.decoded.data_ptr(), decisions.confidence.data_ptr(),
        decisions.qcfail.data_ptr(), decisions.uncertain.data_ptr(),
        forced.data_ptr() if want_uncertain else None, out.data_ptr(), stream,
    )
    check(status, "pack_outputs")
    return out


def pack_outputs(instrument, decisions: Decisions, forced, want_uncertain: bool):
    """K5: the (N * total,) uint8 decision blob of this batch."""
    if decisions.decoded.device.type == "cpu":
        return pack_outputs_plain(instrument, decisions, forced, want_uncertain)
    if decisions.decoded.device.type != "cuda":
        raise ValueError(f"pack_outputs: unsupported device {decisions.decoded.device}")
    global launches
    from .build import library

    if len(instrument.decoders) > MAX_DECODERS:
        raise ConfigurationError(
            f"pack_outputs: {len(instrument.decoders)} decoders exceed the kernel's {MAX_DECODERS}"
        )
    layout = d2h_layout(instrument, want_uncertain)
    n = decisions.decoded.shape[1]
    out = torch.empty(n * layout["total"], dtype=torch.uint8, device=decisions.decoded.device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    _launch(library(), instrument, decisions, forced, want_uncertain, out, stream)
    launches += 1
    return out
