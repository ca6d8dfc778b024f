"""The port's hand-written Hopper kernels, each beside its plain torch
version: K3 ``unpack.unpack_tokens``, K1+K2 ``pamld.pamld_classify``
(K7 where its panel holds more than 1024 barcodes), K8
``pamld.pamld_classify_sharded`` (the same tile loop over panel shards),
K6 ``mdd.mdd_classify``, K4 ``counters.counters`` and K5
``pack.pack_outputs``.

A wrapper runs the plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel (built from ``csrc/`` on first use) or
raises. Each kernel's launches are counted in an integer of its module
(``launches``; K1's on panels above 1024 barcodes, the TPU program's
chunked posterior, in ``pamld.chunked_launches``; K8's stages in
``pamld.panel_sharded_launches``). The kernels take what the plain
versions take: any observation width and segment count, any token
program, any number of decoders. Two ceilings of a block's shared memory
remain, far past any instrument in use: a looped K1/K7/K8 barcode row
past 231,392 positions and a wide K6 read past 29,024 positions;
``check_kernel_limits`` refuses them when an engine is built for a card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..errors import ConfigurationError


def kernel_limits(instrument) -> list[str]:
    """One line for each decoder of `instrument` that no block of its
    kernel can hold in the shared memory an H100 block may take: a PAMLD
    barcode row of the looped K1/K7/K8 (pamld.looped_shared_bytes) or a
    wide K6 read with its tables (mdd.shared_bytes). The plain versions
    have no such ceiling."""
    from . import mdd, pamld

    problems = []
    for position, dec in enumerate(instrument.decoders):
        width = sum(dec.segment_widths)
        if not dec.plans:
            continue
        if dec.algorithm == "pamld" and width > pamld.LOOPED_PAST:
            need, limit = pamld.looped_shared_bytes(width), pamld.SHARED_LIMIT
        elif dec.algorithm == "mdd":
            need, limit = mdd.shared_bytes(dec.barcode_count, dec.segment_widths, mdd.decoder_planes(dec)), mdd.SHARED_LIMIT
        else:
            continue
        if need > limit:
            problems.append(f"decoder {position} ({dec.classifier_type} {dec.algorithm}): an observation of {width}"
                            f" positions takes {need} bytes of shared memory a block, past the {limit} of an H100 block")
    return problems


def check_kernel_limits(instrument):
    """Raise ConfigurationError, naming each decoder, when a kernel has no
    block for `instrument` (kernel_limits)."""
    problems = kernel_limits(instrument)
    if problems:
        raise ConfigurationError("the CUDA kernels cannot run this configuration: " + "; ".join(problems))


def _launch_counters() -> dict:
    """Kernel name -> (module, name of its launch count)."""
    from . import counters, mdd, pack, pamld, unpack

    return {
        "unpack_tokens": (unpack, "launches"),
        "pamld_classify": (pamld, "launches"),
        "counters": (counters, "launches"),
        "pack_outputs": (pack, "launches"),
        "mdd_classify": (mdd, "launches"),
        "pamld_chunked": (pamld, "chunked_launches"),
        "pamld_panel_sharded": (pamld, "panel_sharded_launches"),
    }


def launch_counts() -> dict[str, int]:
    """Kernel launches so far in this process, by kernel."""
    return {name: getattr(module, attr) for name, (module, attr) in _launch_counters().items()}


def reset_launch_counts():
    for module, attr in _launch_counters().values():
        setattr(module, attr, 0)


@dataclass
class Decisions:
    """Per-read results of every decoder, stacked (decoders, N): the rows
    the classify kernels write and the counter and pack kernels read.
    Naive and passthrough rows stay zero except their chained qcfail."""

    decoded: torch.Tensor  # int32
    argmax: torch.Tensor  # int32
    distance: torch.Tensor  # int32
    branch: torch.Tensor  # int8
    confidence: torch.Tensor  # f32
    qcfail: torch.Tensor  # bool
    uncertain: torch.Tensor  # bool

    @classmethod
    def zeros(cls, decoders: int, n: int, device) -> "Decisions":
        """Every field a (decoders, N) view of one zeroed buffer (one
        memset): the 4-byte fields first, so each view is aligned to its
        element size."""
        fields = sorted(_FIELDS, key=lambda field: -field[1].itemsize)
        buffer = torch.zeros(decoders * n * sum(dtype.itemsize for _, dtype in fields), dtype=torch.uint8,
                             device=device)
        views, at = {}, 0
        for name, dtype in fields:
            size = decoders * n * dtype.itemsize
            views[name] = buffer[at : at + size].view(dtype).view(decoders, n)
            at += size
        return cls(**views)

    def columns(self, start: int, stop: int) -> "Decisions":
        """Reads [start, stop) of every decoder, contiguous."""
        return Decisions(**{name: getattr(self, name)[:, start:stop].contiguous() for name, _ in _FIELDS})

    def row(self, k: int) -> dict:
        return {
            "decoded": self.decoded[k],
            "argmax": self.argmax[k],
            "distance": self.distance[k],
            "branch": self.branch[k],
            "confidence": self.confidence[k],
            "qcfail": self.qcfail[k],
            "uncertain": self.uncertain[k],
        }


#: Decisions' fields and their dtypes, in the dataclass's order
_FIELDS = (
    ("decoded", torch.int32),
    ("argmax", torch.int32),
    ("distance", torch.int32),
    ("branch", torch.int8),
    ("confidence", torch.float32),
    ("qcfail", torch.bool),
    ("uncertain", torch.bool),
)


def uncertain_mask(instrument, want_uncertain: bool) -> int:
    """Bit k set when decoder k's uncertain row feeds uncertain_any."""
    if not want_uncertain:
        return 0
    return sum(
        1 << k for k, dec in enumerate(instrument.decoders) if dec.algorithm == "pamld"
    )
