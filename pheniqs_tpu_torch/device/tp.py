"""Tensor parallelism over the barcode axis (panel sharding, K8):
counterpart of ``pheniqs_tpu/device/tp.py`` and of the panel-shard half
of ``pheniqs_tpu/device/step.py:make_tp_sharded_decode_step``.

Each of P ranks holds one shard of every large PAMLD panel: its columns
``[base, base + local_b)`` with ``local_b = ceil(B / P)`` (the last shard's
padding columns past B are never visited, so they never win). A rank
computes its shard's partials with K8 (kernels/pamld.py), and the global
posterior merges exactly as the reference's collectives do
(classify.py:364-391): MIN of the row minima (the shift), then over the
shards' partials SUM of the totals, MAX of the best p, MIN of the global
index among the shards holding that maximum (the first barcode wins ties,
never the order of arrival), MIN of sigma on the holder and MAX of the
runner-up candidates.

The merge takes either a process group (one shard per rank; the partials
gathered with ``all_gather``) or the in-process form, where one process
holds all P shards stacked on a leading axis. Both reduce the same
stacked tensor in rank order, so they give the same bytes, on every rank
and in every run with the same P.

The engine's protocol (``PHENIQS_TP="1:P"``): rank 0 compiles the
configuration and leads the whole host pipeline; ``share_instrument``
sends every rank the instrument's layout and its panel shards; per batch
``send_batch`` broadcasts the wire blob and codebooks, and each follower
(``follow``) runs K3 and its shards' stages, taking part in the merges.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..kernels.pamld import BIG_SIGMA, pack_partials, posterior_panel_sharded_plain, unpack_partials
from . import wire
from .distributed import PanelGroup, close_panel_group, panel_group, tp_threshold
from .instrument import DeviceInstrument, analytic_tpq_epsilon, tpq_constants

#: the candidate index of a shard that does not hold the maximum
BIG_INDEX = 2**30

#: host seconds this process spent in the panel group's collectives (the
#: merges and the batch broadcast): gloo stages CUDA tensors through host
#: memory and returns when done, so this is their time apart from the
#: kernels; NCCL returns at enqueue
collective_seconds = 0.0


def _collective(call, *args, **kwargs):
    global collective_seconds
    start = time.perf_counter()
    call(*args, **kwargs)
    collective_seconds += time.perf_counter() - start


@dataclass
class PanelShard:
    """One shard of a PAMLD panel of ``barcode_count`` barcodes: global
    columns ``[base, base + local_b)``, of which ``count`` are real."""

    base: int
    local_b: int
    barcode_count: int
    codes_u8: torch.Tensor  # (count, W) uint8, the kernel's rows
    matrix: torch.Tensor  # (5W, count) f32, the plain version's G columns
    concentration: torch.Tensor  # (count,) f32

    @property
    def count(self) -> int:
        return max(0, min(self.local_b, self.barcode_count - self.base))


def shard_width(barcode_count: int, panel_size: int) -> int:
    """Columns per shard: B padded to a multiple of P, over P
    (step.py:899-923)."""
    return -(-barcode_count // panel_size)


def shard_panel(dec, rank: int, panel_size: int) -> PanelShard:
    """Shard `rank` of `panel_size` of a whole decoder's panel, as views."""
    local_b = shard_width(dec.barcode_count, panel_size)
    shard = PanelShard(rank * local_b, local_b, dec.barcode_count, None, None, None)
    columns = slice(shard.base, shard.base + shard.count)
    shard.codes_u8 = dec.panel_codes_u8[columns]
    shard.matrix = dec.likelihood_matrix[:, columns]
    shard.concentration = dec.concentration[columns]
    return shard


def sharded_positions(instrument, threshold: int) -> list[int]:
    """The decoders whose panels shard: PAMLD above `threshold` barcodes."""
    return [
        position
        for position, dec in enumerate(instrument.decoders)
        if dec.algorithm == "pamld" and dec.barcode_count > threshold
    ]


# --- the merges ----------------------------------------------------------
def merge_panel_shift(shifts: torch.Tensor, group: PanelGroup | None = None) -> torch.Tensor:
    """(S, N) row minima of the S shards this process holds -> the global
    (N,) shift: MIN over them, then MIN over the group's ranks (exact in
    any order)."""
    shift = shifts.min(dim=0).values
    if group is not None:
        _collective(dist.all_reduce, shift, op=dist.ReduceOp.MIN, group=group.group)
    return shift


def merge_panel_partials(partials: torch.Tensor, group: PanelGroup | None = None) -> torch.Tensor:
    """(S, 5, N) packed partials (kernels/pamld.py PARTIAL_ROWS) of the
    shards this process holds -> the merged (5, N): in process S = P;
    with a group, each rank's one shard, gathered in rank order first."""
    if group is not None:
        if partials.shape[0] != 1:
            raise ValueError("a rank of the panel group holds one shard")
        gathered = [torch.empty_like(partials[0]) for _ in range(group.size)]
        _collective(dist.all_gather, gathered, partials[0].contiguous(), group=group.group)
        partials = torch.stack(gathered)
    return reduce_partials(partials)


def reduce_partials(stacked: torch.Tensor) -> torch.Tensor:
    """The merge of classify.py:369-391 over the leading (shard) axis of
    (P, 5, N) packed partials, the totals summed in shard order."""
    parts = [unpack_partials(part) for part in stacked]
    total = parts[0]["total"].clone()
    for part in parts[1:]:
        total = total + part["total"]
    best_p_local = torch.stack([part["best_p"] for part in parts])
    index = torch.stack([part["best0"] for part in parts])
    best_p = best_p_local.max(dim=0).values
    candidate = torch.where(best_p_local >= best_p, index, BIG_INDEX)
    best0 = candidate.min(dim=0).values
    holder = index == best0
    sigma_best = torch.where(
        holder, torch.stack([part["sigma_best"] for part in parts]), BIG_SIGMA
    ).min(dim=0).values
    second_p = torch.where(
        holder, torch.stack([part["second_p"] for part in parts]), best_p_local
    ).max(dim=0).values
    return pack_partials(total, best_p, best0, second_p, sigma_best)


def tp_posterior(features, qpos_uniform, matrix, concentration, adjusted_noise: float, panel_size: int):
    """(best0, best_p, sigma_p, sigma_best, second_p) of the whole panel
    (``matrix`` (5W, B), ``concentration`` (B,)) split into `panel_size`
    shards and merged in process: the plain algebra of K8, the port's
    ``tp_posterior``."""
    b = matrix.shape[1]
    local_b = shard_width(b, panel_size)
    shards = []
    for rank in range(panel_size):
        shard = PanelShard(rank * local_b, local_b, b, None, None, None)
        columns = slice(shard.base, shard.base + shard.count)
        shard.matrix, shard.concentration = matrix[:, columns], concentration[columns]
        shards.append(shard)
    return posterior_panel_sharded_plain(features, qpos_uniform, shards, adjusted_noise)


# --- the engine's set-up and per-batch protocol --------------------------
def share_instrument(instrument: DeviceInstrument | None, group: PanelGroup):
    """Send every rank the instrument and its panel shards from rank 0,
    which passes its instrument compiled on the CPU (followers pass None).
    Returns this rank's (instrument on its device, {position: [its
    PanelShard]}). Rank 0's instrument keeps every tensor but G and the
    concentrations of sharded panels (K2 reads the whole codes); a
    follower's keeps only the decoders' layout, for K3. The panels above
    PHENIQS_TP_THRESHOLD barcodes shard."""
    if group.leader:
        positions = sharded_positions(instrument, tp_threshold())
        layout = dataclasses.replace(
            instrument,
            decoders=[
                dataclasses.replace(
                    dec, panel_codes=None, panel_codes_u8=None, key_table=None, likelihood_matrix=None,
                    concentration=None, spec=None,
                )
                for dec in instrument.decoders
            ],
            tpq_constants=None,
        )
        message = [(layout, positions)]
    else:
        message = [None]
    dist.broadcast_object_list(message, src=0, group=group.setup)
    layout, positions = message[0]
    device = group.device
    shards = {}
    for position in positions:
        b = layout.decoders[position].barcode_count
        w = layout.decoders[position].width
        local_b = shard_width(b, group.size)
        padded = local_b * group.size
        pieces = {
            "codes_u8": (torch.uint8, (local_b, w)),
            "matrix": (torch.float32, (5 * w, local_b)),
            "concentration": (torch.float32, (local_b,)),
        }
        received = {}
        for name, (dtype, shape) in pieces.items():
            out = torch.empty(shape, dtype=dtype)
            scatter = None
            if group.leader:
                whole = _padded(instrument.decoders[position], name, padded)
                scatter = [
                    (whole[k * local_b : (k + 1) * local_b] if name != "matrix"
                     else whole[:, k * local_b : (k + 1) * local_b]).contiguous()
                    for k in range(group.size)
                ]
            dist.scatter(out, scatter, src=0, group=group.setup)
            received[name] = out
        shard = PanelShard(group.rank * local_b, local_b, b, None, None, None)
        count = shard.count
        shard.codes_u8 = received["codes_u8"][:count].to(device)
        shard.matrix = received["matrix"][:, :count].to(device)
        shard.concentration = received["concentration"][:count].to(device)
        shards[position] = [shard]
    placed = instrument if group.leader else layout
    decoders = []
    for position, dec in enumerate(placed.decoders):
        tensors = {}
        for name in ("panel_codes", "panel_codes_u8", "key_table", "likelihood_matrix", "concentration"):
            value = getattr(dec, name)
            keep = value is not None and not (
                position in shards and name in ("likelihood_matrix", "concentration")
            )
            tensors[name] = value.to(device) if keep else None
        decoders.append(dataclasses.replace(dec, **tensors))
    placed = dataclasses.replace(
        placed,
        decoders=decoders,
        device=device,
        tpq_constants=torch.from_numpy(tpq_constants()).to(device),
        tpq_analytic_eps=analytic_tpq_epsilon(device),
    )
    return placed, shards


#: a shard's tensors and the decoder's tensor each is cut from
_SHARD_SOURCES = {
    "codes_u8": "panel_codes_u8",
    "matrix": "likelihood_matrix",
    "concentration": "concentration",
}


def _padded(dec, name: str, padded: int) -> torch.Tensor:
    """A whole decoder's tensor for shard tensor `name` (on the CPU), its
    barcode axis padded with zeros to `padded` columns."""
    value = getattr(dec, _SHARD_SOURCES[name]).cpu()
    pad = padded - dec.barcode_count
    if name == "codes_u8":
        return torch.nn.functional.pad(value, (0, 0, 0, pad))
    return torch.nn.functional.pad(value, (0, pad))


#: header commands of the per-batch protocol
STOP = 0
BATCH = 1
#: qual_bits on the wire header (the j4 wire's is a string)
_QUAL_CODES = {6: 6, 2: 2, 4: 4, wire.JOINT4: 16}
_QUAL_BITS = {code: bits for bits, code in _QUAL_CODES.items()}


def _header(group: PanelGroup, segments: int, values=()) -> list[int]:
    header = torch.zeros(5 + segments, dtype=torch.int64, device=group.device)
    if values:
        header.copy_(torch.tensor(values, dtype=torch.int64))
    _collective(dist.broadcast, header, 0, group=group.group)
    return header.tolist()


def send_batch(group: PanelGroup, signature: tuple, blob, ccb=None, qcb=None):
    """Rank 0: broadcast one batch's wire blob (on the device) and its
    codebooks to the followers."""
    padded_n, widths, qual_bits = signature
    _header(group, len(widths), [
        BATCH, padded_n, _QUAL_CODES[qual_bits],
        0 if qcb is None else qcb.numel(), 0 if ccb is None else ccb.numel(), *widths,
    ])
    for tensor in (blob, qcb, ccb):
        if tensor is not None:
            _collective(dist.broadcast, tensor, 0, group=group.group)


def send_stop(group: PanelGroup, segments: int):
    """Rank 0: the end of the run; the followers return."""
    _header(group, segments, [STOP] + [0] * (4 + segments))
    dist.barrier(group=group.setup)
    close_panel_group()


def follow(device="cuda") -> int:
    """A follower rank's whole run: take the instrument and this rank's
    shards from rank 0, then for every batch rank 0 broadcasts run K3 and
    K8's stages on the shards, taking part in the merges; write nothing.
    Returns the number of batches followed."""
    from .step import DecodeStep

    group = panel_group(device)
    instrument, shards = share_instrument(None, group)
    segments = len(instrument.used_segments)
    steps: dict[tuple, DecodeStep] = {}
    batches = 0
    with torch.no_grad():
        while True:
            command, padded_n, qual_code, qcb_len, ccb_len, *widths = _header(group, segments)
            if command == STOP:
                break
            qual_bits = _QUAL_BITS[qual_code]
            blob = torch.empty(
                (padded_n, wire.h2d_blob_bytes(widths, qual_bits)), dtype=torch.uint8, device=group.device
            )
            qcb = torch.empty(qcb_len, dtype=torch.int32, device=group.device) if qcb_len else None
            ccb = torch.empty(ccb_len, dtype=torch.int32, device=group.device) if ccb_len else None
            for tensor in (blob, qcb, ccb):
                if tensor is not None:
                    _collective(dist.broadcast, tensor, 0, group=group.group)
            signature = (padded_n, tuple(widths), qual_bits)
            step = steps.get(signature)
            if step is None:
                step = steps[signature] = DecodeStep(
                    instrument, list(widths), qual_bits, want_uncertain=False,
                    panel_shards=shards, group=group,
                )
            step.follow(blob, ccb, qcb)
            batches += 1
    dist.barrier(group=group.setup)
    close_panel_group()
    return batches

