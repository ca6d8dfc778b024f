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

The engine's protocol (``PHENIQS_TP="R:P"``, a grid of R rows by P
columns; device/distributed.py): rank 0 compiles the configuration and
leads the whole host pipeline; ``share_instrument`` sends every rank the
instrument's layout and its column's panel shards, and each row leader
(column 0) rank 0's whole instrument. Per batch, with R > 1, rank 0 sends
each row leader the batch's header and its row's slice (``scatter_rows``)
and the row leader (``lead_row``) runs the whole decode step on it; in
every row, ``send_batch`` broadcasts the row's wire blob and codebooks to
its followers (``follow``), which run K3 and their shards' stages, taking
part in the row's merges; the row leaders send their decision rows and
counters back to rank 0 (``gather_rows``).
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

#: host seconds this process spent in the grid's collectives (the merges,
#: the batch broadcast, and the slices out and results back): gloo stages
#: CUDA tensors through host memory and returns when done, so this is their
#: time apart from the kernels; NCCL returns at enqueue
collective_seconds = 0.0
#: host seconds this process spent waiting on a batch header: the time
#: until the row leader (or rank 0) has the next batch, idle for this rank
header_seconds = 0.0


def _collective(call, *args, header: bool = False, **kwargs):
    global collective_seconds, header_seconds
    start = time.perf_counter()
    call(*args, **kwargs)
    if header:
        header_seconds += time.perf_counter() - start
    else:
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


def grid_posterior(features, qpos_uniform, matrix, concentration, adjusted_noise: float, reads: int,
                   panel_size: int):
    """``tp_posterior`` over a (reads, panel) grid in process: the rows
    padded to a multiple of `reads` (zero features), cut into `reads`
    contiguous slices in read order, each slice's posterior merged over
    `panel_size` shards, the slices concatenated and the padding cut off
    (the JAX ``tp_posterior`` on a (reads, panel) mesh)."""
    n = features.shape[0]
    padded = -(-n // reads) * reads
    if padded != n:
        features = torch.nn.functional.pad(features, (0, 0, 0, padded - n))
        qpos_uniform = torch.nn.functional.pad(qpos_uniform, (0, padded - n))
    share = padded // reads
    slices = [
        tp_posterior(features[r * share : (r + 1) * share], qpos_uniform[r * share : (r + 1) * share], matrix,
                     concentration, adjusted_noise, panel_size)
        for r in range(reads)
    ]
    return tuple(torch.cat(parts)[:n] for parts in zip(*slices))


# --- the engine's set-up and per-batch protocol --------------------------
def _strip(dec, **tensors):
    """A decoder with its host-only ``spec`` dropped and `tensors` replaced."""
    return dataclasses.replace(dec, spec=None, **tensors)


def share_instrument(instrument: DeviceInstrument | None, group: PanelGroup):
    """Send every rank of the grid the instrument and its panel shards from
    rank 0, which passes its instrument compiled on the CPU (the others
    pass None). Returns this rank's (instrument on its device, {position:
    [its PanelShard]}). Rank 0's and every row leader's instrument keeps
    every tensor but G and the concentrations of sharded panels (K2 reads
    the whole codes; a row leader runs the whole step on its row's slice);
    a panel follower's keeps only the decoders' layout, for K3. The panels
    above PHENIQS_TP_THRESHOLD barcodes shard, and every rank of column p
    holds shard p, so each row holds the whole panel."""
    if group.leader:
        positions = sharded_positions(instrument, tp_threshold())
        layout = dataclasses.replace(
            instrument,
            decoders=[
                _strip(dec, panel_codes=None, panel_codes_u8=None, key_table=None, likelihood_matrix=None,
                       concentration=None)
                for dec in instrument.decoders
            ],
            tpq_constants=None,
        )
        message = [(layout, positions)]
    else:
        message = [None]
    dist.broadcast_object_list(message, src=0, group=group.setup)
    layout, positions = message[0]
    if group.rows > 1:
        # the row leaders' whole instrument, less what only the shards need
        if group.leader:
            full = dataclasses.replace(
                instrument,
                decoders=[
                    _strip(dec, **({"likelihood_matrix": None, "concentration": None} if k in positions else {}))
                    for k, dec in enumerate(instrument.decoders)
                ],
                tpq_constants=None,
            )
            for row in range(1, group.rows):
                dist.send_object_list([full], dst=row * group.size, group=group.setup)
        elif group.row_leader:
            received = [None]
            dist.recv_object_list(received, src=0, group=group.setup)
            instrument = received[0]
    device = group.device
    world = group.rows * group.size
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
                columns = [
                    (whole[k * local_b : (k + 1) * local_b] if name != "matrix"
                     else whole[:, k * local_b : (k + 1) * local_b]).contiguous()
                    for k in range(group.size)
                ]
                # grid rank g gets its column's shard
                scatter = [columns[g % group.size] for g in range(world)]
            dist.scatter(out, scatter, src=0, group=group.setup)
            received[name] = out
        shard = PanelShard(group.column * local_b, local_b, b, None, None, None)
        count = shard.count
        shard.codes_u8 = received["codes_u8"][:count].to(device)
        shard.matrix = received["matrix"][:, :count].to(device)
        shard.concentration = received["concentration"][:count].to(device)
        shards[position] = [shard]
    placed = instrument if group.row_leader else layout
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
#: header fields before the segment widths: command, rows, qual code,
#: qcb length, ccb length, want_uncertain
_FIELDS = 6


def _broadcast(group: PanelGroup, tensor, grid: bool = False, header: bool = False):
    """Broadcast `tensor` within this rank's row from its leader, or, with
    `grid`, from rank 0 to the row leaders."""
    if grid:
        _collective(dist.broadcast, tensor, 0, group=group.leaders, header=header)
    else:
        _collective(dist.broadcast, tensor, group.row_leader_rank, group=group.group, header=header)


def _header(group: PanelGroup, segments: int, values=(), grid: bool = False) -> list[int]:
    """One batch's header (_broadcast). Its rows field is the batch's rows
    within a row, the padded batch's over the grid (row r takes the r-th
    of R equal contiguous slices)."""
    header = torch.zeros(_FIELDS + segments, dtype=torch.int64, device=group.transport if grid else group.device)
    if values:
        header.copy_(torch.tensor(values, dtype=torch.int64))
    _broadcast(group, header, grid, header=True)
    return header.tolist()


def _batch_header(signature: tuple, ccb, qcb, want_uncertain: bool) -> list[int]:
    padded_n, widths, qual_bits = signature
    return [
        BATCH, padded_n, _QUAL_CODES[qual_bits],
        0 if qcb is None else qcb.numel(), 0 if ccb is None else ccb.numel(), int(want_uncertain), *widths,
    ]


def _receive_books(group: PanelGroup, qcb_len: int, ccb_len: int, grid: bool = False):
    """(qcb, ccb) of a batch, broadcast after its header (None when absent)."""
    on = group.transport if grid else group.device
    books = tuple(torch.empty(k, dtype=torch.int32, device=on) if k else None for k in (qcb_len, ccb_len))
    for tensor in books:
        if tensor is not None:
            _broadcast(group, tensor, grid)
    return books


def send_batch(group: PanelGroup, signature: tuple, blob, ccb=None, qcb=None):
    """A row leader (rank 0 on row 0): broadcast one batch's wire blob (on
    the device) and its codebooks to the followers of its row."""
    _header(group, len(signature[1]), _batch_header(signature, ccb, qcb, False))
    for tensor in (blob, qcb, ccb):
        if tensor is not None:
            _broadcast(group, tensor)


def scatter_rows(group: PanelGroup, signature: tuple, rows, ccb=None, qcb=None, want_uncertain: bool = True):
    """Rank 0 of a grid with R > 1 rows: send the row leaders the batch's
    header, then slice r of `rows` (the padded batch's wire rows, host
    memory; R equal contiguous slices in read order) to the leader of row
    r, then the codebooks. Under gloo the slices go from host memory as
    they are; under NCCL through rank 0's card."""
    _header(group, len(signature[1]), _batch_header(signature, ccb, qcb, want_uncertain), grid=True)
    share = rows.shape[0] // group.rows
    for row in range(1, group.rows):
        piece = rows[row * share : (row + 1) * share].to(group.transport)
        _collective(dist.send, piece, row * group.size, group=group.leaders)
    for tensor in (qcb, ccb):
        if tensor is not None:
            _broadcast(group, tensor.to(group.transport), grid=True)


def gather_rows(group: PanelGroup, blob, counters):
    """Rank 0 of a grid with R > 1 rows: receive each other row's decision
    rows into its rows of `blob` ((R * share * total,) uint8, host memory)
    and its counter vector into row r of `counters` ((R, L), host
    memory), in row order. Under NCCL they arrive on rank 0's card and are
    copied into the host buffers on the current stream, non-blocking."""
    share = blob.numel() // group.rows
    for row in range(1, group.rows):
        for target in (blob[row * share : (row + 1) * share], counters[row]):
            if group.transport.type == "cpu":
                _collective(dist.recv, target, row * group.size, group=group.leaders)
            else:
                landed = torch.empty(target.shape, dtype=target.dtype, device=group.transport)
                _collective(dist.recv, landed, row * group.size, group=group.leaders)
                target.copy_(landed, non_blocking=True)


def send_stop(group: PanelGroup, segments: int):
    """Rank 0: the end of the run; the row leaders release their rows, and
    every rank returns."""
    stop = [STOP] + [0] * (_FIELDS - 1 + segments)
    if group.rows > 1:
        _header(group, segments, stop, grid=True)
    _header(group, segments, stop)
    dist.barrier(group=group.setup)
    close_panel_group()


def _step_for(steps: dict, instrument, signature: tuple, **options):
    from .step import DecodeStep

    step = steps.get(signature)
    if step is None:
        step = steps[signature] = DecodeStep(instrument, list(signature[1]), signature[2], **options)
    return step


def follow(device="cuda") -> int:
    """A panel follower's whole run (column p > 0): take the layout and this
    rank's shards from rank 0, then for every batch its row leader
    broadcasts run K3 and K8's stages on the shards, taking part in the
    row's merges; write nothing. Returns the number of batches followed."""
    group = panel_group(device)
    instrument, shards = share_instrument(None, group)
    segments = len(instrument.used_segments)
    steps: dict = {}
    batches = 0
    with torch.no_grad():
        while True:
            command, padded_n, qual_code, qcb_len, ccb_len, _, *widths = _header(group, segments)
            if command == STOP:
                break
            qual_bits = _QUAL_BITS[qual_code]
            blob = torch.empty(
                (padded_n, wire.h2d_blob_bytes(widths, qual_bits)), dtype=torch.uint8, device=group.device
            )
            _broadcast(group, blob)
            qcb, ccb = _receive_books(group, qcb_len, ccb_len)
            signature = (padded_n, tuple(widths), qual_bits)
            step = _step_for(steps, instrument, signature, want_uncertain=False, panel_shards=shards, group=group)
            step.follow(blob, ccb, qcb)
            batches += 1
    dist.barrier(group=group.setup)
    close_panel_group()
    return batches


def lead_row(device="cuda") -> int:
    """A row leader's whole run (row r > 0, column 0): take rank 0's
    instrument and this rank's shards, then for every batch receive the
    row's slice of it from rank 0, broadcast it to the row's followers,
    run the whole decode step on it (K3, K1/K6 on whole panels, K8 merged
    within the row on sharded ones, K4, K5) and send its decision rows and
    counter vector back to rank 0; write nothing. Returns the number of
    batches led."""
    group = panel_group(device)
    instrument, shards = share_instrument(None, group)
    segments = len(instrument.used_segments)
    steps: dict = {}
    batches = 0
    with torch.no_grad():
        while True:
            header = _header(group, segments, grid=True)
            command, padded_n, qual_code, qcb_len, ccb_len, uncertain, *widths = header
            if command == STOP:
                _header(group, segments, header)
                break
            qual_bits = _QUAL_BITS[qual_code]
            share = padded_n // group.rows
            blob = torch.empty(
                (share, wire.h2d_blob_bytes(widths, qual_bits)), dtype=torch.uint8, device=group.transport
            )
            _collective(dist.recv, blob, 0, group=group.leaders)
            books = _receive_books(group, qcb_len, ccb_len, grid=True)
            blob = blob.to(group.device)
            qcb, ccb = (None if t is None else t.to(group.device) for t in books)
            signature = (share, tuple(widths), qual_bits)
            send_batch(group, signature, blob, ccb, qcb)
            step = _step_for(steps, instrument, signature, want_uncertain=bool(uncertain), panel_shards=shards,
                             group=group)
            out, flat = step(blob, ccb, qcb)
            for tensor in (out, flat):
                _collective(dist.send, tensor.to(group.transport), 0, group=group.leaders)
            batches += 1
    dist.barrier(group=group.setup)
    close_panel_group()
    return batches
