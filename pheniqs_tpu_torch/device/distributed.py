"""Scale-out of the port (counterpart of ``pheniqs_tpu/device/distributed.py``).

Reads are pure data parallelism. Within a process the engine cuts each
batch into contiguous slices, one per local card (``reads_devices``,
capped by the ontology's ``"devices"``), and runs them through
``device/step.py:ShardedDecodeStep``; the slices' counters add in float64
in slice order. Across hosts each process owns the round-robin batches of
``PHENIQS_SHARD=k:H`` (``host_batch_slices``), after
``initialize_multihost``; ``tools/merge.py`` recombines the per-host
``PHENIQS_PARTIAL`` statistics, and ``merge_host_accumulators`` merges
engines held in one process.

``PHENIQS_TP="R:P"`` runs the engine as a (reads, panel) grid of R * P
processes, one rank each, as ``torchrun`` starts them:

    PHENIQS_TP=2:2 torchrun --standalone --nproc-per-node 4 \\
        -m pheniqs_tpu_torch mux --config job.json --fidelity hybrid

Grid rank g sits at row ``g // P`` and column ``g % P``. Rank 0 leads the
whole host pipeline and row 0; it cuts each batch into R contiguous slices
in read order and sends slice r to the leader of row r (rank r * P), which
decodes it with the whole decode step and returns its decision rows and
counter vector; the rows' counters add in float64 in row order on rank 0.
Every rank of column p holds shard p of each large PAMLD panel
(device/tp.py, K8), and the shards merge within a row. The group comes
from the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``;
``env://``).

The backend follows from where the ranks' tensors live, with no knob of
its own: NCCL when every rank of the host has a GPU of its own, gloo on
CUDA tensors when ranks share a card (gloo stages them through host
memory), gloo on the CPU. Set-up objects (the instrument, the panel
shards) always travel over a gloo group on the CPU.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

import torch
import torch.distributed as dist

#: panels above this many barcodes shard across the panel axis (the JAX
#: engine's default, pheniqs_tpu/engine/device.py:181-183)
DEFAULT_TP_THRESHOLD = 1 << 14


def tp_shape() -> tuple[int, int] | None:
    """(R, P) of ``PHENIQS_TP="R:P"``, None when unset: R rows of the reads
    axis by P columns of the panel axis, each at least 1 (ValueError
    otherwise)."""
    value = os.environ.get("PHENIQS_TP")
    if not value:
        return None
    try:
        reads, panel = (int(x) for x in value.split(":"))
    except ValueError:
        raise ValueError(f"PHENIQS_TP={value}: expected R:P, two integers") from None
    if reads < 1 or panel < 1:
        raise ValueError(f"PHENIQS_TP={value}: the reads and panel axes need at least one rank each")
    return reads, panel


def tp_threshold() -> int:
    """``PHENIQS_TP_THRESHOLD``: the barcode count above which a PAMLD
    panel is sharded."""
    return int(os.environ.get("PHENIQS_TP_THRESHOLD", DEFAULT_TP_THRESHOLD))


def is_leader() -> bool:
    """False on every rank of a ``PHENIQS_TP`` run but rank 0."""
    return not os.environ.get("PHENIQS_TP") or int(os.environ.get("RANK", "0")) == 0


def is_row_leader() -> bool:
    """True on the leader of a row of a ``PHENIQS_TP`` grid (column 0:
    RANK a multiple of P), rank 0 included; True without PHENIQS_TP."""
    shape = tp_shape()
    return shape is None or int(os.environ.get("RANK", "0")) % shape[1] == 0


@dataclass
class PanelGroup:
    """This process's place on the (reads, panel) grid: its global
    ``rank`` of ``rows * size`` (``size`` ranks a row, the panel axis), its
    device, the backend of the per-batch collectives, the process group of
    its row (the batch broadcast and the panel merges, on ``device``
    tensors), the group of the row leaders (the slices out and the rows'
    results back; None off it) and the gloo group of the whole grid for the
    set-up (CPU objects)."""

    rank: int
    rows: int
    size: int
    device: torch.device
    backend: str
    group: object
    leaders: object
    setup: object

    @property
    def row(self) -> int:
        return self.rank // self.size

    @property
    def column(self) -> int:
        return self.rank % self.size

    @property
    def row_leader_rank(self) -> int:
        """The global rank of this row's leader (column 0)."""
        return self.row * self.size

    @property
    def leader(self) -> bool:
        return self.rank == 0

    @property
    def row_leader(self) -> bool:
        return self.column == 0

    @property
    def transport(self) -> torch.device:
        """Where the tensors between rank 0 and the row leaders live: the
        card under NCCL, host memory under gloo (which would stage a CUDA
        tensor through the host anyway)."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


_GROUP: PanelGroup | None = None


def panel_group(device) -> PanelGroup:
    """The grid group of this process, set up on first call from the
    ``torchrun`` environment. ``device`` is the engine's device type
    ("cuda" or "cpu"); on CUDA the rank's card is ``cuda:LOCAL_RANK`` when
    the host has a card per rank, else the ranks share them. Every rank
    creates every row's group and the row leaders' group, in the same
    order."""
    global _GROUP
    if _GROUP is not None:
        return _GROUP
    reads, panel = tp_shape()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != reads * panel:
        raise ValueError(
            f"PHENIQS_TP={reads}:{panel} needs {reads * panel} ranks (torchrun --nproc-per-node "
            f"{reads * panel}); WORLD_SIZE is {world}"
        )
    rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA GPU is available")
        cards = torch.cuda.device_count()
        backend = "nccl" if cards >= local_size else "gloo"
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device}")
    dist.init_process_group(backend=backend, init_method="env://", rank=rank, world_size=world)
    setup = dist.new_group(backend="gloo") if backend != "gloo" else dist.group.WORLD
    if reads == 1:
        row_group, leaders = dist.group.WORLD, None
    else:
        for row in range(reads):
            created = dist.new_group(list(range(row * panel, (row + 1) * panel)))
            if row == rank // panel:
                row_group = created
        leaders = dist.new_group(list(range(0, world, panel)))
        if rank % panel:
            leaders = None
    sys.stderr.write(
        f"[pheniqs-tpu] PHENIQS_TP rank {rank} of {world} (row {rank // panel} of {reads}, column "
        f"{rank % panel} of {panel}): {backend} on {device}\n"
    )
    _GROUP = PanelGroup(rank, reads, panel, device, backend, row_group, leaders, setup)
    return _GROUP


def close_panel_group():
    """Tear the process group down (the end of a rank's run)."""
    global _GROUP
    if _GROUP is not None:
        dist.destroy_process_group()
        _GROUP = None


def reads_devices(device="cuda", limit=None) -> list[torch.device]:
    """This process's devices on the reads axis (the counterpart of
    ``reads_mesh``): every local card ``cuda:0..n-1`` for ``"cuda"``, the
    one device named otherwise (``"cuda:k"``, ``"cpu"``), or an explicit
    list as given (``["cuda:0", "cuda:0"]``: two slices on one card;
    ``["cpu"] * 8``: eight CPU slices, as the reference's virtual CPU
    mesh). ``limit`` (the ontology's ``"devices"``) keeps the first
    ``limit`` of them when positive."""
    from .instrument import resolve_device

    if isinstance(device, (list, tuple)):
        devices = [resolve_device(d) for d in device]
    else:
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            devices = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
        else:
            devices = [device]
    if not devices:
        raise ValueError("reads_devices: no device given")
    if limit is not None and int(limit) > 0:
        devices = devices[: int(limit)]
    return devices


def initialize_multihost() -> tuple[int, int]:
    """Join the hosts' process group from ``torch.distributed``'s
    ``env://`` environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``), over gloo: it carries only host-side
    aggregates. Returns (process_id, num_processes); (0, 1) when
    ``WORLD_SIZE`` is unset or 1, or under ``PHENIQS_TP``, whose ranks
    belong to the panel group (``panel_group``)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or os.environ.get("PHENIQS_TP"):
        return 0, 1
    rank = int(os.environ["RANK"])
    if not dist.is_initialized():
        dist.init_process_group(backend="gloo", init_method="env://", rank=rank, world_size=world)
    return rank, world


def host_batch_slices(process_id: int, num_processes: int):
    """Infinite round-robin predicate: does this host own batch `index`?"""

    def owns(index: int) -> bool:
        return index % num_processes == process_id

    return owns


def merge_host_accumulators(engines: list) -> None:
    """Merge per-shard host accumulators into the first engine's: the
    host-side analog of Transcode::collect for the float64 report state.
    Every field is a sum/min/max, so merging is order-insensitive."""
    if len(engines) <= 1:
        return
    primary = engines[0]
    for other in engines[1:]:
        for mine, theirs in zip(primary._partial_runtimes(), other._partial_runtimes()):
            mine.accumulator.collect(theirs.accumulator)
        primary.incoming_count += other.incoming_count
        primary.incoming_pf_count += other.incoming_pf_count
        primary.outgoing_count += other.outgoing_count
        primary.outgoing_pf_count += other.outgoing_pf_count
        if primary.channel_quality is not None and other.channel_quality:
            for mine, theirs in zip(primary.channel_quality, other.channel_quality):
                mine.merge(theirs)
