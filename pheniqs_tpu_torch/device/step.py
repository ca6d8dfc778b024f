"""The decode step: one batch of wire bytes in, the packed decision blob
and the flat counter vector out.

``DecodeStep`` ports ``pheniqs_tpu.device.step.make_decode_step`` in the
configuration the engines run: wire input (``h2d_widths``) in any
quality regime, packed outputs, counters, and (hybrid) the uncertain
mask. Its forward pass is these kernels in order:

  K3 unpack_tokens    wire blob -> every PAMLD and MDD decoder's (N, W) tokens
  K1 pamld_classify   once per PAMLD decoder (K7 past 1024 barcodes, K8
  K6 mdd_classify     on a sharded panel), or MDD decoder, in classify
                      order, chaining qcfail
  K4 counters         (B+1)-bin statistics of the valid rows, flat
  K5 pack_outputs     the (N * total,) uint8 decision blob (d2h_layout)

With ``panel_shards`` it is also the counterpart of
``make_tp_sharded_decode_step`` (step.py:831-925): each PAMLD decoder in
``panel_shards`` classifies through K8 over the shards this process holds,
merging over ``group`` (device/tp.py); on a row leader of the grid (rank 0
among them) everything else runs as above, on the merged decisions, so
the row's counters come back whole there. A panel follower runs
``follow``: K3 and its shards' stages only. Under ``PHENIQS_TP="R:P"``
rank 0 pads a batch to a multiple of R (the engine's staging rows, as
``pad_rows`` does), each row decodes one of R contiguous slices, and the
rows' blobs are concatenated and their counters added with ``slice_sum``,
as for ``ShardedDecodeStep``.

``ShardedDecodeStep`` is the counterpart of ``make_sharded_decode_step``
and ``pad_batch`` (step.py:759, :804): a batch cut into R contiguous
slices in read order, one ``DecodeStep`` per slice on its own card and
CUDA stream, the decision blobs concatenated in slice order and the
counter vectors added in float64 in slice order.

On CUDA each is a hand-written kernel; on the CPU each wrapper runs its
plain version. Panel tensors stay on the instrument's device; per batch
the step allocates only its outputs and the stacked per-decoder rows.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..kernels import Decisions
from ..kernels.counters import counters, counters_plain, row_slices
from ..kernels.mdd import mdd_classify, mdd_classify_plain
from ..kernels.pack import pack_outputs, pack_outputs_plain
from ..kernels.pamld import pamld_classify, pamld_classify_plain, pamld_classify_sharded
from ..kernels.unpack import token_layout, unpack_tokens, unpack_tokens_plain
from . import wire
from .instrument import DeviceInstrument, card_index


class DecodeStep(nn.Module):
    """(blob, ccb, qcb) -> (blob_out (N * total,) uint8, counters (L,) f32)
    for one wire shape: segment ``widths`` and quality regime
    ``qual_bits`` (6, 2, 4 or "j4")."""

    def __init__(
        self,
        instrument: DeviceInstrument,
        widths: list[int],
        qual_bits=6,
        want_uncertain: bool = True,
        panel_shards: dict | None = None,
        group=None,
    ):
        super().__init__()
        self.instrument = instrument
        self.want_uncertain = want_uncertain
        #: decoder position -> the PanelShards of it this process holds
        self.panel_shards = panel_shards or {}
        #: the PanelGroup the shards merge over (None: every shard here)
        self.group = group
        self.layout = token_layout(instrument, widths, qual_bits)
        self.register_buffer(
            "program",
            torch.from_numpy(self.layout.program).to(instrument.device),
            persistent=False,
        )

    #: the step's stages in order, as ``run_to`` names them
    STAGES = ("unpack", "classify", "counters", "pack")

    def forward(self, blob, ccb=None, qcb=None):
        return self._run(blob, ccb, qcb, plain=False)

    def run_to(self, stage: str, blob, ccb=None, qcb=None):
        """The step's kernels up to and including `stage`, on forward's own
        code path (tools/profile_step.py's rungs): "unpack" returns K3's
        tokens, "classify" the Decisions after every decoder's K1/K6 in
        classify order, "counters" (decisions, flat) after K4, "pack"
        forward's (blob, flat)."""
        if stage not in self.STAGES:
            raise ValueError(f"unknown stage {stage!r}: one of {self.STAGES}")
        return self._run(blob, ccb, qcb, plain=False, stop=stage)

    def forward_plain(self, blob, ccb=None, qcb=None):
        """The same step through every kernel's plain torch version, on
        whatever device ``blob`` is (the reference the kernels are held to)."""
        return self._run(blob, ccb, qcb, plain=True)

    def follow(self, blob, ccb=None, qcb=None):
        """A follower rank's part of the step: K3, then K8's stages on its
        shard of each sharded decoder, taking part in the merges."""
        layout = self.layout
        tokens = unpack_tokens(self.instrument, layout, self.program, blob, ccb, qcb)
        slot = 0
        for k, dec in enumerate(self.instrument.decoders):
            if dec.algorithm not in ("pamld", "mdd") or not dec.plans:
                continue
            if k in self.panel_shards:
                codes, quals, _, _ = tokens.observation(layout, slot)
                pamld_classify_sharded(
                    dec, self.panel_shards[k], codes, quals, None,
                    tpq_constants=self.instrument.tpq_constants, group=self.group, finish=False,
                )
            slot += 1

    def _run(self, blob, ccb, qcb, plain: bool, stop: str = "pack"):
        instrument = self.instrument
        layout = self.layout
        want_uncertain = self.want_uncertain
        if plain:
            tokens = unpack_tokens_plain(instrument, layout, blob, ccb=ccb, qcb=qcb)
        else:
            tokens = unpack_tokens(instrument, layout, self.program, blob, ccb, qcb)
        if stop == "unpack":
            return tokens
        n = blob.shape[0]
        decisions = Decisions.zeros(len(instrument.decoders), n, blob.device)
        qcfail = tokens.qcfail
        slot = 0
        for k, dec in enumerate(instrument.decoders):
            row = decisions.row(k)
            if dec.algorithm in ("pamld", "mdd") and dec.plans:
                codes, quals, lengths, short = tokens.observation(layout, slot)
                slot += 1
                short = short if want_uncertain else None
                if dec.algorithm == "mdd":
                    # integer-exact: never uncertain
                    if plain:
                        result = mdd_classify_plain(dec, codes, quals, lengths, qcfail)
                        for key, value in result.items():
                            row[key].copy_(value)
                    else:
                        mdd_classify(dec, codes, quals, lengths, qcfail, out=row)
                elif k in self.panel_shards:
                    pamld_classify_sharded(
                        dec, self.panel_shards[k], codes, quals, qcfail,
                        tpq_constants=instrument.tpq_constants, want_uncertain=want_uncertain,
                        eps=instrument.tpq_analytic_eps, short=short, out=row, group=self.group,
                        plain=plain,
                    )
                elif plain:
                    result = pamld_classify_plain(
                        dec, codes, quals, qcfail, want_uncertain=want_uncertain,
                        eps=instrument.tpq_analytic_eps, short=short,
                    )
                    for key, value in result.items():
                        row[key].copy_(value)
                else:
                    pamld_classify(
                        dec, codes, quals, qcfail,
                        tpq_constants=instrument.tpq_constants,
                        want_uncertain=want_uncertain,
                        eps=instrument.tpq_analytic_eps,
                        short=short, out=row,
                    )
            else:
                # naive / passthrough: no decision, qcfail passes through
                row["qcfail"].copy_(qcfail)
            qcfail = row["qcfail"]
        if stop == "classify":
            return decisions
        if plain:
            flat = counters_plain(instrument, decisions, tokens.pad, tokens.forced, want_uncertain)
        else:
            flat = counters(instrument, decisions, tokens.pad, tokens.forced, want_uncertain)
        if stop == "counters":
            return decisions, flat
        if plain:
            packed = pack_outputs_plain(instrument, decisions, tokens.forced, want_uncertain)
        else:
            packed = pack_outputs(instrument, decisions, tokens.forced, want_uncertain)
        return packed, flat


def pad_rows(blob, multiple: int):
    """`blob` with H2D_PAD | H2D_QCFAIL rows appended up to a multiple of
    `multiple` rows (the counterpart of ``pad_batch``): K4 leaves padding
    rows out of the counters, so nothing needs subtracting afterwards."""
    n = blob.shape[0]
    padded = -(-n // multiple) * multiple
    if padded == n:
        return blob
    rows = torch.zeros((padded - n, blob.shape[1]), dtype=blob.dtype, device=blob.device)
    rows[:, -1] = wire.H2D_PAD | wire.H2D_QCFAIL
    return torch.cat([blob, rows])


def slice_sum(counters):
    """The counter vector of a batch from its slices' rows of `counters`
    ((R, L), any float type): added in float64 in slice order, so the
    bytes do not depend on which card finished first."""
    total = counters[0].to(torch.float64, copy=True)
    for row in counters[1:]:
        total += row
    return total


class ShardedDecodeStep:
    """The decode step data parallel over the reads: slice r of a batch
    runs through its own ``DecodeStep`` on the device of ``instruments[r]``
    (``instrument.instruments_on``: cards may repeat, and two slices on one
    card run on two streams). One host thread enqueues every slice back to
    back, each on its card's stream, so the cards run together.

    ``upload`` and ``launch`` are the one split, decode and gather that
    every caller runs: the engine from its pinned staging rows into pinned
    host buffers, ``forward`` from a tensor on any device into tensors on
    that device, multichip_bench's device step as the engine does. With
    one instrument ``forward`` is that instrument's DecodeStep, with
    nothing added."""

    def __init__(self, instruments: list[DeviceInstrument], widths: list[int], qual_bits=6,
                 want_uncertain: bool = True):
        # indexed ("cuda" is the current card when built), so that each
        # slice names its card wherever it runs
        self.devices = [
            torch.device("cuda", card_index(i.device)) if i.device.type == "cuda" else i.device for i in instruments
        ]
        self.steps = [
            DecodeStep(instrument, widths, qual_bits, want_uncertain=want_uncertain) for instrument in instruments
        ]
        sharded = len(self.devices) > 1
        self.streams = [
            torch.cuda.Stream(device) if sharded and device.type == "cuda" else None for device in self.devices
        ]
        #: bytes of one row of the decision blob, entries of the counter vector
        self.total = wire.d2h_layout(instruments[0], want_uncertain)["total"]
        self.length = sum(size for _, _, size in wire.counter_layout(instruments[0]))
        #: slice -> ((ccb, qcb) as given, (ccb, qcb) on the slice's card)
        self._books: dict = {}

    @property
    def size(self) -> int:
        return len(self.steps)

    def bounds(self, n: int) -> list[tuple[int, int]]:
        """(start, stop) of each slice of a batch of `n` rows, `n` a
        multiple of the slice count: contiguous, in read order."""
        share = n // self.size
        return [(r * share, (r + 1) * share) for r in range(self.size)]

    @contextlib.contextmanager
    def on(self, r: int):
        """Slice r's card as the current device and its stream as the
        current stream (nothing on the CPU or with one slice): the kernels
        launch on the current device's current stream."""
        stream = self.streams[r]
        if stream is None:
            yield
            return
        with torch.cuda.device(self.devices[r]), torch.cuda.stream(stream):
            yield

    def _mark(self, r: int, events: list):
        """An event on slice r's current stream, added to `events` (nothing
        on the CPU)."""
        if self.devices[r].type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.devices[r]))
            events.append(event)

    def _codebooks(self, r: int, ccb, qcb):
        """(ccb, qcb) on slice r's card, placed once for the books given."""
        placed = self._books.get(r)
        if placed is None or placed[0][0] is not ccb or placed[0][1] is not qcb:
            placed = ((ccb, qcb), tuple(None if t is None else t.to(self.devices[r]) for t in (ccb, qcb)))
            self._books[r] = placed
        return placed[1]

    def upload(self, rows):
        """Slice r of `rows` (a multiple of the slice count: pad_rows) on
        card r, copied on its card's stream, non-blocking from pinned host
        rows: (pieces, events), one event a card after its copy (none on
        the CPU), after which `rows` may be rewritten."""
        source = torch.cuda.current_stream(rows.device) if rows.is_cuda else None
        pieces, events = [], []
        for r, (start, stop) in enumerate(self.bounds(rows.shape[0])):
            stream = self.streams[r]
            with self.on(r):
                if stream is not None and source is not None:
                    stream.wait_stream(source)
                pieces.append(rows[start:stop].to(self.devices[r], non_blocking=True))
                if stream is not None and pieces[-1].device == rows.device:
                    rows.record_stream(stream)  # read on this stream after the caller lets go
                self._mark(r, events)
        return pieces, events

    def launch(self, pieces, ccb=None, qcb=None, to="cpu"):
        """Decode each slice of `upload` on its card and copy its decisions
        into its rows of one blob on `to`, its counters into its row of an
        (R, L) array there (f32, or float64 where K4 sums a slice in row
        slices), both pinned on the host when the cards are CUDA: (blob,
        counters, events), one event a card after its copies (none on the
        CPU). Read them once every event has completed; slice_sum gives
        the batch's counter vector."""
        to = torch.device(to)
        pin = to.type == "cpu" and self.devices[0].type == "cuda"
        rows = sum(piece.shape[0] for piece in pieces)
        wide = len(row_slices(self.steps[0].instrument, pieces[0].shape[0])) > 1
        blob = torch.empty(rows * self.total, dtype=torch.uint8, device=to, pin_memory=pin)
        counters = torch.empty((self.size, self.length), dtype=torch.float64 if wide else torch.float32,
                               device=to, pin_memory=pin)
        # the outputs' memory on a card: free of the target stream's work
        target = torch.cuda.current_stream(to) if to.type == "cuda" else None
        events, start = [], 0
        for r, piece in enumerate(pieces):
            stop = start + piece.shape[0]
            with self.on(r):
                if target is not None and self.streams[r] is not None:
                    self.streams[r].wait_stream(target)
                out, flat = self.steps[r](piece, *self._codebooks(r, ccb, qcb))
                blob[start * self.total : stop * self.total].copy_(out, non_blocking=True)
                counters[r].copy_(flat, non_blocking=True)
                self._mark(r, events)
            start = stop
        return blob, counters, events

    def __call__(self, blob, ccb=None, qcb=None):
        return self.forward(blob, ccb, qcb)

    def forward(self, blob, ccb=None, qcb=None):
        """(blob_out, counters) of one batch, `blob` on any device: padded
        to a multiple of the slice count (pad_rows), then upload and launch
        into tensors on `blob`'s device, which its current stream waits
        for; the padding rows' decisions cut off (the bytes one DecodeStep
        gives) and the counters added in float64 in slice order."""
        if self.size == 1:
            return self.steps[0](blob, ccb, qcb)
        n = blob.shape[0]
        pieces, _ = self.upload(pad_rows(blob, self.size))
        out, counters, events = self.launch(pieces, ccb, qcb, to=blob.device)
        for event in events:
            if blob.is_cuda:
                torch.cuda.current_stream(blob.device).wait_event(event)
            else:
                event.synchronize()
        return out[: n * self.total], slice_sum(counters)
