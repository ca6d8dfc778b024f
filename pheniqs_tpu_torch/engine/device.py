"""The device engines: ``TorchDeviceEngine`` and ``TorchStreamedDeviceEngine``,
the port's counterparts of ``pheniqs_tpu/engine/device.py``'s
``DeviceEngine`` and ``StreamedDeviceEngine``.

Same host pipeline as the strict engine (feeds, template assembly, SAM
emission, accumulators, report), with classification on the device
through the decode step (device/step.py): lookahead dispatch, the f64
re-resolution of flagged rows (``_resolve_rows``), the scratch carry and
the streamed render workers are the reference's code; wire sensing and
packing, the transfers, the decision pull and the counter merge are
written for torch.

Transfers on CUDA: each batch is packed into a pinned staging buffer on
the ingest thread and copied up with ``non_blocking=True``; an event
recorded after the copy guards the buffer, which is not rewritten before
that event completes. Results come back into pinned buffers with one
event per batch, waited on before the host reads them. The render workers
are forked after CUDA is initialised and never touch it: they receive
NumPy decisions through shared memory only.

Data parallel over the reads: with more than one device (every local
card for ``device="cuda"``, capped by the ontology's ``"devices"``, or an
explicit ``devices=[...]``) each batch's staging buffer is cut into
contiguous slices, one per card; ``device/step.py:ShardedDecodeStep``'s
upload and launch copy each slice up, decode it and pull it back into its
rows of one pinned buffer on its card's stream, with one event per card
for the staging buffer and one for the results, on the CPU as on CUDA.
The counters of the slices add in float64 in slice order.

``PHENIQS_TP="R:P"`` (device/distributed.py) runs this engine on rank 0
of the R x P grid: its instrument is compiled on the CPU and shared with
the other ranks, which hold the other shards of each large PAMLD panel
(device/tp.py). With R = 1 each batch's wire blob is broadcast to rank
0's row before the step runs. With R > 1 the staging rows are padded to a
multiple of R and cut into R contiguous slices: rank 0 uploads only its
own, sends the others from the staging rows to their row leaders
(``tp.scatter_rows``), runs its row's step, and takes the other rows'
decision rows and counters back into its pinned buffers
(``tp.gather_rows``); the rows' counters add in float64 in row order.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..decode.oracle import BRANCH_PASS, ClassifyResult, mdd_classify, pamld_classify
from ..device import wire
from ..device.distributed import panel_group, reads_devices, tp_shape
from ..device.instrument import compile_instrument, instruments_on, resolve_device
from ..device.step import DecodeStep, ShardedDecodeStep, slice_sum
from ..kernels import check_kernel_limits
from ..model.batch import ReadBatch
from ..transform import SegmentBatch
from .strict import ClassifierRuntime, StrictEngine


def _round_up(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


class TorchDeviceEngine(StrictEngine):
    """Accelerator classification engine on an explicit torch ``device``
    ("cuda" or "cpu"; "cuda" raises when no GPU is present).

    ``hybrid=True`` adds float64 re-resolution: the device step flags reads
    whose f32 posterior lies within rounding distance of an argmax tie or a
    filter threshold (plus reads with observations shorter than the decoder
    token, whose strict semantics depend on the serial scratch carry); those
    rows are re-classified with the exact NumPy oracle, guaranteeing
    reference-identical classification decisions at device throughput.

    ``devices`` (a list, cards may repeat) sets the reads axis explicitly;
    by default it is ``distributed.reads_devices(device)``. Either is
    capped by the ontology's ``"devices"``.
    """

    def __init__(self, ontology: dict, hybrid: bool = False, device="cuda", devices=None):
        tp = tp_shape()
        #: the grid group of a PHENIQS_TP run (this engine is its rank 0),
        #: joined first: a world of the wrong size fails before the host set-up
        self._panel = None if tp is None else panel_group(resolve_device(device))
        super().__init__(ontology)
        self.hybrid = hybrid
        self._shards: dict = {}
        if tp is not None:
            from ..device.tp import share_instrument

            if not self._panel.leader:
                raise RuntimeError("a PHENIQS_TP follower rank runs device.tp.follow, not an engine")
            self.device = self._panel.device
            self.instrument, self._shards = share_instrument(
                compile_instrument(ontology, "cpu"), self._panel
            )
            self.devices = [self.device]
            self._slices = self._panel.rows
        else:
            self.devices = reads_devices(device if devices is None else devices, ontology.get("devices"))
            self.device = self.devices[0]
            if self.device.type == "cuda" and self.device.index is not None:
                # kernels launch on the current device's streams and events
                torch.cuda.set_device(self.device)
            self.instrument = compile_instrument(ontology, self.device)
            self._slices = len(self.devices)
        #: the instrument on each device of the reads axis
        self._instruments = instruments_on(self.instrument, self.devices)
        if self.device.type == "cuda":
            # refuse what no block of a kernel holds before the first batch
            for instrument in self._instruments:
                check_kernel_limits(instrument)
        # classify order must match device.instrument.compile_instrument:
        # sample, molecular*, cellular* (reference transcode.h:51-65)
        self._runtimes: list[ClassifierRuntime] = []
        if self.sample is not None:
            self._runtimes.append(self.sample)
        self._runtimes.extend(self.molecular)
        self._runtimes.extend(self.cellular)
        self._step_cache: dict[tuple, DecodeStep | ShardedDecodeStep] = {}
        self._pad_bucket: int | None = None
        self._width_buckets: list[int] | None = None
        self._current_batch: ReadBatch | None = None
        self._batch_results: list[dict] | None = None
        self._predispatched = None
        # rotating staging buffers: the ingest thread packs up to ~6
        # batches ahead of dispatch, so a buffer comes round again only
        # after its batch was dispatched; its H2D events (one a card) then
        # say when the copies have read it. None marks a buffer packed but
        # not yet uploaded.
        self._staging: dict[tuple, tuple] = {}
        self._staging_events: dict[tuple, object] = {}
        self._staging_flip = 0
        self._staging_sets = max(1, int(os.environ.get("PHENIQS_LOOKAHEAD", "4"))) + 6
        # the quality wire (device/wire.py): sensed from the first batch;
        # lossy rows re-resolve via the f64 oracle, so the codebook wire is
        # hybrid-only unless PHENIQS_QUAL_WIRE forces it
        self._qual_bits = 6
        self._qcb = None
        self._ccb = None
        self._qual_lut = None
        self._qcb_device = None
        self._ccb_device = None
        self._qual_sensed = False

    # --- device dispatch -------------------------------------------------
    def _get_step(self, signature: tuple) -> DecodeStep | ShardedDecodeStep:
        step = self._step_cache.get(signature)
        if step is None:
            if len(self.devices) > 1:
                step = ShardedDecodeStep(self._instruments, list(signature[1]), signature[2],
                                         want_uncertain=self.hybrid)
            else:
                step = DecodeStep(
                    self.instrument, list(signature[1]), signature[2],
                    want_uncertain=self.hybrid, panel_shards=self._shards, group=self._panel,
                )
            self._step_cache[signature] = step
        return step

    def _sense_qual_wire(self, used):
        """Pick the wire regime from the first batch's within-length
        alphabet. Modern binned basecallers emit <= 16 distinct (base,
        quality) pairs (NovaSeq RTA3: {A,C,G,T} x {12,23,37} + (N,2)), so
        both lanes collapse into one 4-bit joint lane; a rich quality
        alphabet over few values rides a 2/4-bit quality lane;
        Sanger-scale data keeps the lossless 6-bit layout. Later reads
        outside the sensed codebook are packed nearest + H2D_FORCED, which
        the hybrid engine re-resolves in exact f64, so the codebook wire is
        restricted to hybrid mode unless PHENIQS_QUAL_WIRE forces it."""
        self._qual_sensed = True
        mode = os.environ.get("PHENIQS_QUAL_WIRE", "auto")
        if mode not in ("auto", "j4", "2", "4", "6"):
            mode = "auto"
        if mode == "auto" and not self.hybrid:
            return  # fast mode never re-resolves forced rows: stay lossless
        values = []
        pair_sets = []
        for s in used:
            code = np.asarray(s.code)
            qual = np.asarray(s.quality)
            keys = (code.astype(np.int64) & 15) << 8 | np.minimum(qual.astype(np.int64), 63)
            mask = (
                np.arange(qual.shape[1], dtype=np.int32)[None, :]
                < np.asarray(s.length, dtype=np.int32)[:, None]
            )
            values.append(np.unique(qual[mask]))
            pair_sets.append(np.unique(keys[mask]))
        values = np.unique(np.concatenate(values)) if values else np.empty(0)
        pairs = (
            np.unique(np.concatenate(pair_sets)) if pair_sets else np.empty(0, dtype=np.int64)
        )
        trace = os.environ.get("PHENIQS_TRACE") == "1"
        if mode in ("auto", "j4"):
            joint = wire.sense_joint_codebook(pairs)
            if joint is not None:
                self._ccb, self._qcb, lut_idx, lut_exact = joint
                self._qual_bits = wire.JOINT4
                self._qual_lut = (lut_idx, lut_exact)
                if trace:
                    sys.stderr.write(
                        "[pheniqs-tpu] quality wire: joint 4-bit pair "
                        f"codebook ({pairs.size} pairs)\n"
                    )
                return
            if mode == "j4":
                return  # forced joint but alphabet too rich: stay 6-bit
        qual_bits, qcb, lut_idx, lut_exact = wire.sense_qual_codebook(values, mode)
        self._qual_bits = qual_bits
        if qual_bits != 6:
            self._qcb = qcb
            self._qual_lut = (lut_idx, lut_exact)
            if trace:
                sys.stderr.write(
                    f"[pheniqs-tpu] quality wire: {qual_bits}-bit codebook "
                    f"{sorted(set(int(x) for x in qcb))}\n"
                )

    def _codebooks(self):
        """(ccb, qcb) of the sensed wire, placed on the device once (a
        sharded step places them on its other cards once)."""
        if self._qcb is not None and self._qcb_device is None:
            self._qcb_device = torch.from_numpy(self._qcb).to(self.device)
            if self._ccb is not None:
                self._ccb_device = torch.from_numpy(self._ccb).to(self.device)
        return self._ccb_device, self._qcb_device

    def _pack_batch(self, batch: ReadBatch):
        """Pack the batch into a staging wire blob at a stable shape
        signature (host only: runs on the ingest thread ahead of
        dispatch). Returns (signature, blob, staging key)."""
        n = batch.size
        # a whole number of rows for each slice of the reads axis (each
        # card's, or each row's of a PHENIQS_TP grid)
        padded_n = _round_up(max(_round_up(n, 1024), 1024), self._slices)
        # pin the batch-size bucket after the first (full) batch so the
        # last partial batch reuses the same step and staging buffers
        if self._pad_bucket is None or padded_n > self._pad_bucket:
            self._pad_bucket = padded_n
        padded_n = self._pad_bucket
        widths = []
        if self._width_buckets is None:
            self._width_buckets = [0] * len(self.instrument.used_segments)
        for position, segment_index in enumerate(self.instrument.used_segments):
            w = _round_up(max(batch.segments[segment_index].width, 1), 4)
            # sticky width buckets: only grow, so signatures stay stable
            w = max(w, self._width_buckets[position])
            self._width_buckets[position] = w
            widths.append(w)
        used = [batch.segments[index] for index in self.instrument.used_segments]
        if not self._qual_sensed:
            self._sense_qual_wire(used)
        signature = (padded_n, tuple(widths), self._qual_bits)
        key = (self._staging_flip, signature)
        self._staging_flip = (self._staging_flip + 1) % self._staging_sets
        pad_flags = wire.H2D_QCFAIL | wire.H2D_PAD
        if key in self._staging_events:
            events = self._staging_events.pop(key)
            if events is None:
                raise RuntimeError("staging buffer came round before its batch was uploaded")
            for event in events:
                event.synchronize()  # every card's previous H2D copy from this buffer is done
        staged = self._staging.get(key)
        if staged is None:
            shape = (padded_n, wire.h2d_blob_bytes(widths, self._qual_bits))
            pinned = torch.zeros(
                shape, dtype=torch.uint8, pin_memory=self.device.type == "cuda"
            )
            staged = (pinned, pinned.numpy())
            # padding rows arrive qcfail=True and counter-masked
            staged[1][:, -1] = pad_flags
            self._staging[key] = staged
        blob = staged[1]
        mark = time.perf_counter()
        wire.pack_h2d_blob(
            widths,
            [(s.code, s.quality, s.length) for s in used],
            batch.qcfail,
            out=blob[:n],
            qual_bits=self._qual_bits,
            qual_lut=self._qual_lut,
        )
        if n < padded_n:
            blob[n:] = 0
            blob[n:, -1] = pad_flags
        self._stage_add("pack", time.perf_counter() - mark)
        self._staging_events[key] = None
        return signature, blob, key

    def _upload(self, blob, key):
        """The wire blob on the device: a non-blocking copy from the pinned
        staging buffer on CUDA (guarded by an event), the buffer itself on
        the CPU."""
        if self.device.type != "cuda":
            # the CPU step reads the buffer synchronously within dispatch
            self._staging_events.pop(key, None)
            return torch.from_numpy(blob)
        pinned = self._staging[key][0]
        device_blob = pinned.to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._staging_events[key] = [event]
        return device_blob

    def _dispatch(self, batch, packed=None):
        """Start one batch on the device: (host blob, host counters, [done
        events]), on CUDA still in flight (no events on the CPU); over
        several devices the counters are one row a slice
        (ShardedDecodeStep.launch) and the events one a card."""
        if packed is None:
            packed = self._pack_batch(batch)
        signature, blob, key = packed
        step = self._get_step(signature)
        if isinstance(step, ShardedDecodeStep):
            mark = time.perf_counter()
            pieces, self._staging_events[key] = step.upload(self._staging[key][0])
            self._stage_add("h2d", time.perf_counter() - mark)
            with torch.no_grad():
                return step.launch(pieces, *self._codebooks())
        if self._slices > 1:
            return self._dispatch_grid(signature, key, step)
        mark = time.perf_counter()
        device_blob = self._upload(blob, key)
        self._stage_add("h2d", time.perf_counter() - mark)
        arguments = (device_blob, *self._codebooks())
        if self._panel is not None:
            from ..device.tp import send_batch

            mark = time.perf_counter()
            send_batch(self._panel, signature, *arguments)
            self._stage_add("tp_broadcast", time.perf_counter() - mark)
        with torch.no_grad():
            out_blob, flat = step(*arguments)
        if self.device.type != "cuda":
            return out_blob, flat, None
        # start the pull now: by the time the lookahead window drains to
        # this batch its decisions are already in host memory
        host_blob = torch.empty(out_blob.shape, dtype=torch.uint8, pin_memory=True)
        # f32, or float64 where K4 summed the batch in row slices
        host_counters = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host_blob.copy_(out_blob, non_blocking=True)
        host_counters.copy_(flat, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host_blob, host_counters, [done]

    def _dispatch_grid(self, signature, key, step):
        """One batch over the rows of a PHENIQS_TP grid (R > 1): the other
        rows' slices go from the staging rows to their leaders, rank 0's
        own slice up to its card, its row's step runs, and the other rows'
        results come back into rank 0's pinned buffers: (host blob, (R, L)
        host counters, [done event]) as ``ShardedDecodeStep.launch``
        returns them (no event on the CPU)."""
        from ..device.tp import gather_rows, scatter_rows, send_batch

        rows = self._staging[key][0]
        share = rows.shape[0] // self._slices
        ccb, qcb = self._codebooks()
        mark = time.perf_counter()
        scatter_rows(self._panel, signature, rows, ccb, qcb, want_uncertain=self.hybrid)
        self._stage_add("tp_scatter", time.perf_counter() - mark)
        mark = time.perf_counter()
        own = rows[:share]
        cuda = self.device.type == "cuda"
        if cuda:
            own = own.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            self._staging_events[key] = [event]
        else:
            # the CPU step reads the rows synchronously within dispatch
            self._staging_events.pop(key, None)
        self._stage_add("h2d", time.perf_counter() - mark)
        mark = time.perf_counter()
        send_batch(self._panel, (share, *signature[1:]), own, ccb, qcb)
        self._stage_add("tp_broadcast", time.perf_counter() - mark)
        with torch.no_grad():
            out_blob, flat = step(own, ccb, qcb)
        host_blob = torch.empty(out_blob.numel() * self._slices, dtype=torch.uint8, pin_memory=cuda)
        host_counters = torch.empty((self._slices, flat.numel()), dtype=flat.dtype, pin_memory=cuda)
        host_blob[: out_blob.numel()].copy_(out_blob, non_blocking=True)
        host_counters[0].copy_(flat, non_blocking=True)
        mark = time.perf_counter()
        gather_rows(self._panel, host_blob, host_counters)
        self._stage_add("tp_gather", time.perf_counter() - mark)
        if not cuda:
            return host_blob, host_counters, None
        done = torch.cuda.Event()
        done.record()
        return host_blob, host_counters, [done]

    def _classify_batch_on_device(self, batch: ReadBatch):
        if self._predispatched is not None:
            handles = self._predispatched
        else:
            handles = self._dispatch(batch)
        host_blob, host_counters, done = handles
        n = batch.size
        # one pull: the packed uint8 blob (device/wire.py d2h_layout)
        layout = wire.d2h_layout(self.instrument, self.hybrid)
        mark = time.perf_counter()
        for event in done or ():
            event.synchronize()
        self._stage_add("pull_wait", time.perf_counter() - mark)
        blob = host_blob.numpy().reshape(-1, layout["total"])[:n]
        ints = (
            np.ascontiguousarray(blob[:, : layout["int_bytes"]])
            .view(np.int32 if layout["wide"] else np.int16)
            .astype(np.int32)
        )
        floats = (
            np.ascontiguousarray(
                blob[:, layout["float_offset"] : layout["float_offset"] + layout["float_bytes"]]
            )
            .view(np.float32)
            .astype(np.float64)
        )
        qc_bytes = blob[
            :, layout["qcfail_offset"] : layout["qcfail_offset"] + layout["qcfail_bytes"]
        ]
        decoded_column = {p: k for k, p in enumerate(layout["decoded_positions"])}
        confidence_column = {p: k for k, p in enumerate(layout["confidence_positions"])}
        results = []
        for k in range(len(self.instrument.decoders)):
            results.append(
                {
                    "decoded": (
                        ints[:, decoded_column[k]]
                        if k in decoded_column
                        else np.zeros(n, dtype=np.int32)
                    ),
                    "confidence": (
                        floats[:, confidence_column[k]]
                        if k in confidence_column
                        else np.zeros(n, dtype=np.float64)
                    ),
                    "qcfail": ((qc_bytes[:, k >> 3] >> (k & 7)) & 1).astype(bool),
                }
            )
        # device-side statistics: merge the masked counter deltas straight
        # into the runtime accumulators (the reference's thread-local
        # collect, transcode.cpp:317-320); hybrid-uncertain rows were
        # excluded on device and are recorded host-side from the oracle
        if host_counters.dim() == 2:
            host_counters = slice_sum(host_counters)
        self._merge_device_counters(host_counters.numpy())
        if self.hybrid:
            uncertain = blob[:, layout["uncertain_offset"]].astype(bool)
            self._batch_rows = np.flatnonzero(uncertain)
            self._rows_qcfail = batch.qcfail[self._batch_rows].copy()
            self._resolved_reads = getattr(self, "_resolved_reads", 0) + self._batch_rows.size
            # a runaway re-resolution rate silently degrades hybrid to
            # strict-engine throughput: warn loudly instead
            self._hybrid_seen = getattr(self, "_hybrid_seen", 0) + batch.size
            if (
                not getattr(self, "_hybrid_rate_warned", False)
                and self._hybrid_seen >= 1 << 19
                and self._resolved_reads > 0.2 * self._hybrid_seen
            ):
                self._hybrid_rate_warned = True
                sys.stderr.write(
                    "[pheniqs-tpu] WARNING: hybrid f64 re-resolution rate "
                    f"is {self._resolved_reads / self._hybrid_seen:.1%}; "
                    "the f32 error bound is flagging most reads and "
                    "throughput degrades toward the strict engine\n"
                )
        else:
            self._batch_rows = np.empty(0, dtype=np.int64)
            self._rows_qcfail = np.empty(0, dtype=bool)
        return results

    def _merge_device_counters(self, counters):
        """Split the flat counter vector (counter_layout order) into the
        runtime accumulators."""
        flat = np.asarray(counters)
        offset = 0
        for position, name, size in wire.counter_layout(self.instrument):
            value = flat[offset : offset + size]
            offset += size
            target = getattr(self._runtimes[position].accumulator, name)
            if target.dtype == np.float64:
                target += value.astype(np.float64)
            else:
                target += np.rint(value).astype(np.int64)

    # --- pipelined execution ---------------------------------------------
    def execute(self, batch_size: int = 16384):
        """The lookahead pipeline (dispatch batch k+1 before pulling k),
        without autograd. PHENIQS_PROFILE=<dir> wraps the run in
        torch.profiler (host ops, and the card's kernels and copies on CUDA)
        and writes its Chrome trace into <dir>. A PHENIQS_TP run ends by
        releasing every other rank of the grid."""
        profile_dir = os.environ.get("PHENIQS_PROFILE")
        with torch.no_grad():
            if not profile_dir:
                result = self._execute_pipeline(batch_size)
            else:
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    activities.append(ProfilerActivity.CUDA)
                with profile(activities=activities) as profiler:
                    result = self._execute_pipeline(batch_size)
                os.makedirs(profile_dir, exist_ok=True)
                profiler.export_chrome_trace(
                    os.path.join(profile_dir, f"pheniqs_{os.getpid()}.trace.json")
                )
        if self._panel is not None:
            from ..device.tp import send_stop

            send_stop(self._panel, len(self.instrument.used_segments))
            self._panel = None
        return result

    def _prepared_batches(self, batches):
        """Per-batch host preparation, run ahead of the dispatch loop
        (on the ingest thread when prefetch is on): raw accounting counts,
        input filters, wire-blob packing, and worker-slot staging. The
        dispatch/pull loop then touches only the device and the small
        decision arrays."""
        raw_index = -1
        for batch in batches:
            raw_index += 1
            raw_size = batch.size
            raw_pf = int((~batch.qcfail).sum())
            arena = getattr(batch, "_arena", None)
            batch = self._apply_input_filters(batch)
            if arena is not None and getattr(batch, "_arena", None) is not arena:
                # the filters subset the batch (new arrays, copied out of
                # the slot): the zero-copy parse arena goes back to the
                # pool; the filtered batch stages through the copy path
                arena.release()
            batch.raw_index = raw_index
            packed = None
            if batch.size:
                packed = self._pack_batch(batch)
                self._stage_for_workers(batch)
            yield raw_size, raw_pf, batch, packed

    def _stage_for_workers(self, batch: ReadBatch):
        """Hook: the streamed engine pre-writes the batch into a shared
        memory slot here, off the dispatch loop."""

    def _execute_pipeline(self, batch_size: int):
        import collections

        from .strict import _prefetch

        self._initiate_feeds()
        start = time.perf_counter()
        batches = self.read_batches(batch_size)
        if os.environ.get("PHENIQS_PREFETCH", "1") != "0":
            # two pipelined host stages, each on its own thread: parse
            # (native, GIL-free) | filter + wire-pack + worker staging,
            # so neither serializes behind the other or behind the
            # dispatch/pull loop
            prepared = _prefetch(self._prepared_batches(_prefetch(batches)))
        else:
            prepared = self._prepared_batches(batches)
        # in-flight depth: batches dispatched ahead of the one whose host
        # work runs; bounded to keep memory finite
        depth = max(1, int(os.environ.get("PHENIQS_LOOKAHEAD", "4")))
        stages = self._stage_seconds = {
            "ingest_wait": 0.0,
            "stage_dispatch": 0.0,
            "finish": 0.0,
        }
        pending = collections.deque()
        clock = time.perf_counter
        mark = clock()
        for raw_size, raw_pf, batch, packed in prepared:
            now = clock()
            stages["ingest_wait"] += now - mark
            mark = now
            # raw accounting happened pre-filter in _prepared_batches so
            # device rows match the filtered batch exactly
            self.incoming_count += raw_size
            self.incoming_pf_count += raw_pf
            if batch.size == 0:
                self._note_skipped_batch(batch.raw_index)
                mark = clock()
                continue
            handles = self._dispatch(batch, packed)
            pending.append((batch, handles))
            now = clock()
            stages["stage_dispatch"] += now - mark
            if len(pending) > depth:
                self._finish(*pending.popleft())
            mark = clock()
            stages["finish"] += mark - now
        while pending:
            now = clock()
            self._finish(*pending.popleft())
            stages["finish"] += clock() - now
        self._close_feeds()
        self._trace_summary(start)

    def _note_skipped_batch(self, raw_index: int):
        """Hook for pipelined consumers tracking the raw batch sequence."""

    def _trace_summary(self, start):
        super()._trace_summary(start)
        resolved = getattr(self, "_resolved_reads", 0)
        if os.environ.get("PHENIQS_TRACE") == "1" and self.hybrid:
            fraction = resolved / max(self.incoming_count, 1)
            sys.stderr.write(
                f"[pheniqs-tpu] hybrid f64 re-resolution: {resolved} reads "
                f"({fraction:.3%}) flagged by the derived bound\n"
            )

    def _stage_add(self, key: str, seconds: float):
        """Accumulate a sub-stage duration into the PHENIQS_TRACE pipeline
        breakdown (no-op outside the pipelined execute)."""
        stages = getattr(self, "_stage_seconds", None)
        if stages is not None:
            stages[key] = stages.get(key, 0.0) + seconds

    def _finish(self, batch: ReadBatch, handles):
        self._predispatched = handles
        try:
            self.process_batch(batch, filtered=True)
        finally:
            self._predispatched = None

    # --- StrictEngine hook ----------------------------------------------
    def _run_classifier(self, runtime, batch, qcfail):
        if self._current_batch is not batch:
            self._batch_results = self._classify_batch_on_device(batch)
            self._current_batch = batch
        position = self._runtimes.index(runtime)
        device = self._batch_results[position]
        spec = runtime.spec

        observation = []
        if spec.rule is not None and spec.algorithm != "passthrough":
            mark = time.perf_counter()
            # the full observation gather is only consumed by local render
            # (the render workers recompute it from shared memory) and by
            # the f64 oracle for flagged rows; when neither applies, the
            # only surviving need is the PAMLD scratch carry, and a batch
            # with zero flagged rows has no short observation (short rows
            # are always flagged uncertain), so the carry-out is the LAST
            # read's observation alone
            if getattr(self, "_render_local", True) or (
                self.hybrid and self._batch_rows.size > 0
            ):
                observation = spec.rule.apply(batch.segments)
            elif (
                self.hybrid
                and spec.algorithm == "pamld"
                and runtime.scratch is not None
            ):
                tail = [
                    SegmentBatch(
                        code=s.code[-1:],
                        quality=s.quality[-1:],
                        length=s.length[-1:],
                    )
                    for s in batch.segments
                ]
                for j, segment in enumerate(spec.rule.apply(tail)):
                    runtime.scratch.effective(j, segment)
            self._stage_add("host_rules", time.perf_counter() - mark)

        # this decoder's own qcfail contribution: device chain delta
        previous = (
            self._batch_results[position - 1]["qcfail"]
            if position > 0
            else batch.qcfail
        )
        delta = device["qcfail"] & ~previous

        n = batch.size
        decoded = device["decoded"].astype(np.int32)
        confidence = device["confidence"].copy()
        # distance/argmax/branch live on device only (they feed the
        # counters, computed there); host arrays are filled for the
        # oracle-resolved rows alone
        distance = np.zeros(n, dtype=np.int32)
        branch = np.full(n, BRANCH_PASS, dtype=np.int8)
        argmax = np.zeros(n, dtype=np.int32)
        out_qcfail = qcfail | delta

        if self.hybrid:
            self._resolve_rows(
                runtime, observation,
                decoded, confidence, distance, branch, argmax, out_qcfail,
            )

        # statistics for device-resolved rows were merged from the device
        # counters at pull time; only oracle-resolved rows record here
        return ClassifyResult(
            decoded=decoded,
            confidence=confidence,
            edit_distance=distance,
            qcfail=out_qcfail,
            branch=branch,
            argmax=argmax,
            observation=observation,
        )

    def _resolve_rows(
        self, runtime, observation,
        decoded, confidence, distance, branch, argmax, out_qcfail,
    ):
        """Re-resolve the flagged rows of this batch with the exact float64
        oracle and record their statistics host-side (the device counters
        excluded them). The chained qcfail for the flagged rows threads
        through ``self._rows_qcfail`` decoder by decoder."""
        spec = runtime.spec
        rows = self._batch_rows

        if spec.algorithm == "pamld" and runtime.scratch is not None:
            # scratch carry is serial state: advance it on EVERY batch,
            # even when no rows are flagged
            mark = time.perf_counter()
            eff_codes = []
            eff_quals = []
            for segment_index, segment in enumerate(observation):
                code, qual = runtime.scratch.effective(segment_index, segment)
                eff_codes.append(code)
                eff_quals.append(qual)
            self._stage_add("scratch", time.perf_counter() - mark)
            if rows.size == 0:
                return
            obs_code = np.concatenate([c[rows] for c in eff_codes], axis=1)
            obs_qual = np.concatenate([q[rows] for q in eff_quals], axis=1)
            oracle = pamld_classify(spec, obs_code, obs_qual, self._rows_qcfail)
        elif rows.size == 0:
            return
        elif spec.algorithm == "mdd":
            sub_observation = [
                SegmentBatch(
                    code=segment.code[rows],
                    quality=segment.quality[rows],
                    length=segment.length[rows],
                )
                for segment in observation
            ]
            oracle = mdd_classify(spec, sub_observation, self._rows_qcfail)
        else:
            # naive / passthrough: decoded stays 0, qcfail passes through
            oracle = ClassifyResult(
                decoded=np.zeros(rows.size, dtype=np.int32),
                confidence=np.zeros(rows.size, dtype=np.float64),
                edit_distance=np.zeros(rows.size, dtype=np.int32),
                qcfail=self._rows_qcfail.copy(),
                branch=np.full(rows.size, BRANCH_PASS, dtype=np.int8),
                argmax=np.zeros(rows.size, dtype=np.int32),
            )

        decoded[rows] = oracle.decoded
        confidence[rows] = oracle.confidence
        distance[rows] = oracle.edit_distance
        branch[rows] = oracle.branch
        argmax[rows] = oracle.argmax
        out_qcfail[rows] = oracle.qcfail
        self._rows_qcfail = oracle.qcfail.copy()
        runtime.record(oracle)


class TorchStreamedDeviceEngine(TorchDeviceEngine):
    """Device classification + multiprocess render fan-out: the parent owns
    ingest, device dispatch (lookahead), the decision pull, hybrid f64
    re-resolution and statistics; ``workers`` forked render processes own
    template/tag/format work; the writer thread streams ordered chunks to
    the feeds (engine/stream.py). The role the reference's decoding-thread
    pool plays for its CPU pipeline (reference transcode.cpp:1776-1795)."""

    # statistics are parent-owned (device counters + oracle rows): ship
    # workers only the arrays render consumes (engine/stream.py)
    _payload_fields = ("decoded", "confidence", "qcfail")

    def __init__(self, ontology: dict, hybrid: bool = False, workers: int = 2, device="cuda", devices=None):
        super().__init__(ontology, hybrid=hybrid, device=device, devices=devices)
        self.workers = workers
        self._runner = None
        # render workers recompute observation gathers from shared memory;
        # the parent skips them (and the _classify_batch back-fill)
        self._render_local = False

    def execute(self, batch_size: int = 16384):
        from .stream import StreamRunner

        self._runner = StreamRunner(self, self.workers, batch_size)
        self._runner.start()
        try:
            return super().execute(batch_size)
        except BaseException:
            if self._runner is not None:
                self._runner.abort()
                self._runner = None
            raise

    def _note_skipped_batch(self, raw_index: int):
        self._runner.submit_skip(raw_index)

    def _parse_arena_provider(self, estimate: int):
        """Zero-copy staging: hand the native parser a shared-memory slot
        to write batch matrices into (engine/shm.py SlotArena)."""
        runner = self._runner
        if runner is None:
            return None
        return runner.acquire_parse_arena(estimate)

    def _stage_for_workers(self, batch):
        # pre-write the batch into a shared-memory slot from the ingest
        # thread: the submit after classification then appends only the
        # decision arrays (engine/stream.py StreamRunner.stage)
        if self._runner is not None:
            self._runner.stage(batch)

    def _consume_classified(self, batch, results):
        mark = time.perf_counter()
        self._runner.submit(batch, results)
        self._stage_add("submit", time.perf_counter() - mark)

    def _close_feeds(self):
        if self._runner is not None:
            self._runner.finish()
            self._runner = None
        super()._close_feeds()
