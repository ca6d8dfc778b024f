"""Ablation profiler for the device decode step (compute only).

Port of ``pheniqs_tpu.tools.profile_step``. It times a ladder of prefixes
of the production step over the SAME resident wire blobs the hybrid
engine ships (the joint 4-bit wire, segment widths [8, 8, 28]); each rung
adds one stage of the real step, so rung-to-rung deltas localize the cost.
The rungs follow the port's kernels, not XLA's stages:

  null      one trivial reduction of the blob (the per-call floor)
  unpack    K3 unpack_tokens: the wire unpack and every decoder's token
            plans in one launch
  classify  + each classify decoder's K1 (PAMLD) or K6 (MDD) in classify
            order, qcfail chained, into one zeroed Decisions buffer
  counters  + K4
  full      the production step, DecodeStep.forward (+ K5)

The reference's rungs ``plans``, ``features`` and ``sigma`` have no
counterpart of their own: K3 does the unpack and the token plans in one
launch, and K1 builds the features and sums sigma and the posterior in one
(device/step.py). Its ``posterior`` rung is ``classify`` here.

Each rung reports latency (synchronize after every call), pipelined time
(``--depth`` calls in flight, then synchronize on the oldest, as the
engine's lookahead keeps calls in flight), both as reads/s, and on a GPU
``device_ms``, the summed time of the CUDA kernels and copies of one call
(torch.profiler; where a trace drops a kernel, the replay of a CUDA graph
of the calls, ``graph_ms``), and ``launches``, the device activities one
call puts on the card. The gap between latency and device time is the host's launch
cost. Calls cycle distinct resident buffers. ``full`` also runs a
batch-size sweep (``--sweep``): if reads/s grows with the batch while the
latency stays flat, the per-call cost is the wall; each full rung is held
byte for byte to a DecodeStep built apart, as an engine builds it.

Run on the card:  python -m pheniqs_tpu_torch.tools.profile_step [--markdown]
On a machine without one, pass ``--device cpu``: every rung runs (each
kernel's plain version), and the times are the CPU's.

Prints one JSON line per measurement; pass --markdown for a table.
"""

from __future__ import annotations

import argparse
import collections
import itertools
import json
import subprocess
import sys
import time

import torch

from ..device.flagship import flagship_ontology, mdd_flagship_ontology

#: the instruments the ladder runs on, by name
INSTRUMENTS = {"flagship": flagship_ontology, "mdd": mdd_flagship_ontology}
#: the rungs, in order
RUNGS = ("null", "unpack", "classify", "counters", "full")
#: the wire's segment widths (i7, i5, cell + UMI, each rounded up to 4)
WIDTHS = [8, 8, 28]
#: the full rung's batch sizes: the CLI's default batch, run_e2e's, and
#: the reference tool's
SWEEP = (16384, 65536, 131072, 262144, 524288, 1048576)


def wire_blob(ontology: dict, instrument, n: int, seed: int):
    """(blob, ccb, qcb) NumPy arrays: `n` flagship reads drawn from the
    ontology's panels on the j4 wire, the codebook sensed from the batch
    itself as the engine senses it. The biological segment rides no wire,
    so it is drawn 1 nt wide."""
    import numpy as np

    from ..device import wire
    from ..device.flagship import SEGMENT_WIDTHS, synthetic_batch

    batch = synthetic_batch(ontology, n, seed=seed, segment_widths=(1, *SEGMENT_WIDTHS[1:]))
    used = [batch["segments"][i] for i in instrument.used_segments]
    code = np.concatenate([c.ravel() for c, _, _ in used])
    qual = np.concatenate([q.ravel() for _, q, _ in used])
    pairs = np.unique((code.astype(np.int64) & 15) << 8 | np.minimum(qual, 63))
    ccb, qcb, lut_idx, lut_exact = wire.sense_joint_codebook(pairs)
    blob = wire.pack_h2d_blob(WIDTHS, used, batch["qcfail"], qual_bits=wire.JOINT4, qual_lut=(lut_idx, lut_exact))
    return blob, ccb, qcb


def make_step(instrument):
    """The step the hybrid engine builds for the flagship's j4 wire."""
    from ..device import wire
    from ..device.step import DecodeStep

    return DecodeStep(instrument, WIDTHS, wire.JOINT4, want_uncertain=True)


def rungs(step) -> dict:
    """The ablation ladder: name -> fn(blob, ccb, qcb), each a prefix of
    `step`'s own code path (DecodeStep.run_to)."""
    return {
        "null": lambda blob, ccb, qcb: blob[:, 0].to(torch.int32).sum(),
        "unpack": lambda *wire: step.run_to("unpack", *wire),
        "classify": lambda *wire: step.run_to("classify", *wire),
        "counters": lambda *wire: step.run_to("counters", *wire),
        "full": step,
    }


def hold_full(step, inputs):
    """The full rung's blob and counters, and the counters rung's, the
    same bytes as a DecodeStep built apart on each resident buffer of
    `inputs`; raises otherwise."""
    apart = make_step(step.instrument)
    ladder = rungs(step)
    for wire in inputs:
        blob, flat = ladder["full"](*wire)
        want_blob, want_flat = apart(*wire)
        _, counted = ladder["counters"](*wire)
        if not (torch.equal(blob, want_blob) and torch.equal(flat, want_flat) and torch.equal(counted, want_flat)):
            raise AssertionError(f"the full rung differs from DecodeStep.forward at N={wire[0].shape[0]}")


def event_ms(fn, reps: int = 10) -> float:
    """CUDA-event milliseconds per call of `fn` over `reps` back-to-back
    calls: device timeline time, launch gaps between kernels included."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: the port's kernel symbols (csrc/*.cu) that each group of the wrappers'
#: launch counts (kernels.launch_counts) puts on the card: one or more a
#: counted launch (K1/K7/K8 count one a kernel of a shared tile loop)
KERNEL_SYMBOLS = (
    (("unpack_tokens",), ("phq_unpack_kernel", "phq_unpack_columns_kernel")),
    (("pamld_classify", "pamld_chunked", "pamld_panel_sharded"), ("phq_pamld_kernel", "phq_pamld_merge_kernel")),
    (("mdd_classify",), ("phq_mdd_kernel", "phq_mdd_wide_kernel")),
    (("counters",), ("phq_counters_accumulate", "phq_counters_decoder")),
    (("pack_outputs",), ("phq_pack_kernel",)),
)


def kernel_events(prof) -> collections.Counter:
    """{symbol: count} of the CUDA kernels in a torch.profiler trace (the
    function name of each, without "void", arguments or template): its
    device activities less memsets and copies, which no wrapper counts."""
    from torch.autograd import DeviceType

    return collections.Counter(
        e.name.split("(")[0].split("<")[0].split()[-1] for e in prof.events()
        if e.device_type == DeviceType.CUDA and not e.name.startswith(("Memset", "Memcpy"))
    )


def short_kernels(launched: dict, traced: collections.Counter) -> dict:
    """{kernels: (launched, traced)} of each group of KERNEL_SYMBOLS whose
    kernels the trace holds fewer times than its wrappers launched them:
    a trace that dropped some of them, whatever else it holds."""
    short = {}
    for names, symbols in KERNEL_SYMBOLS:
        want = sum(launched.get(name, 0) for name in names)
        have = sum(traced[symbol] for symbol in symbols)
        if have < want:
            short["+".join(names)] = (want, have)
    return short


def profiled(fn, calls: int, tries: int = 2):
    """(trace, short) of the first of `tries` torch.profiler traces of
    `calls` calls of `fn` that holds every kernel launch the port's
    wrappers counted (``kernels.launch_counts`` before and after), each
    wrapper's kernels held apart (short_kernels): a trace with fewer of a
    wrapper's kernels than it launched dropped some. When each try is
    short, the trace is None and `short` the last try's {kernels:
    (launched, traced)}."""
    from torch.profiler import ProfilerActivity, profile

    from ..kernels import launch_counts

    short = {}
    for _ in range(tries):
        before = launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        launched = {name: count - before[name] for name, count in launch_counts().items()}
        short = short_kernels(launched, kernel_events(prof))
        if not short:
            return prof, short
    return None, short


def _counts(short: dict) -> str:
    return ", ".join(f"{names}: {have} in the trace, {want} launched" for names, (want, have) in short.items())


def graph_ms(fn, reps: int = 10, replays: int = 3) -> tuple[float, dict]:
    """(milliseconds a call, {kernel: launches a call}) of `fn` by device
    time alone: after a warm-up call, `reps` calls captured into one CUDA
    graph, the wrappers' launch counts (kernels.launch_counts) read just
    before and just after the capture; then CUDA events around `replays`
    replays of the graph, after one untimed. A replay puts the captured
    kernels and copies on the card back to back, so neither the host's
    time nor a launch gap between the calls is counted. Raises
    RuntimeError where `fn` cannot be captured (it waits on the card) or a
    kernel's launches are not the same in every call."""
    from ..kernels import launch_counts

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = launch_counts()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    launched = {name: count - before[name] for name, count in launch_counts().items()}
    uneven = {name: count for name, count in launched.items() if count % reps}
    if uneven:
        raise RuntimeError(f"launches over {reps} captured calls not a multiple of them: {uneven}")
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps), {name: count // reps for name, count in launched.items()}


def device_ms(fn, reps: int = 10) -> float:
    """Device milliseconds per call of `fn`: the summed time of the CUDA
    kernels and copies it launched, from torch.profiler over `reps` calls
    (host launch overhead between them is not counted). A trace that holds
    fewer of a wrapper's kernels than it launched (profiled) is taken
    again; after a second such try, or a trace with no device time, the
    time comes from the replay of a CUDA graph of `reps` calls (graph_ms:
    device time alone) and a line on standard error gives the counts;
    only where `fn` cannot be captured, from CUDA events over back-to-back
    calls (event_ms, launch gaps included), and the line says so."""
    fn()
    torch.cuda.synchronize()
    prof, short = profiled(fn, reps)
    if prof is not None:
        device_us = sum(e.self_device_time_total for e in prof.key_averages())
        if device_us > 0:
            return device_us / 1000.0 / reps
        why = "no device time"
    else:
        why = f"no whole trace of the kernels' launches, twice ({_counts(short)})"
    try:
        ms = graph_ms(fn, reps)[0]
    except RuntimeError as error:
        print(f"[profile_step] torch.profiler held {why}, and the calls could not be captured in a CUDA graph"
              f" ({error}): timed with CUDA events, launch gaps included", file=sys.stderr, flush=True)
        return event_ms(fn, reps)
    print(f"[profile_step] torch.profiler held {why}: timed by the replay of a CUDA graph", file=sys.stderr,
          flush=True)
    return ms


def device_launches(fn, tries: int = 2) -> dict:
    """{name: count} of the device activities (kernels, memsets, copies)
    one call of `fn` puts on the card, from torch.profiler after a warm-up
    call. The profiler now and then drops a call's activities: a trace
    with fewer of a wrapper's kernels than it launched is taken again, up
    to `tries` times, and then refused (RuntimeError, with both counts)."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    prof, short = profiled(fn, 1, tries)
    if prof is None:
        raise RuntimeError(f"torch.profiler dropped kernel events in {tries} tries: {_counts(short)}"
                           " by the kernels' wrappers")
    return dict(collections.Counter(e.name for e in prof.events() if e.device_type == DeviceType.CUDA))


def measure(fn, inputs, iters: int, depth: int, device) -> tuple[float, float]:
    """(latency s/call, pipelined s/call) of `fn` over the resident
    `inputs`, cycled call by call. Latency synchronizes after every call;
    pipelined keeps `depth` calls in flight, waiting on the oldest's event
    (on the CPU every call is synchronous, so the two agree)."""
    cuda = device.type == "cuda"

    def synchronize():
        if cuda:
            torch.cuda.synchronize(device)

    for wire in inputs:  # warm: first launches, allocator
        fn(*wire)
    synchronize()
    start = time.perf_counter()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
        synchronize()
    latency = (time.perf_counter() - start) / iters

    pending = collections.deque()
    start = time.perf_counter()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
        if cuda:
            event = torch.cuda.Event()
            event.record()
            pending.append(event)
            if len(pending) > depth:
                pending.popleft().synchronize()
    synchronize()
    pipelined = (time.perf_counter() - start) / iters
    return latency, pipelined


def profile(instrument: str = "flagship", batch: int = 1 << 17, sweep=(), iters: int = 200, depth: int = 2,
            device="cuda"):
    """Yield one row per rung at `batch` reads, then the full rung at each
    other size of `sweep`, on the `instrument` ("flagship" or "mdd")
    compiled for `device`."""
    from ..device.instrument import compile_instrument, resolve_device

    device = resolve_device(device)
    ontology = INSTRUMENTS[instrument]()
    compiled = compile_instrument(ontology, device)
    step = make_step(compiled)
    ladder = rungs(step)
    # distinct buffers per call in flight: the window of reads shifts by one
    variants = max(2, depth + 1)
    blob, ccb, qcb = wire_blob(ontology, compiled, max([batch, *sweep]) + variants, seed=31)
    ccb, qcb = (torch.from_numpy(x).to(device) for x in (ccb, qcb))

    def resident(n):
        return [(torch.from_numpy(blob[k : k + n]).to(device), ccb, qcb) for k in range(variants)]

    @torch.no_grad()
    def row(name, n, inputs, reps):
        latency, pipelined = measure(ladder[name], inputs, reps, depth, device)
        out = {
            "instrument": instrument,
            "variant": name,
            "batch": n,
            "latency_ms": round(latency * 1e3, 4),
            "pipelined_ms": round(pipelined * 1e3, 4),
            "latency_reads_per_s": round(n / latency, 1),
            "pipelined_reads_per_s": round(n / pipelined, 1),
            "device_ms": None,
            "launches": None,
        }
        if device.type == "cuda":
            calls = itertools.count()

            def call():
                return ladder[name](*inputs[next(calls) % len(inputs)])

            out["device_ms"] = round(device_ms(call), 4)
            out["launches"] = sum(device_launches(call).values())
        return out

    inputs = resident(batch)
    hold_full(step, inputs)
    for name in RUNGS:
        yield row(name, batch, inputs, iters)
    for n in sweep:
        if n == batch:
            continue
        inputs = resident(n)
        hold_full(step, inputs)
        yield row("full", n, inputs, max(4, iters // 2))


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them; the CPU
    says so."""
    if device.type != "cuda":
        return "cpu"
    result = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return result.stdout.strip().splitlines()[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description="ablation profile of the device decode step")
    parser.add_argument("--instrument", choices=tuple(INSTRUMENTS), default="flagship")
    parser.add_argument("--batch", type=int, default=1 << 17)
    parser.add_argument("--iters", type=int, default=200)
    parser.add_argument("--depth", type=int, default=2, help="calls in flight for the pipelined mode")
    parser.add_argument(
        "--sweep", default=",".join(map(str, SWEEP)),
        help="comma-separated batch sizes for the full-step sweep (empty string disables)",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--markdown", action="store_true")
    args = parser.parse_args(argv)

    from ..device.instrument import resolve_device

    device = resolve_device(args.device)
    sweep = [int(x) for x in args.sweep.split(",") if x]
    rows = []
    for row in profile(args.instrument, args.batch, sweep, args.iters, args.depth, device):
        rows.append(row)
        if not args.markdown:
            print(json.dumps(row), flush=True)
    if args.markdown:
        print(f"{card_line(device)} | {args.instrument}, depth {args.depth}")
        print("| variant | batch | latency ms | pipelined ms | device ms | launches |"
              " latency reads/s | pipelined reads/s |")
        print("|---|---|---|---|---|---|---|---|")
        for row in rows:
            print("| {variant} | {batch} | {latency_ms} | {pipelined_ms} | {device_ms} | {launches} |"
                  " {latency_reads_per_s:,.0f} | {pipelined_reads_per_s:,.0f} |".format(**row))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
