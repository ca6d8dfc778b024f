"""One-command multi-card / multi-host throughput bench.

Port of ``pheniqs_tpu.tools.multichip_bench``:

    python -m pheniqs_tpu_torch.tools.multichip_bench [--reads N] [--devices R]
    python -m pheniqs_tpu_torch.tools.multichip_bench --path whitelist --fidelity fast --batch-size 131072
    python -m pheniqs_tpu_torch.tools.multichip_bench --device-step --devices 2 --reads 131072
    python -m pheniqs_tpu_torch.tools.multichip_bench --scaling --virtual 4 --device cpu

It runs the port's e2e engine (FASTQ -> tagged SAM, ``benchmark.run_e2e``)
over the flagship workload, or the MDD or whitelist variant (``--path``),
with the whole scale-out engaged:

  * multi-card: the engine cuts every batch into contiguous slices, one
    per local card (``device/distributed.py:reads_devices``, capped by
    ``--devices``), decodes them together and adds their counters in
    float64 in slice order (``device/step.py:ShardedDecodeStep``);
  * multi-host: ``initialize_multihost`` joins the hosts from the
    ``env://`` environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK);
    each host owns the ``PHENIQS_SHARD=k:H`` round-robin slice of the
    input, and process 0 prints the cross-host aggregate, gathered over
    gloo and summed in rank order (its wall the longest host's).

``--device-step`` times ShardedDecodeStep alone on a fixed flagship batch
as the engine drives it, from pinned host rows to pinned host buffers
(CUDA events on each slice's stream, the longest slice's time; the host
clock on the CPU). On a host with
fewer cards than asked for, the slices are placed on its cards round-robin
and the JSON line says so. ``--scaling`` runs it at 1 and at R slices and
reports ``partition_efficiency`` = t(1) / t(R). ``--virtual D`` runs D
slices on the CPU in this one process (torch has no virtual device count to
set per process, so no subprocess per count is needed).

The device is ``--device cuda`` unless ``--device cpu`` is given; ``cuda``
raises without a GPU. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def run_bench(
    reads: int = 500_000,
    batch_size: int = 65536,
    threads: int = 4,
    fidelity: str = "hybrid",
    bench_dir: str | None = None,
    output: str | None = None,
    devices=None,
    device="cuda",
    path: str = "flagship",
) -> dict:
    """Synthesize (or reuse) the `path` input, run the engine over this
    host's shard on `devices` (a count capping the local cards, or a list),
    and return the cross-host aggregated stats dict."""
    import torch

    from ..benchmark import ONTOLOGIES, run_e2e, synthesize_fastq_input
    from ..device.distributed import initialize_multihost

    process_id, num_processes = initialize_multihost()
    if num_processes > 1:
        os.environ["PHENIQS_SHARD"] = f"{process_id}:{num_processes}"
    bench_dir = bench_dir or os.environ.get("PHENIQS_BENCH_DIR", os.path.join(tempfile.gettempdir(), "pheniqs_bench"))
    ontology = ONTOLOGIES[path]()
    paths = synthesize_fastq_input(os.path.join(bench_dir, f"multichip_{path}"), reads, ontology=ontology)
    keep = output is not None
    output = output or os.path.join(bench_dir, f"multichip_out_p{process_id}.sam")
    stats = run_e2e(paths, output, fidelity=fidelity, threads=threads, batch_size=batch_size, device=device,
                    ontology=ontology, devices=devices)
    if not keep:
        os.unlink(output)

    local = torch.tensor([stats["reads"], stats["wall_s"]], dtype=torch.float64)
    if num_processes > 1:
        import torch.distributed as dist

        gathered = [torch.zeros_like(local) for _ in range(num_processes)]
        dist.all_gather(gathered, local)
        dist.destroy_process_group()
        total_reads = 0.0
        for host in gathered:  # rank order
            total_reads += float(host[0])
        wall = max(float(host[1]) for host in gathered)
    else:
        total_reads, wall = float(local[0]), float(local[1])
    result = {
        "metric": f"multichip_e2e_{fidelity}",
        "path": path,
        "value": round(total_reads / wall, 1) if wall else 0.0,
        "unit": "reads/s",
        "hosts": num_processes,
        "devices_per_host": stats["devices"],
        "reads": int(total_reads),
        "wall_s": round(wall, 3),
        "per_host_steady_reads_per_s": stats.get("steady_reads_per_s"),
        "per_host_stats": stats,
        "process_id": process_id,
        "kind": _kind(device),
    }
    return result


def _kind(device) -> str:
    """The name of the card ``device`` names, or "cpu"."""
    import torch

    if torch.device(device).type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(0)


def run_device_step(n_devices: int, reads: int, reps: int = 5, device="cuda", path: str = "flagship") -> dict:
    """Time ShardedDecodeStep over `n_devices` slices on a FIXED total
    workload (the scaling probe's inner body) as the engine runs it:
    `reads` flagship reads on the j4 wire the hybrid engine ships, in
    pinned host rows padded to a multiple of the slices, each slice copied
    to its card, decoded there and its decisions and counters pulled back
    into pinned host buffers (``upload`` then ``launch``). The slices go
    to this host's devices (``reads_devices(device)``), round-robin where
    it has fewer. Returns the median step time over `reps` calls after a
    warm-up call: on CUDA the longest slice's, from an event on each
    slice's stream before the first copy is enqueued to one after its
    pull; the host clock on the CPU."""
    import numpy as np
    import torch

    from ..benchmark import ONTOLOGIES
    from ..device import wire
    from ..device.distributed import reads_devices
    from ..device.instrument import compile_instrument, instruments_on
    from ..device.step import ShardedDecodeStep, pad_rows
    from .profile_step import WIDTHS, wire_blob

    local = reads_devices(device)
    placement = [local[r % len(local)] for r in range(n_devices)]
    ontology = ONTOLOGIES[path]()
    instrument = compile_instrument(ontology, placement[0])
    step = ShardedDecodeStep(instruments_on(instrument, placement), WIDTHS, wire.JOINT4, want_uncertain=True)
    blob, ccb, qcb = wire_blob(ontology, instrument, reads, seed=11)
    if os.environ.get("PHENIQS_SCALING_BREAK") == "1" and n_devices > 1:
        # test hook: deliberately break the work partition by tiling the
        # batch n-fold, so every slice is the WHOLE workload: the
        # replication regression the scaling gate exists to catch
        blob = np.concatenate([blob] * n_devices)
    cuda = placement[0].type == "cuda"
    rows = pad_rows(torch.from_numpy(blob), n_devices)
    if cuda:
        rows = rows.pin_memory()
    ccb, qcb = (torch.from_numpy(x).to(placement[0]) for x in (ccb, qcb))

    def call():
        with torch.no_grad():
            pieces, _ = step.upload(rows)
            return step.launch(pieces, ccb, qcb)

    def marks() -> list:
        events = []
        for r in range(step.size):
            with step.on(r):
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record(torch.cuda.current_stream(step.devices[r]))
        return events

    call()  # build, first launches, allocator
    walls = []
    for _ in range(reps):
        if cuda:
            for card in set(step.devices):
                torch.cuda.synchronize(card)
            starts = marks()
            call()
            ends = marks()
            for end in ends:
                end.synchronize()
            walls.append(max(a.elapsed_time(b) for a, b in zip(starts, ends)) / 1e3)
        else:
            mark = time.perf_counter()
            call()
            walls.append(time.perf_counter() - mark)
    median = float(np.median(walls))
    return {
        "metric": "device_step_scaling_probe",
        "path": path,
        "n_devices": n_devices,
        "devices": [str(d) for d in placement],
        "round_robin": len(local) < n_devices,
        "placement": (f"{n_devices} slices on {len(local)} device(s) round-robin" if len(local) < n_devices
                      else f"one slice a device over {n_devices}"),
        "reads": reads,
        "reads_per_device_shard": rows.shape[0] // n_devices,
        "step_ms_median": round(median * 1e3, 4),
        "step_ms_all": [round(w * 1e3, 4) for w in walls],
        "reads_per_s": round(reads / median, 1),
        "reps": reps,
        "timer": "cuda events, longest slice, host rows to host buffers" if cuda else "host clock",
        "kind": _kind(placement[0]),
    }


def run_scaling(n_devices: int, reads: int = 524_288, device="cuda") -> dict:
    """Work-partitioning scaling gate: the fixed workload through one slice
    and through `n_devices` slices (run_device_step) in this process,

        partition_efficiency = t_single / t_sharded

    A partition that REPLICATES each slice's work (PHENIQS_SCALING_BREAK)
    multiplies the work ~N-fold: each slice's rows
    (``reads_per_device_shard``) show it, whatever the clocks say."""
    single = run_device_step(1, reads, device=device)
    sharded = run_device_step(n_devices, reads, device=device)
    t1 = single["step_ms_median"]
    tn = sharded["step_ms_median"]
    return {
        "metric": "multichip_scaling",
        "reads": reads,
        "n_devices": n_devices,
        "single_step_ms": t1,
        "sharded_step_ms": tn,
        "partition_efficiency": round(t1 / tn, 3) if tn else 0.0,
        "single": single,
        "sharded": sharded,
    }


def main(argv=None):
    from ..benchmark import ONTOLOGIES

    parser = argparse.ArgumentParser(description="multi-card/multi-host e2e throughput bench of the port")
    parser.add_argument("--reads", type=int, default=500_000)
    parser.add_argument("--batch-size", type=int, default=65536)
    parser.add_argument("--threads", type=int, default=4)
    parser.add_argument("--fidelity", default="hybrid")
    parser.add_argument("--path", choices=tuple(ONTOLOGIES), default="flagship")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--devices", type=int, default=None,
                        help="slices of the reads axis (default: every local card)")
    parser.add_argument("--virtual", type=int, default=0,
                        help="D slices on the CPU in this process (validation mode)")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--device-step", action="store_true",
                        help="time the sharded decode step only (fixed workload; the scaling probe's inner body)")
    parser.add_argument("--scaling", action="store_true",
                        help="work-partitioning scaling gate: fixed workload, 1 slice vs --devices/--virtual")
    args = parser.parse_args(argv)

    from ..device.distributed import reads_devices
    from ..device.instrument import resolve_device

    device = "cpu" if args.virtual else args.device
    resolve_device(device)  # cuda without a GPU raises here
    count = args.virtual or args.devices
    if args.scaling:
        result = run_scaling(max(count or 2, 2), reads=args.reads, device=device)
    elif args.device_step:
        result = run_device_step(count or len(reads_devices(device)), args.reads, args.reps, device, args.path)
    else:
        result = run_bench(
            reads=args.reads, batch_size=args.batch_size, threads=args.threads, fidelity=args.fidelity,
            devices=["cpu"] * args.virtual if args.virtual else args.devices, device=device, path=args.path,
        )
        if result["process_id"] != 0:
            return 0
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
