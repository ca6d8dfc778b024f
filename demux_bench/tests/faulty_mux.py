"""``python -m pheniqs_tpu_torch`` with one fault planted in its timed path,
for the tests that see ``correct`` come out false:

    python faulty_mux.py <fault> mux --config ...

- ``unchanged``: the decode step hands back what it started from, no
  barcode decoded and no confidence;
- ``half``: each batch's render writes only the first half of its records;
- ``altered``: the first decision of each batch's first read (the
  sample's, where there is a sample decoder) is moved to the next barcode
  where the step produces it;
- ``stall``: the program starts a child process, writes its own pid and
  the child's to the file ``STALL_PIDS`` names (where it names one) and
  sleeps before it reads any input, so the window never opens.
"""

import os
import subprocess
import sys
import time

import numpy as np


def unchanged(classify):
    def step(self, batch):
        results = classify(self, batch)
        n = batch.size
        return [{"decoded": np.zeros(n, dtype=np.int32), "confidence": np.zeros(n),
                 "qcfail": np.zeros(n, dtype=bool)} for _ in results]
    return step


def altered(classify):
    def step(self, batch):
        results = classify(self, batch)
        k = next(k for k, d in enumerate(self.instrument.decoders) if d.barcode_count)
        decoded = results[k]["decoded"].copy()
        decoded[0] = decoded[0] % self.instrument.decoders[k].barcode_count + 1
        results[k] = dict(results[k], decoded=decoded)
        return results
    return step


def half(engine):
    chunk = {}
    for url, feed in engine.feeds_by_url.items():
        lines = bytes(feed.take()).split(b"\n")[:-1]
        if lines:
            chunk[url] = b"".join(line + b"\n" for line in lines[: len(lines) // 2])
    return chunk


def stall():
    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(3600)"])
    if os.environ.get("STALL_PIDS"):
        with open(os.environ["STALL_PIDS"], "w") as stream:
            stream.write(f"{os.getpid()} {child.pid}")
    time.sleep(3600)


if __name__ == "__main__":
    fault = sys.argv.pop(1)
    if fault == "stall":
        stall()
    from pheniqs_tpu_torch.cli.main import main
    from pheniqs_tpu_torch.engine import device, stream

    engine = device.TorchDeviceEngine
    if fault == "unchanged":
        engine._classify_batch_on_device = unchanged(engine._classify_batch_on_device)
    elif fault == "altered":
        engine._classify_batch_on_device = altered(engine._classify_batch_on_device)
    elif fault == "half":
        stream._collect_chunk = half
    else:
        raise SystemExit(f"unknown fault {fault}")
    sys.exit(main(sys.argv))
