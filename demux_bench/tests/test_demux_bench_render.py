"""The instruction as NumPy renders it is, byte for byte, what json.dumps of
the decoders' objects gave before (tests/frozen.py): at the whitelist's
size and a small one, on several seeds, with decoders of one, two and
three tokens; and the keys of a codec come in the order of their strings."""

import copy
import hashlib
import json

import pytest

from demux_bench import cells, traffic
from demux_bench.tests import frozen
from demux_bench.tests.shapes import SCI_CONFIG, SCI_TRAFFIC

INPUTS = ["/work/in_s01.fastq", "/work/in_s02.fastq", "/work/in_s03.fastq", "/work/in_s04.fastq"]


def tenx(barcodes):
    cell = cells.load("tenx-v2-fast")
    cell.config["decoders"][1]["barcodes"] = barcodes
    cell.traffic["vary"]["barcodes"] = min(cell.traffic["vary"]["barcodes"], barcodes)
    return cell.config, cell.traffic


def both(config, plan, seed):
    inst = traffic.instrument(config, seed, plan)
    return (frozen.instruction_text(inst, INPUTS, "/work/out.sam", "/work/report.json"),
            traffic.instruction_text(inst, INPUTS, "/work/out.sam", "/work/report.json"))


@pytest.mark.parametrize("barcodes", [192 * 21, 737280])
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 12345, 3000000017])
def test_whitelist_instruction_unchanged(barcodes, seed):
    # a decoder of one token each: the sample index and the whitelist
    before, after = both(*tenx(barcodes), seed)
    assert hashlib.sha256(after.encode()).hexdigest() == hashlib.sha256(before.encode()).hexdigest()


@pytest.mark.parametrize("seed", [5, 2 ** 33 + 1])
def test_multi_token_instruction_unchanged(seed):
    config, plan = copy.deepcopy(SCI_CONFIG), copy.deepcopy(SCI_TRAFFIC)
    # a third token on the PCR decoder: three pieces of one barcode
    config["segments"][3] = 60
    config["decoders"][2]["tokens"].append([3, 50, 56])
    config["decoders"][2]["random_barcode_probability"] = 4.0 ** -26
    before, after = both(config, plan, seed)
    assert after == before
    body = json.loads(after)
    assert [len(e["barcode"]) for e in body["cellular"][1]["codec"].values()][:3] == [3, 3, 3]


def test_written_as_rendered(tmp_path):
    config, plan = tenx(192 * 21)
    inst = traffic.instrument(config, 7, plan)
    path = tmp_path / "job.json"
    traffic.write_instruction(str(path), inst, INPUTS, "o.sam", "r.json")
    assert path.read_text() == traffic.instruction_text(inst, INPUTS, "o.sam", "r.json")


@pytest.mark.parametrize("count", [1, 9, 10, 11, 99, 100, 101, 1000, 12345, 100000])
def test_keys_in_string_order(count):
    keys, places = traffic.sorted_keys(count)
    assert [str(k) for k in keys] == sorted(str(k) for k in range(1, count + 1))
    assert [len(str(k)) for k in keys] == places.tolist()
