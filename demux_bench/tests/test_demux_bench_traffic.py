"""The generator: the same seed gives the same bytes, another seed other
bytes, and what it renders is well-formed FASTQ whose names stay unique
across replays of the pool; the varied decoder's panel is closed under
its maps, and a mapped read decodes to the mapped barcode."""

import json

import numpy as np
import pytest
import torch

from demux_bench import cells, check, traffic
from demux_bench.reference import pamld


@pytest.fixture(scope="module")
def cell():
    config = json.loads((cells.HERE / "configs" / "tenx-3p-v2.json").read_text())
    config["decoders"][1]["barcodes"] = 192 * 4  # the whitelist's shape, a test's size
    plan = json.loads((cells.HERE / "traffic" / "tenx-v2-fast.json").read_text())
    plan.update(batch_size=300, pool_batches=2)
    plan["vary"]["barcodes"] = 192 * 2
    return cells.Cell("tenx-v2-fast", 1, config, plan, [], [])


def render(cell, seed):
    inst = traffic.instrument(cell.config, seed, cell.traffic)
    return inst, traffic.pool(inst, cell.traffic, seed)


def test_same_seed_same_bytes(cell):
    big = 2 ** 31 + 12345
    _, a = render(cell, big)
    _, b = render(cell, big)
    _, c = render(cell, big + 1)
    for x, y, z in zip(a, b, c):
        assert all(np.array_equal(p, q) for p, q in zip(x.records, y.records))
        assert not all(np.array_equal(p, q) for p, q in zip(x.records, z.records))


def test_fastq_well_formed(cell):
    inst, pool = render(cell, 5)
    stream = traffic.Stream(inst, pool)
    names = [set() for _ in inst.segments]
    for j in (0, 1, 14, 15):  # replays 0 and 7
        for s in range(len(inst.segments)):
            lines = stream.records(j, s).tobytes().split(b"\n")
            assert lines[-1] == b"" and (len(lines) - 1) % 4 == 0
            for k in range(0, len(lines) - 1, 4):
                head, seq, plus, qual = lines[k:k + 4]
                assert head[:1] == b"@" and plus == b"+"
                assert len(seq) == len(qual) == inst.segments[s]
                assert set(seq) <= set(b"ACGT")
                assert min(qual) >= 33 + 2 and max(qual) <= 33 + 37
                assert traffic.parse_name(head[1:])[0] == j // 2
                names[s].add(head)
    assert len(names[0]) == 2 * 2 * 300 and all(n == names[0] for n in names)


def test_barcodes_land_on_their_tokens(cell):
    inst, pool = render(cell, 9)
    for decoder, (code, qual) in zip(inst.decoders, pool[0].observations):
        assert code.shape == (300, decoder.width) and qual.shape == code.shape
        if decoder.algorithm == "pamld":
            distance = (code[:, None, :] != decoder.codes[None]).sum(axis=2).min(axis=1)
            assert np.mean(distance) < 1.0  # 2 % errors a position


def test_instruction_names_every_decoder(cell):
    inst = traffic.instrument(cell.config, 3, cell.traffic)
    body = json.loads(traffic.instruction_text(inst, ["a", "b", "c"], "o.sam", "r.json"))
    assert body["input"] == ["a", "b", "c"] and body["output"] == ["o.sam"]
    assert body["sample"]["transform"]["token"] == ["1::8"]
    assert len(body["sample"]["codec"]) == 96 and len(body["cellular"][0]["codec"]) == 768
    assert body["cellular"][0]["transform"]["token"] == ["2::16"]
    assert body["molecular"][0]["transform"]["token"] == ["2:16:26"]


def test_panel_closed_under_the_maps(cell):
    inst = traffic.instrument(cell.config, 11, cell.traffic)
    varied = inst.varied()
    assert varied.role == "cellular" and varied.variants.size == 192
    keys = traffic.word_keys(varied.words)
    assert np.unique(keys).size == keys.size
    rows = np.arange(1, varied.barcodes + 1)
    for v in (1, 23, 24, 50, 95, 191):
        # map v of barcode row r is the panel's row remap(v, r)
        mapped = traffic.word_keys(varied.variants.apply(v, varied.words))
        assert np.array_equal(mapped, keys[varied.remap(v, rows) - 1])
        for w in (0, 7, 70, 170):
            both = varied.variants.apply(v, varied.variants.apply(w, varied.words))
            assert np.array_equal(both, varied.variants.apply(int(varied.variants.compose[v, w]), varied.words))
    assert list(varied.remap(5, np.array([0]))) == [0]
    # the reads' barcodes: the library's two orbits, a set every map keeps
    drawn = varied.draw(np.random.default_rng(1), 5000)
    library = np.unique(np.concatenate([np.arange(192) * 4 + j for j in range(2)]))  # 4 orbits in all
    assert np.array_equal(np.unique(drawn), library)
    assert np.array_equal(np.unique(varied.remap(37, library + 1)), library + 1)


def test_mapped_reads_decode_to_mapped_barcodes(cell):
    # the replay's records, read back, decode (float64, every read) to the
    # pool's decisions under the replay's map; UMI and qualities carried
    inst, pool = render(cell, 13)
    varied = inst.varied()
    at = inst.decoders.index(varied)
    stream = traffic.Stream(inst, pool)
    spec = varied.spec

    def decide(code, qual):
        return pamld.classify(varied.codes, varied.concentration(), spec["noise"],
                              spec["random_barcode_probability"], spec["confidence_threshold"],
                              spec["high_quality_threshold"], spec["high_quality_distance_threshold"],
                              code, qual, np.zeros(code.shape[0], dtype=bool), dtype=torch.float64)

    code, qual = pool[0].observations[at]
    base = decide(code, qual)
    for replay in (1, 30, 41):
        rows = stream.records(2 * replay, 2)
        seq = rows[:, 17:17 + 26]
        q = rows[:, 20 + 26:20 + 26 + 26] - 33
        got = decide(traffic.BASE_CODES[traffic.ASCII_TO_INDEX[seq[:, :16]]], q[:, :16].copy())
        settled = base["gap"] > 1e-6
        want = varied.remap(inst.variant(replay), base["decoded"])
        assert np.array_equal(got["decoded"][settled], want[settled])
        assert np.allclose(got["confidence"], base["confidence"], rtol=1e-9, atol=1e-12)
        raw = pool[0].records[2]
        assert np.array_equal(seq[:, 16:], raw[:, 17 + 16:17 + 26])


def test_every_replay_counted_under_its_map(cell):
    inst, pool = render(cell, 17)
    sent = check.sends(inst, 2, 7)
    assert sent == {(0, 0): 1, (1, 0): 1, (0, 1): 1, (1, 1): 1, (0, 2): 1, (1, 2): 1, (0, 3): 1}
