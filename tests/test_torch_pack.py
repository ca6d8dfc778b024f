"""K5's wrapper and plan on the CPU (the kernel itself runs only on a
card: tests/test_torch_kernels.py -m cuda): what the wrapper refuses
before a launch, the block plan, and the
single-buffer Decisions the decode step allocates."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pheniqs_tpu_torch.device.flagship import flagship_ontology, mdd_flagship_ontology
from pheniqs_tpu_torch.device.instrument import compile_instrument
from pheniqs_tpu_torch.device.wire import d2h_layout
from pheniqs_tpu_torch.kernels import Decisions, pack

FIELDS = {
    "decoded": torch.int32,
    "argmax": torch.int32,
    "distance": torch.int32,
    "branch": torch.int8,
    "confidence": torch.float32,
    "qcfail": torch.bool,
    "uncertain": torch.bool,
}


def _stand_in(decoders):
    return SimpleNamespace(
        decoders=[SimpleNamespace(algorithm=a, barcode_count=b) for a, b in decoders], pack_plans={}
    )


def _inputs(n=40):
    instrument = compile_instrument(flagship_ontology(), "cpu")
    decisions = Decisions.zeros(len(instrument.decoders), n, "cpu")
    forced = torch.zeros(n, dtype=torch.bool)
    out = torch.empty(n * d2h_layout(instrument, True)["total"], dtype=torch.uint8)
    return instrument, decisions, forced, out


def _transposed(t):
    return t.t().contiguous().t()


REFUSALS = {
    "decoded not contiguous": (lambda d, f, o: (dataclasses.replace(d, decoded=_transposed(d.decoded)), f, o),
                               "decoded must be contiguous"),
    "confidence as f64": (lambda d, f, o: (dataclasses.replace(d, confidence=d.confidence.double()), f, o),
                          "confidence is torch.float64"),
    "qcfail as uint8": (lambda d, f, o: (dataclasses.replace(d, qcfail=d.qcfail.to(torch.uint8)), f, o),
                        "qcfail is torch.uint8"),
    "uncertain of another width": (lambda d, f, o: (dataclasses.replace(d, uncertain=d.uncertain[:, :-1]), f, o),
                                   "uncertain is torch.bool"),
    "forced on another device": (lambda d, f, o: (d, f.to("meta"), o), "forced must be contiguous and on cpu"),
    "forced as int32": (lambda d, f, o: (d, f.to(torch.int32), o), "forced is torch.int32"),
    "out too short": (lambda d, f, o: (d, f, o[:-1]), "out is torch.uint8"),
    "out off alignment": (lambda d, f, o: (d, f, torch.empty(o.numel() + 1, dtype=torch.uint8)[1:]),
                          "16-byte aligned"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_wrapper_refuses_what_the_kernel_does_not_take(name):
    instrument, decisions, forced, out = _inputs()
    pack._check(instrument, decisions, forced, True, out, torch.device("cpu"))
    change, message = REFUSALS[name]
    decisions, forced, out = change(decisions, forced, out)
    with pytest.raises(ValueError, match=message):
        pack._check(instrument, decisions, forced, True, out, torch.device("cpu"))


@pytest.mark.parametrize("d", [33, 64, 300])
def test_wrapper_takes_any_number_of_decoders(d):
    """More than 32 decoders: a source for each decoder's index,
    confidence, qcfail bit and uncertain row, and one for the forced row;
    the plan stages its rows while 32 of them fit the shared bytes, else
    assembles them in place."""
    instrument = _stand_in([("pamld", 40_000)] * d)
    decisions = Decisions.zeros(d, 4, "cpu")
    plan = pack.pack_plan(instrument, True)
    out = torch.empty(4 * plan.layout["total"], dtype=torch.uint8)
    pack._check(instrument, decisions, torch.zeros(4, dtype=torch.bool), True, out, torch.device("cpu"))
    arrays = [source[0] for source in plan.sources]
    assert [arrays.count(a) for a in (pack.DECODED, pack.CONFIDENCE, pack.QCFAIL, pack.UNCERTAIN, pack.FORCED)] == [
        d, d, d, d, 1]
    assert [row for array, row, *_ in plan.sources if array == pack.DECODED] == list(range(d))
    assert plan.staged == (plan.layout["total"] * 32 <= pack.SHARED_BYTES)
    assert plan.staged or (plan.reads == pack.MAX_BLOCK_READS and plan.shared_bytes == 0)


def test_wrapper_refuses_a_device_without_a_kernel():
    instrument, decisions, forced, _ = _inputs()
    meta = Decisions.zeros(len(instrument.decoders), 40, "meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        pack.pack_outputs(instrument, meta, forced.to("meta"), True)


def test_fast_mode_ignores_the_forced_row():
    instrument, decisions, _, _ = _inputs()
    out = torch.empty(40 * d2h_layout(instrument, False)["total"], dtype=torch.uint8)
    pack._check(instrument, decisions, None, False, out, torch.device("cpu"))


@pytest.mark.parametrize("decoders,hybrid,total,reads", [
    ((("pamld", 96), ("naive", 0), ("pamld", 384)), True, 14, 256),
    ((("mdd", 96), ("naive", 0), ("pamld", 384)), True, 10, 256),
    ((("pamld", 96), ("naive", 0), ("pamld", 737_280)), False, 17, 256),
    ((("pamld", 1000), ("mdd", 40)) * 4 + (("naive", 0),), True, 35, 256),
    ((("pamld", 40_000),) * 32, True, 261, 160),
])
def test_plan_fits_the_shared_budget(decoders, hybrid, total, reads):
    """R the most whole warps, up to 256, whose rows fit 48 KB; every
    block's span of the output starts 16-byte aligned."""
    plan = pack.pack_plan(_stand_in(decoders), hybrid)
    assert (plan.layout["total"], plan.reads) == (total, reads)
    assert plan.shared_bytes <= pack.SHARED_BYTES and plan.shared_bytes % 16 == 0
    assert (plan.reads * total) % 16 == 0


def test_plan_is_cached_on_the_instrument():
    instrument = compile_instrument(mdd_flagship_ontology(), "cpu")
    plan = pack.pack_plan(instrument, True)
    assert pack.pack_plan(instrument, True) is plan
    assert pack.pack_plan(instrument, False) is not plan
    # mdd, naive, pamld: both classifiers send an index, only the PAMLD one a confidence and a bound
    assert plan.uncertain_mask == 0b100 and plan.decoded_mask == 0b101 and plan.confidence_mask == 0b100
    assert dataclasses.replace(instrument).pack_plans == {}


@pytest.mark.parametrize("d,n", [(3, 5), (1, 1), (32, 17), (2, 0)])
def test_decisions_share_one_zeroed_buffer(d, n):
    """The single-buffer Decisions holds the per-field layout: the same
    fields, dtypes and (decoders, N) shapes, every row contiguous and
    aligned to its element, all zero, and no field overlapping another."""
    decisions = Decisions.zeros(d, n, "cpu")
    assert [f.name for f in dataclasses.fields(decisions)] == list(FIELDS)
    storage = {getattr(decisions, name).untyped_storage().data_ptr() for name in FIELDS}
    assert len(storage) == 1
    for name, dtype in FIELDS.items():
        tensor = getattr(decisions, name)
        assert tensor.dtype == dtype and tuple(tensor.shape) == (d, n) and tensor.is_contiguous()
        assert not tensor.any()
        for k in range(d):
            assert tensor[k].is_contiguous() and tensor[k].data_ptr() % tensor.element_size() == 0
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
                   for t in (getattr(decisions, name) for name in FIELDS))
    assert all(end <= start for (_, end), (start, _) in zip(spans, spans[1:]))


#: K5 plan cases: decoders as (algorithm, barcodes), at the decoder counts
#: of K4's plan tests (tests/test_torch_counters.py) and the widest rows
PLAN_CASES = {
    "1 decoder": (("pamld", 96),),
    "flagship": (("pamld", 96), ("naive", 0), ("pamld", 384)),
    "whitelist": (("pamld", 96), ("naive", 0), ("pamld", 737_280)),
    "33 decoders": (("pamld", 96), ("mdd", 40), ("naive", 0)) * 11,
    "64 decoders": ((("pamld", 96), ("mdd", 40), ("naive", 0)) * 22)[:64],
    "300 decoders": (("pamld", 96), ("mdd", 40), ("naive", 0)) * 100,
    "300 wide decoders (in place)": (("pamld", 40_000),) * 300,
}


@pytest.mark.parametrize("name", list(PLAN_CASES))
@pytest.mark.parametrize("hybrid", [True, False])
def test_pack_plan_covers_the_row_within_its_budget(name, hybrid):
    """K5's plan: the fields in layout order cover the row byte for byte,
    each naming its own consecutive sources (a stored field one, a qcfail
    byte up to 8 decoders' rows, the uncertain byte the counted rows and
    forced); a block's rows within 48 KB, and with the table's copy
    (more fields than warps) within the 227 KB an H100 block may take;
    rows in place take none."""
    plan = pack.pack_plan(_stand_in(PLAN_CASES[name]), hybrid)
    assert [f[1] for f in plan.fields] == list(np.cumsum([0] + [f[2] for f in plan.fields[:-1]]))
    assert sum(f[2] for f in plan.fields) == len(plan.sources)
    covered = [offset + b for _, _, _, offset, size in plan.fields for b in range(size)]
    assert covered == list(range(plan.layout["total"]))
    for kind, first, count, _, size in plan.fields:
        arrays = {array for array, _ in plan.sources[first : first + count]}
        assert (kind, size) in ((pack.STORE, plan.layout["index_size"]), (pack.STORE, 4), (pack.BITS, 1), (pack.ANY, 1))
        assert count == 1 if kind == pack.STORE else arrays <= ({pack.QCFAIL} if kind == pack.BITS else
                                                                {pack.UNCERTAIN, pack.FORCED})
    assert plan.shared_bytes <= pack.SHARED_BYTES and plan.block_bytes <= 227 * 1024
    assert (plan.block_bytes > plan.shared_bytes) == (plan.staged and len(plan.fields) > plan.reads // 32)
    assert plan.staged == (name != "300 wide decoders (in place)")


@pytest.mark.parametrize("name", list(PLAN_CASES))
@pytest.mark.parametrize("hybrid", [True, False])
@pytest.mark.parametrize("n", [1, 17, 257])
def test_fields_assemble_the_plain_blob(name, hybrid, n):
    """The kernel's assembly of its plan's fields (pack_outputs_sources,
    in torch) gives the plain version's bytes: every index, confidence,
    qcfail bit and uncertain byte from the sources the plan names."""
    import chip_smoke

    instrument, decisions, forced = chip_smoke.pack_case(PLAN_CASES[name], n, seed=n, device="cpu")
    plan = pack.pack_plan(instrument, hybrid)
    assert torch.equal(pack.pack_outputs_sources(plan, decisions, forced),
                       pack.pack_outputs_plain(instrument, decisions, forced, hybrid))


def test_device_table_is_made_once():
    """The plan's table reaches a device once (cached on the instrument
    beside the plan): an int4 a source and a field."""
    instrument = compile_instrument(flagship_ontology(), "cpu")
    plan = pack.pack_plan(instrument, True)
    table = pack._device_table(instrument, plan, torch.device("cpu"))
    assert pack._device_table(instrument, plan, torch.device("cpu")) is table
    assert table.numel() == 4 * (len(plan.sources) + len(plan.fields))
    assert pack._device_table(instrument, pack.pack_plan(instrument, False), torch.device("cpu")) is not table
