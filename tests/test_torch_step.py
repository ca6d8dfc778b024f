"""The port's whole decode step (DecodeStep on the CPU, every kernel's
plain version) against the JAX make_decode_step on the same wire blob.

Tolerances: decoded-index, qcfail and uncertain bytes exact except on
rows either side flags uncertain (those are re-resolved in f64 by the
hybrid host); confidence bytes rtol 1e-5 on the other rows (exp and sum
order differ by a few ulp); counters: integer columns exact, confidence
sums rtol 1e-5 (sum order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pheniqs_tpu.device import compile_instrument as jax_compile
from pheniqs_tpu.device.step import make_decode_step
from pheniqs_tpu_torch.device import wire
from pheniqs_tpu_torch.device.flagship import flagship_ontology, synthetic_batch
from pheniqs_tpu_torch.device.instrument import carry_instrument
from pheniqs_tpu_torch.device.step import DecodeStep

WIDTHS = [8, 8, 28]


def _blob(reference, batch, mode, seed):
    used = [batch["segments"][i] for i in reference.used_segments]
    rng = np.random.default_rng(seed)
    n = batch["qcfail"].shape[0]
    # short reads (always flagged), incoming qcfail rows
    for code, qual, length in used:
        length[rng.random(n) < 0.02] = rng.integers(0, 8)
    qcfail = rng.random(n) < 0.03
    code = np.concatenate([c.ravel() for c, _, _ in used])
    qual = np.concatenate([q.ravel() for _, q, _ in used])
    ccb = qcb = lut = None
    if mode == "j4":
        # codebook from the first quarter: later rows outside it are forced
        head = slice(0, code.size // 4)
        pairs = np.unique((code[head].astype(np.int64) & 15) << 8 | np.minimum(qual[head], 63))
        ccb, qcb, lut_idx, lut_exact = wire.sense_joint_codebook(pairs)
        lut = (lut_idx, lut_exact)
    blob = wire.pack_h2d_blob(WIDTHS, used, qcfail, qual_bits=mode, qual_lut=lut)
    blob[-16:] = 0
    blob[-16:, -1] = wire.H2D_PAD | wire.H2D_QCFAIL
    return blob, ccb, qcb


@pytest.fixture(scope="module", params=["j4", 6])
def step_case(request):
    mode = request.param
    ontology = flagship_ontology()
    reference = jax_compile(ontology)
    ours = carry_instrument(reference, "cpu")
    batch = synthetic_batch(
        ontology, 4096, seed=21, error_rate=0.05,
        quality_binning="rta3" if mode == "j4" else None,
    )
    blob, ccb, qcb = _blob(reference, batch, mode, seed=22)
    jax_step = jax.jit(
        make_decode_step(
            reference, want_uncertain=True, want_counters=True,
            pack_outputs=True, h2d_widths=WIDTHS, qual_bits=mode,
        )
    )
    inputs = {"blob": jnp.asarray(blob)}
    if qcb is not None:
        inputs["qcb"] = jnp.asarray(qcb)
        inputs["ccb"] = jnp.asarray(ccb)
    packed, flat = jax_step(inputs)
    theirs_blob = np.asarray(packed["blob"])
    theirs_counters = np.asarray(flat)
    step = DecodeStep(ours, WIDTHS, mode, want_uncertain=True)
    mine_blob, mine_counters = step(
        torch.from_numpy(blob),
        None if ccb is None else torch.from_numpy(ccb),
        None if qcb is None else torch.from_numpy(qcb),
    )
    layout = wire.d2h_layout(ours, True)
    return (
        ours, layout,
        mine_blob.numpy().reshape(-1, layout["total"]),
        theirs_blob.reshape(-1, layout["total"]),
        mine_counters.numpy(), theirs_counters,
    )


def _hold_settled_rows(layout, mine, theirs, settled):
    """Indices and qcfail bits exact, confidences rtol 1e-5, on `settled` rows."""
    ints = slice(0, layout["int_bytes"])
    np.testing.assert_array_equal(mine[settled, ints], theirs[settled, ints])
    qc = slice(layout["qcfail_offset"], layout["qcfail_offset"] + layout["qcfail_bytes"])
    np.testing.assert_array_equal(mine[settled, qc], theirs[settled, qc])
    floats = slice(layout["float_offset"], layout["float_offset"] + layout["float_bytes"])
    conf_mine = np.ascontiguousarray(mine[:, floats]).view(np.float32)
    conf_theirs = np.ascontiguousarray(theirs[:, floats]).view(np.float32)
    np.testing.assert_allclose(conf_mine[settled], conf_theirs[settled], rtol=1e-5, atol=0)


def _hold_counters(ours, mine, theirs):
    """Integer columns exact, confidence sums rtol 1e-5."""
    assert mine.shape == theirs.shape
    offset = 0
    checked = 0
    for _, name, size in wire.counter_layout(ours):
        a, b = mine[offset : offset + size], theirs[offset : offset + size]
        if name in ("accumulated_confidence", "accumulated_pf_confidence"):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
            checked += int(a.sum())
        offset += size
    assert checked > 0


def test_decision_blob_matches(step_case):
    ours, layout, mine, theirs, _, _ = step_case
    assert mine.shape == theirs.shape == (4096, 14)
    u = layout["uncertain_offset"]
    unsure = (mine[:, u] | theirs[:, u]).astype(bool)
    assert 0 < unsure.mean() < 0.5
    np.testing.assert_array_equal(mine[:, u], theirs[:, u])
    _hold_settled_rows(layout, mine, theirs, ~unsure)


def test_counters_match(step_case):
    ours, _, _, _, mine, theirs = step_case
    _hold_counters(ours, mine, theirs)


@pytest.fixture(scope="module")
def fast_case():
    """The j4 flagship batch through both steps in fast mode (no
    uncertain byte: 13 bytes a read), and the port's hybrid step's
    uncertain flags, which name the rows the tolerances set apart."""
    ontology = flagship_ontology()
    reference = jax_compile(ontology)
    ours = carry_instrument(reference, "cpu")
    batch = synthetic_batch(ontology, 4096, seed=21, error_rate=0.05, quality_binning="rta3")
    blob, ccb, qcb = _blob(reference, batch, "j4", seed=22)
    jax_step = jax.jit(
        make_decode_step(
            reference, want_uncertain=False, want_counters=True,
            pack_outputs=True, h2d_widths=WIDTHS, qual_bits="j4",
        )
    )
    packed, flat = jax_step({"blob": jnp.asarray(blob), "qcb": jnp.asarray(qcb), "ccb": jnp.asarray(ccb)})
    inputs = [torch.from_numpy(x) for x in (blob, ccb, qcb)]
    mine_blob, mine_counters = DecodeStep(ours, WIDTHS, "j4", want_uncertain=False)(*inputs)
    hybrid_blob, _ = DecodeStep(ours, WIDTHS, "j4", want_uncertain=True)(*inputs)
    hybrid = wire.d2h_layout(ours, True)
    unsure = hybrid_blob.numpy().reshape(-1, hybrid["total"])[:, hybrid["uncertain_offset"]].astype(bool)
    layout = wire.d2h_layout(ours, False)
    return (
        ours, layout, unsure,
        mine_blob.numpy().reshape(-1, layout["total"]),
        np.asarray(packed["blob"]).reshape(-1, layout["total"]),
        mine_counters.numpy(), np.asarray(flat),
    )


def test_fast_decision_blob_matches(fast_case):
    """Fast mode's blob (no uncertain byte) held as the hybrid one's, off
    the rows the hybrid step flags."""
    _, layout, unsure, mine, theirs, _, _ = fast_case
    assert mine.shape == theirs.shape == (4096, 13)
    assert 0 < unsure.mean() < 0.5
    _hold_settled_rows(layout, mine, theirs, ~unsure)


def test_fast_counters_match(fast_case):
    ours, _, _, _, _, mine, theirs = fast_case
    _hold_counters(ours, mine, theirs)


@pytest.mark.parametrize("case,item", [("mdd", "K6"), ("large", "K7"), ("tp", "K8")])
def test_unported_configurations_refuse(case, item, monkeypatch):
    """Configurations the first slice refused now run, never through a
    silent torch fallback: MDD decoders (K6) and panels above LARGE_PANEL_B
    (K7) through the decode step; the PHENIQS_TP grid with R > 1 (K8 over
    the rows, tests/test_torch_grid.py), whose engine refuses a world that
    is not R * P ranks before it joins any group."""
    from pheniqs_tpu_torch.device import distributed
    from pheniqs_tpu_torch.device.instrument import LARGE_PANEL_B, compile_instrument
    from pheniqs_tpu_torch.engine.device import TorchDeviceEngine
    from test_device_classify import make_mdd_ontology, make_pamld_ontology, random_panel, simulate_reads

    rng = np.random.default_rng(2)
    if case == "tp":
        monkeypatch.setattr(distributed, "_GROUP", None)
        monkeypatch.setenv("WORLD_SIZE", "1")
        for shape in ("2:2", "1:2"):
            monkeypatch.setenv("PHENIQS_TP", shape)
            assert distributed.tp_shape() == tuple(int(x) for x in shape.split(":"))
            with pytest.raises(ValueError, match=rf"PHENIQS_TP={shape} needs .* ranks.*WORLD_SIZE is 1"):
                TorchDeviceEngine({}, hybrid=True, device="cpu")
        return
    if case == "mdd":
        panel = random_panel(rng, 8, 8)
        sample = make_mdd_ontology(panel, tolerance=1)
    else:
        panel = random_panel(rng, 1100, 12)
        sample = make_pamld_ontology(panel)
    instrument = compile_instrument({"sample": sample, "input segment cardinality": 1}, "cpu")
    dec = instrument.decoders[0]
    assert dec.algorithm == ("mdd" if case == "mdd" else "pamld")
    assert (dec.barcode_count > LARGE_PANEL_B) == (case == "large")
    code, qual, length = simulate_reads(rng, panel, 256)
    blob = wire.pack_h2d_blob([len(panel[0])], [(code, qual, length)], np.zeros(256, dtype=bool))
    step = DecodeStep(instrument, [len(panel[0])], 6, want_uncertain=True)
    out, flat = step(torch.from_numpy(blob))
    layout = wire.d2h_layout(instrument, True)
    rows = out.numpy().reshape(256, layout["total"])
    decoded = np.ascontiguousarray(rows[:, :2]).view(np.int16)[:, 0]
    assert (decoded > 0).mean() > 0.8
    assert flat.shape == (sum(size for _, _, size in wire.counter_layout(instrument)),)
