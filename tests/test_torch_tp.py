"""K8, the panel-sharded PAMLD posterior, on the CPU (mirrors
tests/test_tp.py): the port's in-process merge against the single-panel
posterior and against the JAX ``tp_posterior`` on the virtual 8-device
mesh, the gloo merge against the in-process one, the sharded decode step
against JAX's ``make_tp_sharded_decode_step``, and ``PHENIQS_TP=1:2`` end
to end over two gloo ranks (``run_e2e`` and ``torchrun ... mux``). The
grid with R > 1 is tests/test_torch_grid.py.

Tolerances, each with its reason:
  * best0, decisions and qcfail: exact (the shift and the maxima are
    exact in any order; only the total's sum order differs);
  * best_p, sigma_p against the single panel or JAX: rtol 5e-4, sigma_best
    1e-3, the runner-up 1e-3 (test_tp.py:81-97: matmul blocking differs
    between the sharded and whole shapes);
  * gloo against the in-process merge: byte-equal (both reduce the same
    stacked partials in rank order);
  * the decode step's confidences against JAX: rtol 1e-5 on rows neither
    flags (exp and the shard sums differ by a few ulp);
  * the engines: fast differs from the unsharded run in at most 1 of
    10,000 records, hybrid equals strict (test_tp.py:166, :226).
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pheniqs_tpu.device import compile_instrument as jax_compile
from pheniqs_tpu.device.step import make_tp_sharded_decode_step
from pheniqs_tpu.device.tp import tp_mesh
from pheniqs_tpu.device.tp import tp_posterior as jax_tp_posterior
from pheniqs_tpu_torch.device import tp, wire
from pheniqs_tpu_torch.device.flagship import flagship_ontology, synthetic_batch
from pheniqs_tpu_torch.device.instrument import UNIFORM_BASE_QUALITY, carry_instrument, compile_instrument
from pheniqs_tpu_torch.device.step import DecodeStep
from pheniqs_tpu_torch.kernels import pamld
from test_hybrid import decisions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def workload():
    """test_tp.py's workload: 512 flagship reads against a 600-barcode
    cellular panel; (decoder, features, qpos_uniform) as torch tensors."""
    ontology = flagship_ontology(sample_barcodes=16, cellular_barcodes=600)
    instrument = compile_instrument(ontology, "cpu")
    batch = synthetic_batch(ontology, 512, seed=9)
    decoder = next(d for d in instrument.decoders if d.classifier_type == "cellular")
    code, qual, _ = batch["segments"][3]
    obs_code = torch.from_numpy(code[:, :16].astype(np.int32))
    obs_qual = torch.from_numpy(qual[:, :16].astype(np.int32))
    features = pamld.observation_features_plain(obs_code, obs_qual)
    qpos = (obs_qual > 0).to(torch.float32).sum(dim=1) * UNIFORM_BASE_QUALITY
    return decoder, features, qpos


def _noise(decoder) -> float:
    return float(decoder.noise * decoder.random_barcode_probability)


@pytest.mark.parametrize("panel_size", [2, 4, 8])
def test_tp_posterior_matches_single_device(workload, panel_size):
    decoder, features, qpos = workload
    sigma = features @ decoder.likelihood_matrix + qpos[:, None]
    shift = sigma.min(dim=1, keepdim=True).values
    prior = torch.exp(pamld.LN_PHRED_BASE * (sigma - shift)) * decoder.concentration[None, :]
    ref_total = prior.sum(dim=1) + torch.exp(float(np.log(_noise(decoder))) - pamld.LN_PHRED_BASE * shift[:, 0])
    ref_best0 = torch.argmax(prior, dim=1)

    best0, best_p, sigma_p, sigma_best, second_p = tp.tp_posterior(
        features, qpos, decoder.likelihood_matrix, decoder.concentration, _noise(decoder), panel_size
    )
    np.testing.assert_array_equal(best0.numpy(), ref_best0.numpy())
    np.testing.assert_allclose(best_p.numpy(), prior.max(dim=1).values.numpy(), rtol=5e-4)
    np.testing.assert_allclose(sigma_p.numpy(), ref_total.numpy(), rtol=5e-4)
    np.testing.assert_allclose(
        sigma_best.numpy(), torch.gather(sigma, 1, ref_best0[:, None])[:, 0].numpy(), rtol=1e-3, atol=1e-3
    )
    part = np.partition(prior.numpy(), -2, axis=1)
    np.testing.assert_allclose(second_p.numpy(), part[:, -2], rtol=1e-3, atol=1e-30)


@pytest.mark.parametrize("panel_size", [2, 4, 8])
def test_tp_posterior_matches_jax(workload, panel_size):
    """The same numpy inputs through the JAX ``tp_posterior`` on a (1, P)
    mesh of the virtual CPU devices and through the port's."""
    if len(jax.devices()) < panel_size:
        pytest.skip("needs the virtual 8-device mesh")
    decoder, features, qpos = workload
    inputs = [x.numpy() for x in (features, qpos, decoder.likelihood_matrix, decoder.concentration)]
    theirs = jax_tp_posterior(tp_mesh(1, panel_size), *map(jnp.asarray, inputs), _noise(decoder))
    ours = tp.tp_posterior(*map(torch.from_numpy, inputs), _noise(decoder), panel_size)
    names = ("best0", "best_p", "sigma_p", "sigma_best", "second_p")
    for name, mine, reference in zip(names, ours, theirs):
        mine, reference = mine.numpy(), np.asarray(reference)
        if name == "best0":
            np.testing.assert_array_equal(mine, reference)
        else:
            rtol = 5e-4 if name in ("best_p", "sigma_p") else 1e-3
            np.testing.assert_allclose(mine, reference, rtol=rtol, atol=1e-30, err_msg=name)


def _rank_env(rank: int, size: int, port: int, **extra) -> dict:
    env = dict(os.environ)
    env.update(
        PYTHONPATH=REPO, PHENIQS_TP=f"1:{size}", RANK=str(rank), WORLD_SIZE=str(size),
        LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(size), MASTER_ADDR="localhost",
        MASTER_PORT=str(port), PHENIQS_TORCH_DEVICE="cpu", TORCHELASTIC_USE_AGENT_STORE="True",
    )
    env.update(extra)
    return env


def _run_ranks(code: str, size: int, args=(), timeout: float = 300, **extra) -> list[str]:
    """Run `code` in `size` rank processes. The rendezvous store is held
    here, as torchrun's agent holds it, on a port bound once and kept: a
    port freed after probing could be taken by another test process before
    rank 0 bound it, and every rank connects to this store as a client.
    When a rank fails or the time runs out, every rank still running is
    killed, so no rank is left holding the others."""
    store = torch.distributed.TCPStore("localhost", 0, world_size=size, is_master=True, wait_for_workers=False)
    port = store.port
    files = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")) for _ in range(size)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code, *args], env=_rank_env(rank, size, port, **extra),
            stdout=out, stderr=err, text=True,
        )
        for rank, (out, err) in enumerate(files)
    ]
    deadline = time.monotonic() + timeout
    try:
        while any(proc.poll() is None for proc in procs):
            if any(proc.returncode for proc in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    outputs = []
    for rank, (proc, (out, err)) in enumerate(zip(procs, files)):
        out.seek(0)
        err.seek(0)
        outputs.append((out.read(), err.read()))
        out.close()
        err.close()
    for rank, (proc, (_, err)) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, f"rank {rank} of {size} exited {proc.returncode}:\n{err[-3000:]}"
    return [out for out, _ in outputs]


MERGE = r"""
import sys
import numpy as np
import torch
from pheniqs_tpu_torch.device import tp
from pheniqs_tpu_torch.device.distributed import panel_group
from pheniqs_tpu_torch.kernels import pamld

rng = np.random.default_rng(5)
n, fw, b = 300, 40, 1001
features = torch.from_numpy(rng.normal(0.0, 4.0, (n, fw)).astype(np.float32))
qpos = torch.from_numpy(rng.uniform(10.0, 40.0, n).astype(np.float32))
matrix = torch.from_numpy((rng.random((fw, b)) < 0.3).astype(np.float32))
conc = torch.from_numpy(rng.dirichlet(np.ones(b)).astype(np.float32))
group = panel_group("cpu")
local_b = tp.shard_width(b, group.size)
shard = tp.PanelShard(group.rank * local_b, local_b, b, None, None, None)
shard.matrix = matrix[:, shard.base : shard.base + shard.count]
shard.concentration = conc[shard.base : shard.base + shard.count]
posterior = pamld.posterior_panel_sharded_plain(features, qpos, [shard], 0.01, group)
stacked = tp.tp_posterior(features, qpos, matrix, conc, 0.01, group.size)
for mine, theirs in zip(posterior, stacked):
    assert mine.dtype == theirs.dtype and mine.numpy().tobytes() == theirs.numpy().tobytes()
print(group.rank, "equal")
"""


def test_tp_merge_gloo_matches_in_process():
    """Two gloo ranks, each holding one shard, merge to the same bytes as
    one process holding both (B odd: the last shard has a padding column)."""
    outputs = _run_ranks(MERGE, 2)
    assert [out.split()[-1] for out in outputs] == ["equal", "equal"]


@pytest.fixture(scope="module", params=[2, 4])
def tp_step_case(request):
    """The flagship with a 600-barcode cellular panel, its panel sharded
    over P (threshold 128): JAX's TP step on a (1, P) mesh and the port's
    DecodeStep holding every shard in process."""
    panel_size = request.param
    if len(jax.devices()) < panel_size:
        pytest.skip("needs the virtual 8-device mesh")
    ontology = flagship_ontology(sample_barcodes=24, cellular_barcodes=600)
    reference = jax_compile(ontology)
    ours = carry_instrument(reference, "cpu")
    n = 1024
    batch = synthetic_batch(ontology, n, seed=43, error_rate=0.05)
    rng = np.random.default_rng(44)
    used = [batch["segments"][i] for i in reference.used_segments]
    for _, _, length in used:
        length[rng.random(n) < 0.02] = rng.integers(0, 8)
    qcfail = rng.random(n) < 0.03
    widths = [8, 8, 28]
    code = np.concatenate([c.ravel() for c, _, _ in used])
    qual = np.concatenate([q.ravel() for _, q, _ in used])
    pairs = np.unique((code.astype(np.int64) & 15) << 8 | np.minimum(qual, 63))
    ccb, qcb, lut_idx, lut_exact = wire.sense_joint_codebook(pairs)
    blob = wire.pack_h2d_blob(widths, used, qcfail, qual_bits="j4", qual_lut=(lut_idx, lut_exact))
    mesh = tp_mesh(1, panel_size)
    jax_step, shard_panels, positions = make_tp_sharded_decode_step(
        reference, mesh, want_uncertain=True, want_counters=True, pack_outputs=True,
        h2d_widths=widths, shard_threshold=128, qual_bits="j4",
    )
    packed, flat = jax_step(
        {"blob": jnp.asarray(blob), "qcb": jnp.asarray(qcb), "ccb": jnp.asarray(ccb)}, shard_panels()
    )
    assert positions == tp.sharded_positions(ours, 128) == [2]
    shards = {2: [tp.shard_panel(ours.decoders[2], rank, panel_size) for rank in range(panel_size)]}
    step = DecodeStep(ours, widths, "j4", want_uncertain=True, panel_shards=shards)
    mine_blob, mine_counters = step(*(torch.from_numpy(x) for x in (blob, ccb, qcb)))
    layout = wire.d2h_layout(ours, True)
    return (
        ours, layout, mine_blob.numpy().reshape(-1, layout["total"]),
        np.asarray(packed["blob"]).reshape(-1, layout["total"]), mine_counters.numpy(), np.asarray(flat),
    )


def test_tp_decode_step_matches_jax(tp_step_case):
    ours, layout, mine, theirs, mine_counters, their_counters = tp_step_case
    u = layout["uncertain_offset"]
    unsure = (mine[:, u] | theirs[:, u]).astype(bool)
    assert unsure.mean() < 0.5
    settled = ~unsure
    ints = slice(0, layout["int_bytes"])
    qc = slice(layout["qcfail_offset"], layout["qcfail_offset"] + layout["qcfail_bytes"])
    np.testing.assert_array_equal(mine[settled, ints], theirs[settled, ints])
    np.testing.assert_array_equal(mine[settled, qc], theirs[settled, qc])
    np.testing.assert_array_equal(mine[:, u], theirs[:, u])
    floats = slice(layout["float_offset"], layout["float_offset"] + layout["float_bytes"])
    conf_mine = np.ascontiguousarray(mine[:, floats]).view(np.float32)
    conf_theirs = np.ascontiguousarray(theirs[:, floats]).view(np.float32)
    np.testing.assert_allclose(conf_mine[settled], conf_theirs[settled], rtol=1e-5, atol=0)
    decoded = np.ascontiguousarray(mine[:, ints]).view(np.int16)
    assert (decoded[settled, 1] > 0).mean() > 0.8  # the sharded cellular decoder
    offset = 0
    for _, name, size in wire.counter_layout(ours):
        a, b = mine_counters[offset : offset + size], their_counters[offset : offset + size]
        if name in ("accumulated_confidence", "accumulated_pf_confidence"):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
        offset += size


E2E = r"""
import json, os, sys
from pheniqs_tpu_torch.benchmark import run_e2e
from pheniqs_tpu_torch.device.flagship import flagship_ontology
paths, out, fidelity, sample, cellular = json.loads(sys.argv[1])
ontology = flagship_ontology(sample_barcodes=sample, cellular_barcodes=cellular)
stats = run_e2e(paths, out, fidelity=fidelity, threads=2, batch_size=4096, device="cpu", ontology=ontology)
print(json.dumps(stats))
"""


def _flagship_input(tmp_path, n: int, sample: int, cellular: int):
    from pheniqs_tpu_torch.benchmark import synthesize_fastq_input

    ontology = flagship_ontology(sample_barcodes=sample, cellular_barcodes=cellular)
    return synthesize_fastq_input(str(tmp_path / "input"), n, ontology=ontology), ontology


def test_tp_engine_decisions_match_default(tmp_path):
    """run_e2e over two gloo ranks (PHENIQS_TP=1:2, the 384-barcode panel
    sharded at threshold 128) gives the unsharded port's fast decisions."""
    from pheniqs_tpu_torch.benchmark import run_e2e

    paths, ontology = _flagship_input(tmp_path, 10000, 96, 384)
    default = str(tmp_path / "default.sam")
    run_e2e(paths, default, fidelity="fast", threads=2, batch_size=4096, device="cpu", ontology=ontology)
    sharded = str(tmp_path / "tp.sam")
    outputs = _run_ranks(E2E, 2, [json.dumps([paths, sharded, "fast", 96, 384])], PHENIQS_TP_THRESHOLD="128")
    stats = json.loads(outputs[0].strip().splitlines()[-1])
    assert stats["reads"] == 10000
    assert outputs[1].strip().splitlines()[-1] == "null"  # the follower writes nothing
    ours = decisions(open(sharded).read())
    reference = decisions(open(default).read())
    assert len(ours) == len(reference) == 10000
    mismatches = sum(1 for a, b in zip(ours, reference) if a != b)
    assert mismatches <= len(ours) // 10000, mismatches


def test_tp_hybrid_decisions_match_strict(tmp_path):
    """``torchrun --nproc-per-node 2 -m pheniqs_tpu_torch mux --fidelity
    hybrid`` with PHENIQS_TP=1:2 (threshold 64) equals the reference's
    strict engine on every record."""
    paths, ontology = _flagship_input(tmp_path, 20000, 24, 300)
    config = {
        "input": list(paths),
        "template": {"transform": {"token": ["1::"]}},
        "sample": ontology["sample"],
        "cellular": ontology["cellular"],
        "molecular": ontology["molecular"],
    }
    outputs = {}
    for label, command, extra in (
        ("strict", [sys.executable, "-m", "pheniqs_tpu.cli.main"], ["--fidelity", "strict"]),
        ("tp_hybrid", [sys.executable, "-m", "torch.distributed.run", "--standalone",
                       "--nproc-per-node", "2", "-m", "pheniqs_tpu_torch"], ["--fidelity", "hybrid"]),
    ):
        out = tmp_path / f"out_{label}.sam"
        config_path = tmp_path / f"job_{label}.json"
        config_path.write_text(json.dumps(dict(config, output=[str(out)])))
        env = dict(os.environ, PYTHONPATH=REPO, PHENIQS_TORCH_DEVICE="cpu", JAX_PLATFORMS="cpu",
                   PHENIQS_TP="1:2", PHENIQS_TP_THRESHOLD="64")
        if label == "strict":
            env.pop("PHENIQS_TP")
        result = subprocess.run(
            [*command, "mux", "--config", str(config_path), *extra, "--threads", "2", "--batch-size", "8192"],
            env=env, capture_output=True, text=True, timeout=600,
        )
        assert result.returncode == 0, (label, result.stderr[-3000:])
        outputs[label] = decisions(out.read_text())
    assert len(outputs["strict"]) == 20000
    assert outputs["strict"] == outputs["tp_hybrid"]


def test_tp_reads_axis_refuses(monkeypatch):
    """R > 1 (reads data parallel inside the grid) is accepted since the
    grid was ported; an axis of no ranks is refused with the value named."""
    from pheniqs_tpu_torch.device.distributed import tp_shape

    monkeypatch.setenv("PHENIQS_TP", "2:4")
    assert tp_shape() == (2, 4)
    monkeypatch.setenv("PHENIQS_TP", "0:4")
    with pytest.raises(ValueError, match=r"PHENIQS_TP=0:4"):
        tp_shape()
    monkeypatch.setenv("PHENIQS_TP", "1:4")
    assert tp_shape() == (1, 4)
