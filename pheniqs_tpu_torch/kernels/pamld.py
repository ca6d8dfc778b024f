"""The PAMLD classify of one decoder: K1 with K2 fused (csrc/pamld.cu),
one tile loop for panels of any size, the panel split into slices across
blocks (a panel of one tile, K1's, cut below the tile); K7, the same loop
past 1024 barcodes; and K8, the same slices over the shards of a panel
split across ranks (``pamld_classify_sharded``).

``pamld_classify`` computes, per read, the PAMLD posterior over the panel
and everything the decode step needs from it: decoded index, argmax,
distance to the decoded barcode, branch, confidence, chained qcfail and
(hybrid) the uncertain mask of the derived f32 bound. On a CUDA tensor it
launches the kernel: one launch over a panel of one slice, else stage A
(each slice's row minimum), stage B (each slice's partials) and the merge
(stage C), with S slices from ``slice_plan``; an observation of any width
runs (instances of MAXW 16, 32 and 64 keep a read in registers; a wider
one runs the looped instance, whose read state one more launch writes to
device memory first and whose tile loop is blocked, 16 barcodes by 16
positions, ``instance_width``). On a CPU tensor it runs the
plain version below, the torch port of
``pheniqs_tpu.device.classify.pamld_classify_device``: the monolithic
posterior for B <= 1024, ``_posterior_chunked`` above it, and the
row-gather distance (as exact as the TPU's match contraction).
``posterior_sliced_plain`` is the plain algebra of the slices,
``posterior_panel_sharded_plain`` that of K8's shards
(``_posterior_panel_sharded`` over the shards one process holds).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..device.instrument import (
    LARGE_PANEL_B,
    LN_PHRED_BASE,
    STRICT_CODES,
    UNIFORM_BASE_QUALITY,
    analytic_tpq,
)

#: launches of K1 in this process on panels of at most LARGE_PANEL_B
#: barcodes: one over a panel of one slice, else stages A, B and C
launches = 0
#: launches of the tile loop on larger panels (K7, the TPU's chunked
#: posterior): one over a panel of one slice, else stages A, B and C
chunked_launches = 0
#: launches of K8's stages on panel shards (A and B per shard, the merge
#: of a shard's slices where it has more than one, C per call)
panel_sharded_launches = 0
#: launches of the feature kernel (``observation_features`` on CUDA; the
#: main path never runs it: K1 keeps the features in registers)
feature_launches = 0

BRANCH_PASS = 0
BRANCH_LOW_CONFIDENCE = 1
BRANCH_NOISE = 2

#: sigma beyond which 10^(-0.1*sigma) underflows even a subnormal float64
F64_UNDERFLOW_SIGMA = 3233.0
#: the hybrid bound's constants (pheniqs_tpu/device/classify.py:58-89)
HYBRID_SAFETY = 4.0
U32 = float(2.0**-24)
TERM_BOUND = 13.74
#: the widest observation of the tile loop's register instances (MAXW 16,
#: 32 and 64); wider ones run the looped instance (MAXW 0), whose read state
#: a launch of its own writes to device memory first
LOOPED_PAST = 64
#: the dynamic shared memory a block may take on the H100, by opt-in
#: (csrc/pamld.cu PHQ_PAMLD_SMEM_MAX)
SHARED_LIMIT = 227 * 1024
#: barcodes per chunk of the online posterior (classify.py:_posterior_chunked)
POSTERIOR_CHUNK = 1024


def gamma(k: float) -> float:
    ku = k * U32
    return ku / (1.0 - ku)


def _f32(value: float) -> float:
    return float(np.float32(value))


def noise_sigma_threshold(dec) -> float:
    """Noise filter in log space: 10^(-0.1*sigma) > rbp <=> sigma < this."""
    return float(np.log(dec.random_barcode_probability) / LN_PHRED_BASE)


def observation_features_plain(obs_code: torch.Tensor, obs_qual: torch.Tensor) -> torch.Tensor:
    """Read-side feature tensor F (N, 5W) of the likelihood contraction:
    per position onehot4(o) * (tpq - q) and strict(o) * (q - UNIFORM),
    gated on q > 0 (reference phred.cpp:39-72)."""
    n, w = obs_code.shape
    obs_code = obs_code.to(torch.int32)
    obs_qual = obs_qual.to(torch.int32)
    q = obs_qual.to(torch.float32)
    tpq = analytic_tpq(obs_qual)
    positive = obs_qual > 0
    strict_o = (
        (obs_code == 1) | (obs_code == 2) | (obs_code == 4) | (obs_code == 8)
    ) & positive
    onehot4 = torch.stack(
        [((obs_code == c) & positive).to(torch.float32) for c in (1, 2, 4, 8)], dim=-1
    )
    f_match = onehot4 * (tpq - q)[..., None]
    f_strict = (strict_o.to(torch.float32) * (q - UNIFORM_BASE_QUALITY))[..., None]
    return torch.cat([f_match, f_strict], dim=-1).reshape(n, w * 5)


def chunk_gamma(barcode_count: int) -> float:
    """The bound's rescale term 2*gamma(2*ceil(B/1024)) for panels past
    LARGE_PANEL_B, 0 below (classify.py:637-644)."""
    chunks = -(-barcode_count // POSTERIOR_CHUNK) if barcode_count > LARGE_PANEL_B else 0
    return 2.0 * gamma(2 * chunks)


def sigma_bound(w: int, eps: float, q_sum):
    """d_sigma(read) of classify.py:57-84: how far an f32 sigma of a read
    of width `w` and quality sum `q_sum` may lie from the exact one,
    gamma_{2W+2} * (2 * q_sum + 13.74 * W), plus the TPQ epsilon per
    position; it holds for any order of the sum's terms."""
    return gamma(2 * w + 2) * (2.0 * q_sum + TERM_BOUND * w) + eps * w


def _uncertain_margins(dec, w: int, eps: float, q_sum: torch.Tensor):
    """(rel_eps, sigma_eps) of the derived per-read bound, in the f32
    evaluation order of classify.py:629-646."""
    lam = float(abs(LN_PHRED_BASE))
    d_sigma = sigma_bound(w, eps, q_sum)
    rel_eps = HYBRID_SAFETY * (
        4.0 * lam * d_sigma
        + 2.0 * gamma(dec.barcode_count + 2)
        + chunk_gamma(dec.barcode_count)
        + 8.0 * U32
    )
    sigma_eps = HYBRID_SAFETY * d_sigma + 1e-4
    return rel_eps, sigma_eps


def _second_max(p: torch.Tensor, best0: torch.Tensor) -> torch.Tensor:
    """Runner-up per row: the argmax column masked to 0, re-maxed
    (duplicated maxima at other columns survive; classify.py:_second_max)."""
    columns = torch.arange(p.shape[1], device=p.device)
    return torch.where(columns[None, :] == best0[:, None], 0.0, p).max(dim=1).values


def _noise_shifted(adjusted_noise: float, shift: torch.Tensor) -> torch.Tensor:
    """noise * rbp in the frame shifted by the row minimum sigma."""
    if adjusted_noise > 0.0:
        return torch.exp(float(np.log(adjusted_noise)) - LN_PHRED_BASE * shift)
    return torch.zeros_like(shift)


def posterior_plain(features, qpos_uniform, matrix, concentration, adjusted_noise):
    """The monolithic posterior of classify.py:465-504 (B <= 1024):
    (best0, best_p, sigma_p, sigma_decoded, second_p)."""
    sigma_q = features @ matrix + qpos_uniform[:, None]
    shift = sigma_q.min(dim=1).values
    prior_adjusted = torch.exp(LN_PHRED_BASE * (sigma_q - shift[:, None])) * concentration[None, :]
    sigma_p = prior_adjusted.sum(dim=1) + _noise_shifted(adjusted_noise, shift)
    best_p = prior_adjusted.max(dim=1).values
    best0 = torch.argmax(prior_adjusted, dim=1)  # first maximum wins
    sigma_decoded = torch.gather(sigma_q, 1, best0[:, None])[:, 0]
    return best0, best_p, sigma_p, sigma_decoded, _second_max(prior_adjusted, best0)


def posterior_chunked_plain(features, qpos_uniform, matrix, concentration, adjusted_noise,
                            chunk: int = POSTERIOR_CHUNK):
    """``_posterior_chunked`` (classify.py:240-332): an online posterior over
    1024-barcode chunks with a running min shift that rescales the partial
    sums once per chunk, so (N, B) never exists. The last chunk is left
    short instead of padded: a padding column's p is exactly 0 there and
    never wins, so the results are the same.
    (best0, best_p, sigma_p, sigma_decoded, second_p)."""
    n = features.shape[0]
    device = features.device
    big = 3.0e38
    shift = torch.full((n,), big, dtype=torch.float32, device=device)
    total = torch.zeros(n, dtype=torch.float32, device=device)
    best_p = torch.zeros(n, dtype=torch.float32, device=device)
    best0 = torch.zeros(n, dtype=torch.int64, device=device)
    sigma_best = torch.full((n,), big, dtype=torch.float32, device=device)
    second_p = torch.zeros(n, dtype=torch.float32, device=device)
    for start in range(0, matrix.shape[1], chunk):
        sigma_c = features @ matrix[:, start : start + chunk] + qpos_uniform[:, None]
        new_shift = torch.minimum(shift, sigma_c.min(dim=1).values)
        rescale = torch.exp(LN_PHRED_BASE * (shift - new_shift))
        p = torch.exp(LN_PHRED_BASE * (sigma_c - new_shift[:, None])) * concentration[None, start : start + chunk]
        total = total * rescale + p.sum(dim=1)
        best_p = best_p * rescale
        second_p = second_p * rescale
        chunk_best = torch.argmax(p, dim=1)
        chunk_best_p = torch.gather(p, 1, chunk_best[:, None])[:, 0]
        chunk_second_p = _second_max(p, chunk_best)
        better = chunk_best_p > best_p
        second_p = torch.where(
            better, torch.maximum(best_p, chunk_second_p), torch.maximum(second_p, chunk_best_p)
        )
        best_p = torch.where(better, chunk_best_p, best_p)
        best0 = torch.where(better, start + chunk_best, best0)
        sigma_best = torch.where(better, torch.gather(sigma_c, 1, chunk_best[:, None])[:, 0], sigma_best)
        shift = new_shift
    sigma_p = total + _noise_shifted(adjusted_noise, shift)
    return best0, best_p, sigma_p, sigma_best, second_p


#: sigma of a padding column, and an empty shard's row minimum
BIG_SIGMA = 3.0e38
#: the rows of a shard's partials (stage B of K8), (5, N) int32 with the
#: f32 rows as their bits: total, best p, global best index, runner-up,
#: sigma of the best
PARTIAL_ROWS = ("total", "best_p", "best0", "second_p", "sigma_best")


def pack_partials(total, best_p, best0, second_p, sigma_best) -> torch.Tensor:
    return torch.stack([
        total.view(torch.int32), best_p.view(torch.int32), best0.to(torch.int32),
        second_p.view(torch.int32), sigma_best.view(torch.int32),
    ])


def unpack_partials(partials: torch.Tensor) -> dict:
    rows = dict(zip(PARTIAL_ROWS, partials))
    return {key: row if key == "best0" else row.view(torch.float32) for key, row in rows.items()}


def _shard_sigma_chunks(features, qpos_uniform, shard, chunk: int = POSTERIOR_CHUNK):
    """(first column, sigma (N, columns)) over the shard's real columns in
    chunks of `chunk`, so (N, B / P) never exists at once."""
    for start in range(0, shard.count, chunk):
        columns = slice(start, min(start + chunk, shard.count))
        yield start, features @ shard.matrix[:, columns] + qpos_uniform[:, None]


def panel_shift_plain(features, qpos_uniform, shard) -> torch.Tensor:
    """Stage A over one shard: the row minimum of sigma over its real
    columns (BIG_SIGMA for a shard of padding only)."""
    shift = torch.full((features.shape[0],), BIG_SIGMA, dtype=torch.float32, device=features.device)
    for _, sigma in _shard_sigma_chunks(features, qpos_uniform, shard):
        shift = torch.minimum(shift, sigma.min(dim=1).values)
    return shift


def panel_partials_plain(features, qpos_uniform, shard, shift) -> torch.Tensor:
    """Stage B over one shard in the frame of the merged `shift`
    (tp.py:_local_posterior with a given shift, in column chunks): the
    packed (5, N) partials, the best index global (base + local, the first
    maximum)."""
    n = features.shape[0]
    device = features.device
    total = torch.zeros(n, dtype=torch.float32, device=device)
    best_p = torch.full((n,), -1.0, dtype=torch.float32, device=device)
    second_p = torch.zeros(n, dtype=torch.float32, device=device)
    sigma_best = torch.zeros(n, dtype=torch.float32, device=device)
    best0 = torch.zeros(n, dtype=torch.int64, device=device)
    for start, sigma in _shard_sigma_chunks(features, qpos_uniform, shard):
        p = torch.exp(LN_PHRED_BASE * (sigma - shift[:, None])) * shard.concentration[
            None, start : start + sigma.shape[1]
        ]
        total = total + p.sum(dim=1)
        chunk_best = torch.argmax(p, dim=1)  # first maximum wins
        chunk_best_p = torch.gather(p, 1, chunk_best[:, None])[:, 0]
        better = chunk_best_p > best_p
        second_p = torch.where(
            better, torch.maximum(best_p, _second_max(p, chunk_best)), torch.maximum(second_p, chunk_best_p)
        )
        best_p = torch.where(better, chunk_best_p, best_p)
        best0 = torch.where(better, start + chunk_best, best0)
        sigma_best = torch.where(better, torch.gather(sigma, 1, chunk_best[:, None])[:, 0], sigma_best)
    return pack_partials(total, best_p, shard.base + best0, second_p, sigma_best)


def panel_merged_plain(features, qpos_uniform, shards, group=None):
    """Stages A and B over `shards`, the panel shards this process holds,
    with their merges (device/tp.py): with a process `group` its one
    shard, the merges collectives over the group's ranks; without, every
    shard of the panel, merged in process. Returns (shift (N,), the merged
    posterior by PARTIAL_ROWS)."""
    from ..device.tp import merge_panel_partials, merge_panel_shift

    shift = merge_panel_shift(
        torch.stack([panel_shift_plain(features, qpos_uniform, shard) for shard in shards]), group
    )
    merged = merge_panel_partials(
        torch.stack([panel_partials_plain(features, qpos_uniform, shard, shift) for shard in shards]), group
    )
    return shift, unpack_partials(merged)


def posterior_panel_sharded_plain(features, qpos_uniform, shards, adjusted_noise, group=None):
    """``_posterior_panel_sharded`` (classify.py:335-399) over `shards`
    (panel_merged_plain): (best0, best_p, sigma_p, sigma_decoded,
    second_p)."""
    shift, merged = panel_merged_plain(features, qpos_uniform, shards, group)
    sigma_p = merged["total"] + _noise_shifted(adjusted_noise, shift)
    return (merged["best0"].to(torch.int64), merged["best_p"], sigma_p, merged["sigma_best"],
            merged["second_p"])


def posterior_sliced_plain(features, qpos_uniform, matrix, concentration, adjusted_noise, columns):
    """The tile loop's posterior over slices of the panel (K1 and K7), `columns` the (start, stop)
    of each (SlicePlan.columns): each slice's row minimum and, in the frame
    of their minimum, its partials, merged in slice order by
    device/tp.py:reduce_partials. (best0, best_p, sigma_p, sigma_decoded,
    second_p)."""
    from ..device.tp import PanelShard

    b = matrix.shape[1]
    slices = [
        PanelShard(start, stop - start, b, None, matrix[:, start:stop], concentration[start:stop])
        for start, stop in columns
    ]
    return posterior_panel_sharded_plain(features, qpos_uniform, slices, adjusted_noise)


# --- the slice plan -------------------------------------------------------
#: the waves of resident blocks a sliced launch aims at: the last wave's
#: idle share is then at most a quarter of one
SLICE_WAVES = 4


@dataclass(frozen=True)
class TileLoop:
    """What the card says of the tile loop at one observation width
    (csrc/pamld.cu phq_pamld_info): barcodes a tile holds, threads and reads
    a block, the card's SM count, the instance's MAXW, per instance
    (classify, stage A, stage B) its resident blocks per SM, registers and
    local (spill) bytes a thread, the barcodes a step of the barcode loop
    takes, and the least barcodes of a slice cut below a tile."""

    tile: int
    threads: int
    reads_per_block: int
    sms: int
    maxw: int
    instances: dict
    unroll: int
    unit: int

    @property
    def slots(self) -> int:
        """Resident block slots of the card for the sliced stages."""
        return self.sms * max(self.instances["stage A"][0], self.instances["stage B"][0])

    @property
    def whole_slots(self) -> int:
        """Resident block slots of the card for the one-launch instance."""
        return self.sms * self.instances["classify"][0]


@dataclass(frozen=True)
class SlicePlan:
    """`slices` contiguous runs of the `barcodes` columns, cut at multiples
    of `cut` barcodes (a whole tile of `tile`, or the kernel's unit), for
    `read_blocks` blocks of reads."""

    slices: int
    barcodes: int
    tile: int
    read_blocks: int
    slots: int
    cut: int

    @property
    def cuts(self) -> int:
        return -(-self.barcodes // self.cut)

    @property
    def waves(self) -> float:
        return self.read_blocks * self.slices / self.slots

    @property
    def slot_use(self) -> tuple[int, int]:
        """(blocks, block slots of the whole waves they take)."""
        blocks = self.read_blocks * self.slices
        return blocks, -(-blocks // self.slots) * self.slots

    def columns(self) -> list[tuple[int, int]]:
        """(start, stop) of each slice: cuts [s*C/S, (s+1)*C/S) of the C
        runs of `cut` barcodes, as the kernel derives them from its block's
        slice index."""
        c, s = self.cuts, self.slices
        return [
            (k * c // s * self.cut, min((k + 1) * c // s * self.cut, self.barcodes))
            for k in range(s)
        ]


def slice_plan(n: int, barcodes: int, tile: int, reads_per_block: int, slots: int, unit: int,
               whole_slots: int = 0) -> SlicePlan:
    """The smallest number of slices that gives SLICE_WAVES waves of the
    card's `slots` resident blocks over the ceil(n / reads_per_block) blocks
    of reads. The slices are cut at whole tiles where the tiles of the
    `barcodes` columns give those waves (a whitelist's), else at multiples
    of `unit` barcodes (a panel of one tile, K1's, too); each slice is at
    least one cut. With `whole_slots`, the card's slots for the one-launch
    instance, a panel of one tile keeps one launch unless its slices fill
    the block slots of the waves they take better than one launch fills
    its own: a slice adds its prologues (once per stage) and the merge, so
    it pays only where one launch would leave slots idle that the slices
    use."""
    read_blocks = max(1, -(-n // reads_per_block))
    wanted = -(-SLICE_WAVES * slots // read_blocks)
    cut = tile if -(-barcodes // tile) >= wanted else unit
    plan = SlicePlan(max(1, min(-(-barcodes // cut), wanted)), barcodes, tile, read_blocks, slots, cut)
    if whole_slots and barcodes <= tile:
        one = SlicePlan(1, barcodes, tile, read_blocks, whole_slots, max(barcodes, 1))
        (blocks, held), (one_blocks, one_held) = plan.slot_use, one.slot_use
        if plan.slices == 1 or blocks * one_held <= one_blocks * held:
            return one
    return plan


_TILE_LOOPS: dict = {}


def looped_shared_bytes(w: int) -> int:
    """The dynamic shared bytes of the looped instance's least tile, one
    barcode row of `w` positions (csrc/pamld.cu phq_pamld_smem at one
    row): past SHARED_LIMIT, from 231,393 positions, no block holds it."""
    return 256 * 4 + 4 * 4 + 16 * -(-w // 16) + 1


def instance_width(w: int) -> int:
    """The MAXW of the tile loop's instance for observation width `w`: 16,
    32 or 64, or 0 for the looped instance past LOOPED_PAST."""
    for maxw in (16, 32, LOOPED_PAST):
        if w <= maxw:
            return maxw
    return 0


def tile_loop(w: int, device) -> TileLoop:
    """The tile loop's facts at observation width `w` on CUDA `device`
    (asked once per instance and card; the looped instance's tile depends
    on the row's 16-byte vectors too)."""
    from .build import check, library

    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    maxw = instance_width(w)
    key = (maxw, -(-w // 16) if maxw == 0 else 0, index)
    if key not in _TILE_LOOPS:
        out = np.zeros(16, dtype=np.int32)
        with torch.cuda.device(index):
            check(library().phq_pamld_info(w, out.ctypes.data), "pamld_info")
        tile, threads, reads, sms, maxw = (int(x) for x in out[:5])
        instances = {
            name: tuple(int(x) for x in out[5 + 3 * k : 8 + 3 * k])
            for k, name in enumerate(("classify", "stage A", "stage B"))
        }
        _TILE_LOOPS[key] = TileLoop(tile, threads, reads, sms, maxw, instances, int(out[14]), int(out[15]))
    return _TILE_LOOPS[key]


def plan_for(n: int, barcodes: int, w: int, device) -> SlicePlan:
    """The slice plan of one launch of the tile loop on the card. The
    looped instance keeps one launch only for a panel of one cut: its
    one-launch kernel holds both passes' blocked loops at the register cap
    and ran slower on an H100 than its stages A and B where both plans
    fill their slots alike (PERF.md)."""
    loop = tile_loop(w, device)
    whole = loop.whole_slots if loop.maxw else 0
    return slice_plan(n, barcodes, loop.tile, loop.reads_per_block, loop.slots, loop.unit, whole)


def sliced_plan(n: int, barcodes: int, w: int, device) -> SlicePlan:
    """The plan the card would give a panel of `barcodes` at `n` reads
    without the one-launch option (slice_plan without whole_slots)."""
    loop = tile_loop(w, device)
    return slice_plan(n, barcodes, loop.tile, loop.reads_per_block, loop.slots, loop.unit)


#: ulps of the confidence threshold's neighbourhood inside which the
#: sliced and the one-launch tile loop may decide a row's branch, qcfail or
#: uncertain flag apart (against_one_launch)
EDGE_ULPS = 4


def against_one_launch(dec, obs_code, obs_qual, qcfail_in, short, tpq_constants, eps) -> dict:
    """The sliced tile loop (stages A, B and C over sliced_plan) against
    the one-launch classify instance on the same batch of a panel of one
    tile, each plan forced through _classify_launches' `plan`. Returns
    {plan; unequal: rows on which argmax, decoded and distance differ,
    each 0 when the merge keeps the one-pass maxima, index, runner-up and
    sigma of the best exactly; relative: the largest relative gap of the
    confidences, and tolerance, 2*gamma(B+2) + 8u (only the posterior's
    total is summed in another tree, per slice then over the slices; the
    bound's gamma_b term bounds any tree of the B terms, 8u the noise term
    and the division); moved: rows of unequal confidence; differs: rows on
    which branch, qcfail or uncertain differ; unexplained: those of them on
    which neither the threshold ct nor an edge of its uncertain margin
    lies between the two confidences, widened by EDGE_ULPS ulps (0
    expected); at_edge: rows of moved confidence that sit there}."""
    n, w = obs_code.shape
    plan = sliced_plan(n, dec.barcode_count, w, obs_code.device)
    args = (dec, obs_code, obs_qual, qcfail_in, short, tpq_constants, True, eps, None)
    sliced = _classify_launches(*args, plan=plan)
    one = _classify_launches(*args, plan=replace(plan, slices=1))
    unequal = {key: int((sliced[key] != one[key]).sum()) for key in ("argmax", "decoded", "distance")}
    a, b = sliced["confidence"].double(), one["confidence"].double()
    relative = (a - b).abs() / torch.maximum(a.abs(), b.abs()).clamp(min=1e-300)
    differs = torch.zeros(n, dtype=torch.bool, device=obs_code.device)
    for key in ("branch", "qcfail", "uncertain"):
        differs |= sliced[key] != one[key]
    ct = dec.confidence_threshold
    rel_eps, _ = _uncertain_margins(dec, w, eps, obs_qual.sum(dim=1).to(torch.float32))
    rel_eps = rel_eps.double()
    edges = torch.stack([torch.full_like(a, ct), ct - (rel_eps * ct + 4.0 * U32), (ct + 4.0 * U32) / (1.0 - rel_eps)])
    ulps = EDGE_ULPS * U32 * max(ct, 1e-30)
    at_edge = ((edges >= torch.minimum(a, b) - ulps) & (edges <= torch.maximum(a, b) + ulps)).any(dim=0)
    return {
        "plan": plan, "unequal": unequal, "relative": float(relative.max()),
        "tolerance": 2.0 * gamma(dec.barcode_count + 2) + 8.0 * U32, "moved": int((a != b).sum()),
        "differs": int(differs.sum()), "unexplained": int((differs & ~at_edge).sum()),
        "at_edge": int((at_edge & (a != b)).sum()),
    }


def sigma_tile_order(obs_code: torch.Tensor, obs_qual: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """sigma (N, B) f32 of the reads against panel rows `codes` (B, W), added
    in the tile loop's order (csrc/pamld.cu): the read keeps its A/C/G/T
    codes with q > 0 (o'), fm = tpq - q and fs = q - U there, and C = (fs
    summed in position order) + qpos*U; an all-A/C/G/T barcode's sigma is
    M + C, M the matching fm in position order; any other barcode's the
    interleaved sum (per position the match, then its strictness term)
    plus qpos*U. A skipped term is +0.0, which leaves an f32 sum as it is,
    so this is the kernel's sigma bit for bit."""
    strict_codes = torch.tensor(STRICT_CODES, device=obs_code.device)
    code = obs_code.to(torch.int32)
    qual = obs_qual.to(torch.int32)
    codes = codes.to(torch.int32)
    kept = torch.isin(code, strict_codes) & (qual > 0)
    o = torch.where(kept, code, 0)
    q = qual.to(torch.float32)
    fm = torch.where(kept, analytic_tpq(qual) - q, 0.0)
    fs = torch.where(kept, q - UNIFORM_BASE_QUALITY, 0.0)
    fs_sum = torch.zeros(code.shape[0], device=code.device)
    for w in range(code.shape[1]):
        fs_sum = fs_sum + fs[:, w]
    qpos_u = (qual > 0).sum(dim=1).to(torch.float32) * UNIFORM_BASE_QUALITY
    strict_e = torch.isin(codes, strict_codes)
    all_strict = bool(strict_e.all())
    match = torch.zeros((code.shape[0], codes.shape[0]), device=code.device)
    mixed = None if all_strict else torch.zeros_like(match)
    for w in range(code.shape[1]):
        term = torch.where(codes[None, :, w] == o[:, None, w], fm[:, None, w], 0.0)
        match += term
        if mixed is not None:
            mixed += term
            mixed += torch.where(strict_e[None, :, w] & (o[:, None, w] != 0), fs[:, None, w], 0.0)
    match += (fs_sum + qpos_u)[:, None]
    if mixed is None:
        return match
    return torch.where(strict_e.all(dim=1)[None, :], match, mixed + qpos_u[:, None])


def pamld_classify_tile_order(dec, obs_code, obs_qual, qcfail_in, *, want_uncertain=False, eps=0.0, short=None,
                              chunk: int = 2048) -> dict:
    """The tile loop's own arithmetic on any device: sigma_tile_order in
    chunks of `chunk` barcodes, the row minimum, then the posterior in its
    frame (the first maximum, the runner-up) and finish_plain. It differs
    from the kernel only in the order the posterior's sum is added; the
    reference formulation (pamld_classify_plain, a contraction F.G) adds
    sigma in another order, which can move a low confidence by ~1e-5 of
    itself."""
    n = obs_code.shape[0]
    device = obs_code.device

    def chunks():
        for start in range(0, dec.barcode_count, chunk):
            yield start, sigma_tile_order(obs_code, obs_qual, dec.panel_codes_u8[start : start + chunk])

    shift = torch.full((n,), BIG_SIGMA, dtype=torch.float32, device=device)
    for _, sigma in chunks():
        shift = torch.minimum(shift, sigma.min(dim=1).values)
    total = torch.zeros(n, dtype=torch.float32, device=device)
    best_p = torch.full((n,), -1.0, dtype=torch.float32, device=device)
    second_p = torch.zeros(n, dtype=torch.float32, device=device)
    sigma_best = torch.zeros(n, dtype=torch.float32, device=device)
    best0 = torch.zeros(n, dtype=torch.int64, device=device)
    for start, sigma in chunks():
        p = torch.exp(LN_PHRED_BASE * (sigma - shift[:, None])) * dec.concentration[None, start : start + sigma.shape[1]]
        total = total + p.sum(dim=1)
        chunk_best = torch.argmax(p, dim=1)  # first maximum wins
        chunk_best_p = torch.gather(p, 1, chunk_best[:, None])[:, 0]
        better = chunk_best_p > best_p
        second_p = torch.where(
            better, torch.maximum(best_p, _second_max(p, chunk_best)), torch.maximum(second_p, chunk_best_p)
        )
        best_p = torch.where(better, chunk_best_p, best_p)
        best0 = torch.where(better, start + chunk_best, best0)
        sigma_best = torch.where(better, torch.gather(sigma, 1, chunk_best[:, None])[:, 0], sigma_best)
    sigma_p = total + _noise_shifted(dec.noise * dec.random_barcode_probability, shift)
    return finish_plain(dec, obs_code.to(torch.int32), obs_qual.to(torch.int32), qcfail_in,
                        (best0, best_p, sigma_p, sigma_best, second_p), want_uncertain=want_uncertain, eps=eps,
                        short=short)


def tie_gaps(dec, obs_code, obs_qual, first, second):
    """The float64 witness of a near tie between two barcodes of each read,
    `first` and `second` (0-based panel indices): |ln p_first - ln
    p_second| from the f64 sums of the same f32 terms (the exact sigma the
    hybrid bound is measured from; the read's qpos*U cancels), and the
    window lambda * 2 d_sigma(read) inside which two f32 sums of those
    terms, each within d_sigma of exact in any order (sigma_bound without
    the TPQ epsilon: the terms are the same), may rank the two either way.
    A gap of 0 is a tie in exact arithmetic. Returns (gap, window), float64
    (N,)."""
    features = observation_features_plain(obs_code, obs_qual).to(torch.float64)
    first, second = first.to(torch.int64), second.to(torch.int64)
    sigma = [
        (features * dec.likelihood_matrix[:, index].T.to(torch.float64)).sum(dim=1)
        for index in (first, second)
    ]
    log_c = torch.log(dec.concentration.to(torch.float64))
    gap = (LN_PHRED_BASE * (sigma[0] - sigma[1]) + log_c[first] - log_c[second]).abs()
    lam = abs(LN_PHRED_BASE)
    window = 2.0 * lam * sigma_bound(obs_code.shape[1], 0.0, obs_qual.to(torch.float64).sum(dim=1))
    return gap, window


def pamld_classify_plain(
    dec, obs_code, obs_qual, qcfail_in, *, want_uncertain=False, eps=0.0, short=None
) -> dict:
    obs_code = obs_code.to(torch.int32)
    obs_qual = obs_qual.to(torch.int32)
    q_positive = (obs_qual > 0).to(torch.float32).sum(dim=1)
    posterior = posterior_chunked_plain if dec.barcode_count > LARGE_PANEL_B else posterior_plain
    return finish_plain(dec, obs_code, obs_qual, qcfail_in, posterior(
        observation_features_plain(obs_code, obs_qual),
        q_positive * UNIFORM_BASE_QUALITY,
        dec.likelihood_matrix,
        dec.concentration,
        dec.noise * dec.random_barcode_probability,
    ), want_uncertain=want_uncertain, eps=eps, short=short)


def finish_plain(dec, obs_code, obs_qual, qcfail_in, posterior, *, want_uncertain=False, eps=0.0,
                 short=None) -> dict:
    """Everything after the posterior (classify.py:506-663): decisions,
    K2's distance to the decoded barcode (a row of ``dec.panel_codes``),
    branches, qcfail and the uncertain mask. ``obs_code``/``obs_qual``
    int32."""
    w = obs_code.shape[1]
    best0, best_p, sigma_p, sigma_decoded, second_p = posterior

    decoded_any = sigma_decoded < F64_UNDERFLOW_SIGMA
    best_index = torch.where(decoded_any, best0 + 1, 0).to(torch.int32)
    confidence = best_p / sigma_p

    expected = dec.panel_codes[best0]
    mismatch = expected != obs_code
    distance = torch.where(decoded_any, mismatch.sum(dim=1, dtype=torch.int32), 0)
    hq_distance = torch.where(
        decoded_any,
        (mismatch & (obs_qual >= dec.high_quality_threshold)).sum(dim=1, dtype=torch.int32),
        0,
    )

    if dec.random_barcode_probability > 0.0:
        threshold = noise_sigma_threshold(dec)
        passed_noise = decoded_any & (sigma_decoded < threshold)
    else:
        passed_noise = decoded_any
    passed_confidence = confidence > dec.confidence_threshold
    branch = torch.where(
        passed_noise,
        torch.where(passed_confidence, BRANCH_PASS, BRANCH_LOW_CONFIDENCE),
        BRANCH_NOISE,
    ).to(torch.int8)
    qcfail = qcfail_in | ~passed_noise | (passed_noise & ~passed_confidence)
    if dec.high_quality_distance_threshold > 0:
        qcfail = qcfail | (
            passed_noise
            & passed_confidence
            & (hq_distance >= dec.high_quality_distance_threshold)
        )
    result = {
        "decoded": torch.where(passed_noise, best_index, 0).to(torch.int32),
        "confidence": torch.where(passed_noise, confidence, 0.0),
        "distance": torch.where(passed_noise, distance, 0).to(torch.int32),
        "qcfail": qcfail,
        "branch": branch,
        "argmax": best_index,
    }
    if want_uncertain:
        rel_eps, sigma_eps = _uncertain_margins(
            dec, w, eps, obs_qual.sum(dim=1).to(torch.float32)
        )
        uncertain = second_p > best_p * (1.0 - rel_eps)
        if dec.confidence_threshold > 0.0:
            uncertain = uncertain | (
                torch.abs(confidence - dec.confidence_threshold)
                < rel_eps * torch.clamp(confidence, min=dec.confidence_threshold)
                + 4.0 * U32
            )
        if dec.random_barcode_probability > 0.0:
            uncertain = uncertain | (torch.abs(sigma_decoded - threshold) < sigma_eps)
        uncertain = uncertain | (torch.abs(sigma_decoded - F64_UNDERFLOW_SIGMA) < 1.0)
        if short is not None:
            uncertain = uncertain | short
        result["uncertain"] = uncertain
    return result


def _scalars(dec, w: int, eps: float, want_uncertain: bool, ld: int, short_stride: int, n: int):
    """The int and f32 parameters of K1 (csrc/pamld.cu), each
    float rounded to f32 exactly as the reference's weakly typed python
    constants are."""
    adjusted_noise = dec.noise * dec.random_barcode_probability
    rbp = dec.random_barcode_probability
    ints = np.array(
        [
            n, dec.barcode_count, w, ld, short_stride,
            int(adjusted_noise > 0.0), int(rbp > 0.0),
            int(dec.confidence_threshold > 0.0),
            dec.high_quality_threshold, dec.high_quality_distance_threshold,
            int(want_uncertain),
        ],
        dtype=np.int32,
    )
    lam = float(abs(LN_PHRED_BASE))
    floats = np.array(
        [
            _f32(UNIFORM_BASE_QUALITY),
            _f32(LN_PHRED_BASE),
            _f32(np.log(adjusted_noise)) if adjusted_noise > 0.0 else 0.0,
            _f32(noise_sigma_threshold(dec)) if rbp > 0.0 else 0.0,
            _f32(dec.confidence_threshold),
            _f32(gamma(2 * w + 2)),
            _f32(TERM_BOUND * w),
            _f32(eps * w),
            _f32(4.0 * lam),
            _f32(2.0 * gamma(dec.barcode_count + 2)),
            _f32(chunk_gamma(dec.barcode_count)),
            _f32(8.0 * U32),
            _f32(HYBRID_SAFETY),
            _f32(1e-4),
            _f32(4.0 * U32),
        ],
        dtype=np.float32,
    )
    return ints, floats


def empty_result(n: int, device) -> dict:
    return {
        "decoded": torch.empty(n, dtype=torch.int32, device=device),
        "argmax": torch.empty(n, dtype=torch.int32, device=device),
        "distance": torch.empty(n, dtype=torch.int32, device=device),
        "branch": torch.empty(n, dtype=torch.int8, device=device),
        "confidence": torch.empty(n, dtype=torch.float32, device=device),
        "qcfail": torch.empty(n, dtype=torch.bool, device=device),
        "uncertain": torch.zeros(n, dtype=torch.bool, device=device),
    }


def _outputs(out) -> tuple:
    return tuple(out[key].data_ptr() for key in (
        "decoded", "argmax", "distance", "branch", "confidence", "qcfail", "uncertain"))


class _TileLoopLaunch:
    """The launches of the tile loop for one batch of one decoder: its
    scalars, the observation and the caller's stream."""

    def __init__(self, dec, obs_code, obs_qual, qcfail_in, short, tpq_constants, want_uncertain, eps):
        from .build import library

        self.lib = library()
        self.obs = (obs_code.data_ptr(), obs_qual.data_ptr())
        self.qcfail = qcfail_in.data_ptr() if qcfail_in is not None else None
        self.short = short.data_ptr() if short is not None else None
        self.tpq = tpq_constants.data_ptr()
        n, w = obs_code.shape
        self.ints, self.floats = _scalars(
            dec, w, eps, want_uncertain, obs_code.stride(0), short.stride(0) if short is not None else 0, n,
        )
        self.stream = torch.cuda.current_stream(obs_code.device).cuda_stream
        #: the looped instance's read state (W > LOOPED_PAST), written by
        #: one launch here: ceil(W/16) 16-byte vectors of strict codes and
        #: as many of quality bytes a read, then C and qpos*U
        self.state, self.state_ptr, self.state_launches = None, None, 0
        if w > LOOPED_PAST and n > 0:
            from .build import check

            vectors = -(-w // 16)
            self.state = torch.empty((8 * vectors + 2) * n, dtype=torch.int32, device=obs_code.device)
            self.state_ptr, self.state_launches = self.state.data_ptr(), 1
            check(self.lib.phq_pamld_state(
                self.ints.ctypes.data, self.floats.ctypes.data, *self.obs, self.state_ptr, self.stream,
            ), "pamld_state")

    def classify(self, codes_u8, concentration, out):
        """The tile loop over a panel of one slice: both passes, one launch."""
        from .build import check

        check(self.lib.phq_pamld(
            self.ints.ctypes.data, self.floats.ctypes.data, *self.obs, self.qcfail, self.short,
            codes_u8.data_ptr(), concentration.data_ptr(), self.tpq, self.state_ptr, *_outputs(out), self.stream,
        ), "pamld_classify")

    def stage(self, mode, columns, codes_u8, concentration, plan, shift, partials=None, base=0):
        """Stage A (MODE_SLICE_MIN: each slice's row minimum into `shift`,
        (slices, N)) or B (MODE_SLICE_POSTERIOR: the partials of each slice
        into `partials`, (slices, 5, N), in the frame of the minimum over
        the rows of `shift`) over `columns` columns of `codes_u8`, in the
        slices of `plan`."""
        from .build import check

        ints = self.ints.copy()
        ints[1] = columns
        check(self.lib.phq_pamld_slices(
            ints.ctypes.data, self.floats.ctypes.data, mode, base, plan.slices, plan.cut,
            shift.shape[0] if shift.dim() == 2 else 1, *self.obs, codes_u8.data_ptr(),
            concentration.data_ptr(), self.tpq, self.state_ptr, shift.data_ptr(),
            partials.data_ptr() if partials is not None else None, self.stream,
        ), "pamld_slices")

    def merge(self, partials, shift=None, panel=None, out=None, merged=None):
        """Stage C: the (S, 5, N) `partials` merged in slice order, then with
        `out` the decisions (in the frame of the minimum over the rows of
        `shift`; K2's row from the whole `panel`), else the merged (5, N)
        rows into `merged`."""
        from .build import check

        finish = out is not None
        check(self.lib.phq_pamld_merge(
            self.ints.ctypes.data, self.floats.ctypes.data, partials.shape[0],
            (shift.shape[0] if shift.dim() == 2 else 1) if finish else 0, int(finish), *self.obs,
            self.qcfail if finish else None, self.short if finish else None,
            panel.data_ptr() if finish else None, shift.data_ptr() if finish else None,
            partials.data_ptr(), merged.data_ptr() if merged is not None else None,
            *(_outputs(out) if finish else (None,) * 7), self.stream,
        ), "pamld_merge")


def pamld_classify(
    dec, obs_code, obs_qual, qcfail_in, *, tpq_constants, want_uncertain=False,
    eps=0.0, short=None, out=None,
) -> dict:
    """K1 (+K2) for one PAMLD decoder, of any panel size (launches past
    LARGE_PANEL_B barcodes count as K7's). Returns a dict of (N,) tensors: decoded,
    argmax, distance (int32), branch (int8), confidence (f32), qcfail and,
    with ``want_uncertain``, uncertain (bool). ``short`` (N,) bool folds the
    short-observation rule into uncertain. ``out`` receives the results in
    place on CUDA (the decode step's stacked rows)."""
    if obs_code.device.type == "cpu":
        result = pamld_classify_plain(
            dec, obs_code, obs_qual, qcfail_in,
            want_uncertain=want_uncertain, eps=eps, short=short,
        )
        if out is not None:
            for key, value in result.items():
                out[key].copy_(value)
            return out
        return result
    if obs_code.device.type != "cuda":
        raise ValueError(f"pamld_classify: unsupported device {obs_code.device}")
    _check_observation("pamld_classify", obs_code, obs_qual, qcfail_in, short)
    out = _classify_launches(dec, obs_code, obs_qual, qcfail_in, short, tpq_constants, want_uncertain, eps, out)
    if not want_uncertain:
        out = {k: v for k, v in out.items() if k != "uncertain"}
    return out


def _classify_launches(dec, obs_code, obs_qual, qcfail_in, short, tpq_constants, want_uncertain, eps, out,
                       plan=None):
    """The tile loop's launches of one pamld_classify call, counted: one
    launch over a panel of one slice, else stages A, B and C (the looped
    instance's read state one more, before them). `plan`, in
    place of the card's (plan_for), lets chip_smoke hold the sliced launches
    to the one-launch instance on the same batch and time other cuts."""
    global launches, chunked_launches
    n, w = obs_code.shape
    if out is None:
        out = empty_result(n, obs_code.device)
    run = _TileLoopLaunch(dec, obs_code, obs_qual, qcfail_in, short, tpq_constants, want_uncertain, eps)
    if plan is None:
        plan = plan_for(n, dec.barcode_count, w, obs_code.device)
    if plan.slices == 1:
        run.classify(dec.panel_codes_u8, dec.concentration, out)
        count = 1
    else:
        shift = torch.empty((plan.slices, n), dtype=torch.float32, device=obs_code.device)
        partials = torch.empty((plan.slices, len(PARTIAL_ROWS), n), dtype=torch.int32, device=obs_code.device)
        run.stage(MODE_SLICE_MIN, dec.barcode_count, dec.panel_codes_u8, dec.concentration, plan, shift)
        run.stage(MODE_SLICE_POSTERIOR, dec.barcode_count, dec.panel_codes_u8, dec.concentration,
                  plan, shift, partials)
        run.merge(partials, shift, dec.panel_codes_u8, out)
        count = 3
    count += run.state_launches
    if dec.barcode_count > LARGE_PANEL_B:
        chunked_launches += count
    else:
        launches += count
    return out


#: the sliced launch modes of the tile loop (csrc/pamld.cu)
MODE_SLICE_MIN = 1
MODE_SLICE_POSTERIOR = 2


def _check_observation(name, obs_code, obs_qual, qcfail_in, short):
    n = obs_code.shape[0]
    for label, t in (("obs_code", obs_code), ("obs_qual", obs_qual)):
        if t.dtype != torch.uint8 or t.stride(1) != 1 or t.stride(0) != obs_code.stride(0):
            raise ValueError(f"{name}: {label} must be uint8 rows of unit column stride")
    for label, t in (("qcfail_in", qcfail_in), ("short", short)):
        if t is not None and (t.dtype != torch.bool or t.shape[0] != n or t.device != obs_code.device):
            raise ValueError(f"{name}: {label} must be (N,) bool on the device")
    if qcfail_in is not None and not qcfail_in.is_contiguous():
        raise ValueError(f"{name}: qcfail_in must be contiguous")


def pamld_classify_sharded(
    dec, shards, obs_code, obs_qual, qcfail_in, *, tpq_constants, want_uncertain=False,
    eps=0.0, short=None, out=None, group=None, finish=True, plain=False,
):
    """K8: ``pamld_classify`` with the panel of `dec` split into shards,
    `shards` the ones this process holds (device/tp.py PanelShard): with a
    process `group` its own shard, the merges collectives over the group's
    ranks; without, every shard, merged in process. Per shard stage A (the
    row minimum of each of its slices, slice_plan) and, after the merge of
    the minima, stage B (each slice's partials in the merged frame) and the
    merge of its slices in slice order; then the merge of the shards'
    partials and, with `finish`, stage C: the decisions of
    ``pamld_classify`` from the merged posterior, with K2's row read from
    the whole ``dec.panel_codes``. Without `finish` it returns the merged
    (shift, posterior by PARTIAL_ROWS): a follower rank takes part in the
    merges and decides nothing (``qcfail_in`` may be None). On CPU tensors,
    or with `plain` on any device, it runs the plain version
    (panel_merged_plain and finish_plain)."""
    adjusted_noise = dec.noise * dec.random_barcode_probability
    if plain or obs_code.device.type == "cpu":
        codes = obs_code.to(torch.int32)
        quals = obs_qual.to(torch.int32)
        q_positive = (quals > 0).to(torch.float32).sum(dim=1)
        features = observation_features_plain(codes, quals)
        if not finish:
            return panel_merged_plain(features, q_positive * UNIFORM_BASE_QUALITY, shards, group)
        posterior = posterior_panel_sharded_plain(
            features, q_positive * UNIFORM_BASE_QUALITY, shards, adjusted_noise, group,
        )
        result = finish_plain(dec, codes, quals, qcfail_in, posterior,
                              want_uncertain=want_uncertain, eps=eps, short=short)
        if out is not None:
            for key, value in result.items():
                out[key].copy_(value)
            return out
        return result
    if obs_code.device.type != "cuda":
        raise ValueError(f"pamld_classify_sharded: unsupported device {obs_code.device}")
    _check_observation("pamld_classify_sharded", obs_code, obs_qual, qcfail_in if finish else None, short)
    for shard in shards:
        if not (shard.codes_u8.is_contiguous() and shard.concentration.is_contiguous()):
            raise ValueError("pamld_classify_sharded: shard codes and concentrations must be contiguous")
    out = _sharded_launches(dec, shards, obs_code, obs_qual, qcfail_in, short, tpq_constants, want_uncertain,
                            eps, out, group, finish)
    if finish and not want_uncertain:
        out = {k: v for k, v in out.items() if k != "uncertain"}
    return out


def _sharded_launches(dec, shards, obs_code, obs_qual, qcfail_in, short, tpq_constants, want_uncertain, eps,
                      out, group, finish):
    """K8's launches and merges of one pamld_classify_sharded call,
    counted."""
    global panel_sharded_launches
    from ..device.tp import merge_panel_partials, merge_panel_shift

    n, w = obs_code.shape
    device = obs_code.device
    run = _TileLoopLaunch(dec, obs_code, obs_qual, qcfail_in, short, tpq_constants, want_uncertain, eps)
    panel_sharded_launches += run.state_launches
    plans = [plan_for(n, shard.count, w, device) for shard in shards]
    minima = []
    for shard, plan in zip(shards, plans):
        minima.append(torch.empty((plan.slices, n), dtype=torch.float32, device=device))
        run.stage(MODE_SLICE_MIN, shard.count, shard.codes_u8, shard.concentration, plan, minima[-1],
                  base=shard.base)
        panel_sharded_launches += 1
    shift = merge_panel_shift(torch.cat(minima), group)
    partials = torch.empty((len(shards), len(PARTIAL_ROWS), n), dtype=torch.int32, device=device)
    for k, (shard, plan) in enumerate(zip(shards, plans)):
        if plan.slices == 1:
            run.stage(MODE_SLICE_POSTERIOR, shard.count, shard.codes_u8, shard.concentration, plan, shift,
                      partials[k], base=shard.base)
            panel_sharded_launches += 1
            continue
        local = torch.empty((plan.slices, len(PARTIAL_ROWS), n), dtype=torch.int32, device=device)
        run.stage(MODE_SLICE_POSTERIOR, shard.count, shard.codes_u8, shard.concentration, plan, shift,
                  local, base=shard.base)
        run.merge(local, merged=partials[k])
        panel_sharded_launches += 2
    merged = merge_panel_partials(partials, group)
    if not finish:
        return shift, unpack_partials(merged)
    if out is None:
        out = empty_result(n, device)
    run.merge(merged[None], shift, dec.panel_codes_u8, out)
    panel_sharded_launches += 1
    return out


def observation_features(obs_code, obs_qual, tpq_constants) -> torch.Tensor:
    """The read-side feature tensor F (N, 5W) f32: the plain version for
    CPU tensors, K1's feature prologue written out (``phq_features``) for
    uint8 CUDA tensors of unit column stride."""
    if obs_code.device.type == "cpu":
        return observation_features_plain(obs_code, obs_qual)
    if obs_code.device.type != "cuda":
        raise ValueError(f"observation_features: unsupported device {obs_code.device}")
    global feature_launches
    from .build import check, library

    for name, t in (("obs_code", obs_code), ("obs_qual", obs_qual)):
        if t.dtype != torch.uint8 or t.stride(1) != 1 or t.stride(0) != obs_code.stride(0):
            raise ValueError(f"observation_features: {name} must be uint8 rows of unit column stride")
    n, w = obs_code.shape
    out = torch.empty((n, 5 * w), dtype=torch.float32, device=obs_code.device)
    stream = torch.cuda.current_stream(obs_code.device).cuda_stream
    status = library().phq_features(
        obs_code.data_ptr(), obs_qual.data_ptr(), n, w, obs_code.stride(0),
        _f32(UNIFORM_BASE_QUALITY), tpq_constants.data_ptr(), out.data_ptr(), stream,
    )
    check(status, "observation_features")
    feature_launches += 1
    return out


def tpq_device(q: torch.Tensor) -> torch.Tensor:
    """K1's own analytic TPQ on a CUDA int32 tensor (the epsilon probe)."""
    from ..device.instrument import tpq_constants
    from .build import check, library

    q = q.to(torch.int32).contiguous()
    consts = torch.from_numpy(tpq_constants()).to(q.device)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    check(library().phq_tpq_eval(q.data_ptr(), q.numel(), consts.data_ptr(), out.data_ptr(), stream), "tpq_eval")
    return out
