"""Compile a decoded instruction into device-ready torch tensors.

Port of ``pheniqs_tpu.device.instrument``: the same ``DecoderSpec``
objects the strict engine uses become per-decoder token plans, barcode
panel tensors and scalar thresholds, placed on an explicit ``device``.

The PAMLD likelihood keeps the reference package's decomposition
``sigma_q[r, b] = F[r] . G[b] + UNIFORM * count(q_r > 0)`` (see the
original module docstring). The CUDA kernel (kernels/pamld.py) evaluates
the same sum per read straight from the uint8 panel codes; the plain
version contracts F with G. Distances to the decoded barcode use an exact
row lookup in both, so the TPU-only match4/match16 matrices are not built.
Every panel, of any size, gets the same tensors: K1 reads the uint8
codes and the concentrations, the plain posteriors G; an MDD decoder
reads the codes (K6 the uint8 copy) with its segment widths, distance
tolerance and quality masking threshold.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..decode.spec import DecoderSpec, spec_from_ontology
from ..errors import ConfigurationError
from ..kernels.mdd import key_table_tensor
from ..phred import TRUE_POSITIVE_QUALITY, UNIFORM_BASE_QUALITY

#: BAM 4-bit codes of the concrete nucleotides A/C/G/T
STRICT_CODES = (1, 2, 4, 8)

#: natural-log factor: 10^(-0.1 * sigma) == exp(LN_PHRED_BASE * sigma)
LN_PHRED_BASE = float(-0.1 * np.log(10.0))

#: largest panel of the reference's monolithic posterior; larger panels
#: take its chunked online posterior (K7) and the bound's rescale term
LARGE_PANEL_B = 1024

_TPQ_DOMAIN = 0x80  # 7-bit phred (reference phred.cpp:39-72)


def resolve_device(device) -> torch.device:
    """The explicit device of an engine or instrument. ``cuda`` with no
    GPU present raises: there is no silent CPU fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA GPU is available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def tpq_constants() -> np.ndarray:
    """The f32 constants of `analytic_tpq`, in the order the CUDA kernel
    reads them: 10^(-2^k/10) for k < 7, 1/n for n = 1..8, 10/ln(10), then
    the exact table values for q = 1..7 (24 floats, last one padding)."""
    consts = np.zeros(24, dtype=np.float32)
    for k in range(7):
        consts[k] = np.float32(10.0 ** (-(1 << k) / 10.0))
    for n in range(1, 9):
        consts[7 + n - 1] = np.float32(1.0 / n)
    consts[15] = np.float32(10.0 / np.log(10.0))
    for q in range(1, 8):
        consts[16 + q - 1] = np.float32(TRUE_POSITIVE_QUALITY[q])
    return consts


def analytic_tpq(q: torch.Tensor) -> torch.Tensor:
    """f32 true-positive quality -10*log10(1 - 10^(-q/10)) without
    transcendentals, operation for operation the reference package's
    ``analytic_tpq``: 10^(-q/10) as a product of exact f32 constants over
    q's bits, an 8-term Horner series for -log1p(-x), and exact per-q
    constants for q in 1..7. q == 0 is clamped to 1 (callers gate those
    positions to zero contribution)."""
    c = torch.from_numpy(tpq_constants()).to(q.device)
    q = torch.clamp(q.to(torch.int32), min=1)
    one = torch.ones((), dtype=torch.float32, device=q.device)
    x = torch.ones(q.shape, dtype=torch.float32, device=q.device)
    for k in range(7):
        x = x * torch.where(((q >> k) & 1) == 1, c[k], one)
    series = c[7 + 7].expand(q.shape)
    for n in range(7, 0, -1):
        series = c[7 + n - 1] + x * series
    tpq = c[15] * (x * series)
    for qq in range(1, 8):
        tpq = torch.where(q == qq, c[16 + qq - 1], tpq)
    return tpq


_TPQ_EPSILON: dict[str, float] = {}


def analytic_tpq_epsilon(device) -> float:
    """Exhaustively measured |analytic_f32(q) - tpq_f64(q)| over the whole
    quality domain q in 1..127, doubled, plus 1e-7 — on the port's own
    backend: the CUDA kernel's ``__device__`` TPQ function on a GPU, the
    torch version on the CPU. The hybrid bound adds ``W * eps``."""
    device = resolve_device(device)
    key = device.type
    if key not in _TPQ_EPSILON:
        q = torch.arange(1, _TPQ_DOMAIN, dtype=torch.int32, device=device)
        if device.type == "cuda":
            from ..kernels.pamld import tpq_device

            measured = tpq_device(q)
        else:
            measured = analytic_tpq(q)
        measured = measured.cpu().numpy().astype(np.float64)
        exact = TRUE_POSITIVE_QUALITY[1:_TPQ_DOMAIN]
        _TPQ_EPSILON[key] = 2.0 * float(np.max(np.abs(measured - exact))) + 1e-7
    return _TPQ_EPSILON[key]


@dataclass(frozen=True)
class TokenPlan:
    """One fixed-width token gather (reference transform.h:34-88)."""

    input_segment_index: int
    start: int
    end: int
    end_terminated: bool
    reverse_complement: bool
    output_segment_index: int
    width: int


@dataclass
class DeviceDecoder:
    """Static decoder config + panel tensors on the instrument's device."""

    algorithm: str  # pamld | mdd | naive | passthrough
    classifier_type: str  # sample | cellular | molecular
    index: int
    multiplexing: bool
    plans: list[TokenPlan]
    segment_widths: list[int]  # observation segment widths (concat order)
    barcode_count: int = 0
    width: int = 0
    panel_codes: torch.Tensor | None = None  # (B, W) int32
    panel_codes_u8: torch.Tensor | None = None  # (B, W) uint8, the kernel's copy
    key_table: torch.Tensor | None = None  # MDD: K6's exact-match lookup (kernels/mdd.py:key_table)
    likelihood_matrix: torch.Tensor | None = None  # (5W, B) f32 — G
    concentration: torch.Tensor | None = None  # (B,) f32
    noise: float = 0.0
    confidence_threshold: float = 0.0
    random_barcode_probability: float = 0.0
    high_quality_threshold: int = 30
    high_quality_distance_threshold: int = 0
    quality_masking_threshold: int = 0
    distance_tolerance: tuple[int, ...] = ()
    spec: DecoderSpec | None = None


@dataclass
class DeviceInstrument:
    """All decoders of one instruction in classify order, plus routing and
    the measured analytic-TPQ epsilon of ``device``."""

    decoders: list[DeviceDecoder]
    multiplexing_index: int
    input_segment_cardinality: int
    device: torch.device
    tpq_constants: torch.Tensor  # (24,) f32 on device (tpq_constants())
    used_segments: tuple[int, ...] = ()
    tpq_analytic_eps: float = 0.0
    #: K5's plans by want_uncertain (kernels/pack.py:pack_plan) and K4's
    #: with their device tables (kernels/counters.py:counter_plan), made on
    #: first use; dataclasses.replace starts a new instrument's afresh
    pack_plans: dict = field(default_factory=dict, init=False, repr=False, compare=False)
    counter_plans: dict = field(default_factory=dict, init=False, repr=False, compare=False)


def _plans_from_rule(spec: DecoderSpec) -> tuple[list[TokenPlan], list[int]]:
    plans: list[TokenPlan] = []
    widths = [0] * spec.rule.output_segment_cardinality
    for tx in spec.rule.transform_array:
        token = tx.token
        length = token.length()
        if length < 0:
            raise ConfigurationError(
                "device decoders require fixed-width tokens "
                f"(token {token} has dynamic width)"
            )
        plans.append(
            TokenPlan(
                input_segment_index=token.input_segment_index,
                start=token.start,
                end=token.end,
                end_terminated=token.end_terminated,
                reverse_complement=tx.reverse_complement,
                output_segment_index=tx.output_segment_index,
                width=length,
            )
        )
        widths[tx.output_segment_index] += length
    return plans, widths


def _panel_matrices(codes: np.ndarray, concentration: np.ndarray, device):
    """(panel_codes int32, panel_codes uint8, G (5W, B) f32, concentration)
    for one (B, W) panel of BAM codes."""
    codes = np.asarray(codes).astype(np.int64)
    b, w = codes.shape
    strict = np.isin(codes, STRICT_CODES).astype(np.float32)
    onehot4 = np.zeros((b, w, 4), dtype=np.float32)
    for c, code in enumerate(STRICT_CODES):
        onehot4[:, :, c] = (codes == code).astype(np.float32)
    g = np.concatenate([onehot4, strict[:, :, None]], axis=2).reshape(b, w * 5).T
    return (
        torch.from_numpy(codes.astype(np.int32)).to(device),
        torch.from_numpy(codes.astype(np.uint8)).to(device),
        torch.from_numpy(np.ascontiguousarray(g)).to(device),
        torch.from_numpy(np.array(concentration, dtype=np.float32)).to(device),
    )


def compile_decoder(spec: DecoderSpec, device) -> DeviceDecoder:
    plans: list[TokenPlan] = []
    widths: list[int] = []
    if spec.rule is not None and spec.algorithm != "passthrough":
        plans, widths = _plans_from_rule(spec)
    dec = DeviceDecoder(
        algorithm=spec.algorithm,
        classifier_type=spec.classifier_type,
        index=spec.index,
        multiplexing=spec.multiplexing,
        plans=plans,
        segment_widths=widths,
        noise=spec.noise,
        confidence_threshold=spec.confidence_threshold,
        random_barcode_probability=spec.random_barcode_probability,
        high_quality_threshold=spec.high_quality_threshold,
        high_quality_distance_threshold=spec.high_quality_distance_threshold,
        quality_masking_threshold=spec.quality_masking_threshold,
        distance_tolerance=tuple(spec.distance_tolerance),
        spec=spec,
    )
    if spec.panel is not None and spec.algorithm in ("pamld", "mdd"):
        dec.barcode_count = spec.panel.cardinality
        dec.width = spec.panel.width
        (
            dec.panel_codes,
            dec.panel_codes_u8,
            dec.likelihood_matrix,
            dec.concentration,
        ) = _panel_matrices(spec.panel.codes, spec.panel.concentration, device)
        if spec.algorithm == "mdd":
            dec.key_table = key_table_tensor(dec.panel_codes_u8)
    return dec


def _remap_segments(decoders: list[DeviceDecoder]) -> tuple[int, ...]:
    """Re-index token plans into the pruned list of input segments any
    decoder touches (only those ride the wire); returns that list."""
    used = sorted({plan.input_segment_index for dec in decoders for plan in dec.plans})
    remap = {segment: position for position, segment in enumerate(used)}
    for dec in decoders:
        dec.plans = [
            TokenPlan(
                input_segment_index=remap[plan.input_segment_index],
                start=plan.start,
                end=plan.end,
                end_terminated=plan.end_terminated,
                reverse_complement=plan.reverse_complement,
                output_segment_index=plan.output_segment_index,
                width=plan.width,
            )
            for plan in dec.plans
        ]
    return tuple(used)


def _multiplexing_index(decoders: list[DeviceDecoder]) -> int:
    for i, dec in enumerate(decoders):
        if dec.multiplexing:
            return i
    for i, dec in enumerate(decoders):
        if dec.classifier_type == "sample":
            return i
    return -1


def compile_instrument(ontology: dict, device) -> DeviceInstrument:
    """Build a DeviceInstrument on ``device`` from a compiled instruction
    ontology, in the reference classify order: sample, molecular*,
    cellular* (reference transcode.h:51-65)."""
    from ..config.compiler import topic_elements

    device = resolve_device(device)
    decoders: list[DeviceDecoder] = []
    sample = ontology.get("sample")
    if isinstance(sample, dict):
        decoders.append(compile_decoder(spec_from_ontology(sample, "sample"), device))
    for element in topic_elements(ontology.get("molecular")):
        decoders.append(
            compile_decoder(spec_from_ontology(element, "molecular"), device)
        )
    for element in topic_elements(ontology.get("cellular")):
        decoders.append(
            compile_decoder(spec_from_ontology(element, "cellular"), device)
        )
    return DeviceInstrument(
        decoders=decoders,
        multiplexing_index=_multiplexing_index(decoders),
        input_segment_cardinality=int(ontology.get("input segment cardinality", 1)),
        device=device,
        tpq_constants=torch.from_numpy(tpq_constants()).to(device),
        used_segments=_remap_segments(decoders),
        tpq_analytic_eps=analytic_tpq_epsilon(device),
    )


def carry_instrument(state, device) -> DeviceInstrument:
    """The port's instrument from the reference package's compiled
    ``DeviceInstrument`` ``state`` (its arrays read back as NumPy): the
    same panels, G, concentrations, plans and scalars, so both sides
    compute from identical state. The TPQ epsilon is measured anew on
    ``device``, never carried over."""
    device = resolve_device(device)
    decoders = []
    for source in state.decoders:
        dec = DeviceDecoder(
            algorithm=source.algorithm,
            classifier_type=source.classifier_type,
            index=source.index,
            multiplexing=source.multiplexing,
            plans=[TokenPlan(**vars(plan)) for plan in source.plans],
            segment_widths=list(source.segment_widths),
            barcode_count=source.barcode_count,
            width=source.width,
            noise=source.noise,
            confidence_threshold=source.confidence_threshold,
            random_barcode_probability=source.random_barcode_probability,
            high_quality_threshold=source.high_quality_threshold,
            high_quality_distance_threshold=source.high_quality_distance_threshold,
            quality_masking_threshold=source.quality_masking_threshold,
            distance_tolerance=tuple(source.distance_tolerance),
            spec=source.spec,
        )
        if source.panel_codes is not None:
            codes = np.asarray(source.panel_codes)
            (
                dec.panel_codes,
                dec.panel_codes_u8,
                _,
                dec.concentration,
            ) = _panel_matrices(codes, np.asarray(source.concentration), device)
            dec.likelihood_matrix = torch.from_numpy(
                np.array(source.likelihood_matrix, dtype=np.float32)
            ).to(device)
            if dec.algorithm == "mdd":
                dec.key_table = key_table_tensor(dec.panel_codes_u8)
        decoders.append(dec)
    return DeviceInstrument(
        decoders=decoders,
        multiplexing_index=state.multiplexing_index,
        input_segment_cardinality=state.input_segment_cardinality,
        device=device,
        tpq_constants=torch.from_numpy(tpq_constants()).to(device),
        used_segments=tuple(state.used_segments),
        tpq_analytic_eps=analytic_tpq_epsilon(device),
    )


def card_index(device: torch.device) -> int | None:
    """The card a CUDA device names (``cuda`` is the current one); None on
    the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.current_device() if device.index is None else device.index


def instruments_on(instrument: DeviceInstrument, devices) -> list[DeviceInstrument]:
    """One instrument per entry of `devices` (cards may repeat), for the
    reads axis: `instrument` itself on its own device, else one copy per
    card, shared by the entries naming that card, with every tensor there
    and the same panels, plans and scalars (the TPQ epsilon is measured
    per device type, so it carries over)."""
    tensors = ("panel_codes", "panel_codes_u8", "key_table", "likelihood_matrix", "concentration")
    home = (instrument.device.type, card_index(instrument.device))
    placed = {}
    out = []
    for device in devices:
        device = resolve_device(device)
        key = (device.type, card_index(device))
        if key not in placed:
            placed[key] = instrument if key == home else replace(
                instrument,
                decoders=[
                    replace(dec, **{name: getattr(dec, name).to(device) for name in tensors
                                    if getattr(dec, name) is not None})
                    for dec in instrument.decoders
                ],
                device=device,
                tpq_constants=instrument.tpq_constants.to(device),
            )
        out.append(placed[key])
    return out


__all__ = [
    "DeviceDecoder",
    "DeviceInstrument",
    "TokenPlan",
    "analytic_tpq",
    "analytic_tpq_epsilon",
    "carry_instrument",
    "compile_decoder",
    "compile_instrument",
    "instruments_on",
    "resolve_device",
    "LARGE_PANEL_B",
    "LN_PHRED_BASE",
    "STRICT_CODES",
    "UNIFORM_BASE_QUALITY",
]
