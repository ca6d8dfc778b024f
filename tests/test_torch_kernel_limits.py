"""The limits of the port's CUDA kernels, refused as a ConfigurationError
when an engine is built for a card, before its first batch, with a
message that names the limit and the decoder (kernels.kernel_limits); the
wrappers refuse the same configurations with the same type. The plain
versions, which the CPU runs, have none of these limits. One case per
limit, on stand-in instruments of DeviceDecoders."""

from types import SimpleNamespace

import pytest
import torch

from pheniqs_tpu_torch.device.flagship import flagship_ontology, mdd_flagship_ontology
from pheniqs_tpu_torch.device.instrument import DeviceDecoder, TokenPlan, compile_instrument
from pheniqs_tpu_torch.errors import ConfigurationError
from pheniqs_tpu_torch.kernels import MAX_DECODERS, check_kernel_limits, kernel_limits, pamld


def _decoder(algorithm, widths, plans_per_segment=1, classifier="sample"):
    """A decoder of `algorithm` reading one token per output segment of
    `widths` from input segment 0 (or `plans_per_segment` one-position
    tokens each)."""
    plans = []
    for s, width in enumerate(widths):
        if plans_per_segment == 1:
            plans.append(TokenPlan(0, 0, width, True, False, s, width))
        else:
            plans += [TokenPlan(0, k, k + 1, True, False, s, 1) for k in range(plans_per_segment)]
    if plans_per_segment != 1:
        widths = [plans_per_segment] * len(widths)
    return DeviceDecoder(algorithm, classifier, 1, True, plans, list(widths), barcode_count=8, width=sum(widths))


def _instrument(decoders):
    return SimpleNamespace(decoders=decoders, used_segments=(0,))


CASES = {
    "pamld width": ([_decoder("pamld", [65])], "observation width 65 exceeds the PAMLD kernels' 64"),
    "mdd segments": ([_decoder("mdd", [4] * 9)], "9 segments exceed the MDD kernel's 8"),
    "mdd width": ([_decoder("mdd", [40, 25])], "observation width 65 exceeds the MDD kernel's 64"),
    "decoders": ([_decoder("naive", [])] * (MAX_DECODERS + 1), "33 decoders exceed the counter and pack kernels' 32"),
    "program": ([_decoder("pamld", [30], plans_per_segment=30)] * 8, "beyond the unpack kernel's 2048"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_instrument_check_refuses_each_limit(name):
    decoders, message = CASES[name]
    instrument = _instrument(decoders)
    problems = kernel_limits(instrument)
    assert len(problems) == 1 and message in problems[0]
    if name not in ("decoders", "program"):
        assert problems[0].startswith(f"decoder 0 (sample {decoders[0].algorithm})")
    with pytest.raises(ConfigurationError, match=message):
        check_kernel_limits(instrument)


@pytest.mark.parametrize("ontology", [flagship_ontology, mdd_flagship_ontology])
def test_instrument_check_passes_the_flagships(ontology):
    assert kernel_limits(compile_instrument(ontology(), "cpu")) == []


def test_wrapper_refuses_with_the_same_type():
    """The wrapper's own check (run on CUDA tensors before a launch) raises
    the typed error, not NotImplementedError."""
    code = torch.zeros((4, 65), dtype=torch.uint8)
    with pytest.raises(ConfigurationError, match="exceeds the kernels' 64"):
        pamld._check_observation("pamld_classify", code, code, None, None)
