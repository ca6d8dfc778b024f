"""The whole decode step's share of the card's f32 peak in the traced
window, in percent: the window's useful PAMLD operations over the peak
times the seconds in which any kernel, copy or memset ran (the trace).
It bounds what any one kernel's roofline can claim: a kernel taken off
the path leaves its roofline silent, and this share still reads."""

from demux_bench.readers import step_mfu


def read(run):
    return step_mfu(run)
