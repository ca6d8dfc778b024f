"""The share of the window in which no kernel, copy or memset ran on the
card, from the program's torch.profiler trace, in percent."""

from demux_bench.readers import idle_share


def read(run):
    return idle_share(run)
