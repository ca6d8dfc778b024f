"""K7, the PAMLD tile loop over the 737,280-barcode panel
(``kernels/pamld.py``, ``csrc/pamld.cu``): the share of its bound that its
kernels reach in the traced window, in percent. The sample decoder's K1
launches share the kernels' names; their operations are counted too (a
ten-thousandth of K7's)."""

from demux_bench.readers import pamld_roofline


def read(run):
    return pamld_roofline(run)
