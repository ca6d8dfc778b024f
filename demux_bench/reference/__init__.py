"""The plain reference the benchmark holds the program to: PAMLD decoding
in float64 (or any dtype, for the control) with plain PyTorch and NumPy.

It imports nothing of the program; the panels and reads come from the
harness (``demux_bench/traffic.py``).
"""
