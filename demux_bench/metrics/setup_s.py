"""Seconds from the program's launch to the window's opening: loading,
compiling the instruction, building the kernels where none are built, and
the warm-up batches (host clock)."""


def read(run):
    return run.setup_s
