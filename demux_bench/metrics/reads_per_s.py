"""SAM records out in the window over the window's seconds (host clock)."""


def read(run):
    return run.window_records / run.window_s
