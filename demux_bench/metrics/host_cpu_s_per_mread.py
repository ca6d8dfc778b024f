"""CPU seconds (user + system) of the program's whole process tree over
the window, per million records out in it (/proc at the window's ends)."""


def read(run):
    (start, _), (stop, _) = run.cpu
    return (stop - start) / run.window_records * 1e6
