"""halo_exchanges: the exchanges of halo data per traced iteration on rank
0: the program's ``tbr.halo`` (the volume's halo planes) and
``tbr.light_halo`` (an X or Y face's light halo columns, once before
each chunk of slices but the first) spans. It shows the choice of the
chunk's slices. Nothing to read where no such span opened."""

NAMES = ("tbr.halo", "tbr.light_halo")


def read(run):
    if run.trace is None or not run.iterations:
        return None
    n = run.trace.spans.count(NAMES)
    if not n:
        return None
    return n / run.iterations
