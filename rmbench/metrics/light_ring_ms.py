"""light_ring_ms: rank 0's host time per traced iteration in the sharded
rebuild's Z-face ring (the program's ``tbr.light_ring`` spans: the wait
for the light entering its chunk from the upstream ranks, and the
hand-off of its own carry downstream), ms: the Z face's serialisation
over the ranks as rank 0 meets it, waits included. Nothing to read where
no such span opened."""

NAMES = ("tbr.light_ring",)


def read(run):
    if run.trace is None or not run.iterations:
        return None
    spans = run.trace.spans
    if not spans.count(NAMES):
        return None
    return spans.host_s(NAMES) * 1e3 / run.iterations
