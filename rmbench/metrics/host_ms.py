"""host_ms.<part>: the host's share of a traced iteration (``frame``,
``rebuild_frame`` or ``step``: the cell's kind), ms: the benchmark's own
host clock from the call into `Renderer.render` to its return, or around
a fit step's loss, `backward()` and `Adam.step()`, before the
synchronise (the host plan, the checks and every launch), the mean over
the traced iterations."""


def read(run):
    if not run.host_s:
        return None
    return sum(run.host_s) / len(run.host_s) * 1e3
