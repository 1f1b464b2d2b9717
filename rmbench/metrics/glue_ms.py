"""glue_ms.<part>: the torch glue's device time per traced iteration
(``frame``, ``rebuild_frame`` or ``step``: the cell's kind), ms: the
device operations of the traced window that the profiler links to an
``aten::`` operator (torch's own kernels, copies and fills; the port's
kernels, launched through ctypes, are linked to none), over the traced
iterations (`tools/profile_frame.py`'s attribution)."""


def read(run):
    if run.trace is None or not run.iterations:
        return None
    return run.trace.aten_s() / run.iterations * 1e3
