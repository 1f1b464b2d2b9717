"""idle_share.<part>: the device's idle share of the traced iterations
(``frame``, ``rebuild_frame`` or ``step``: the cell's kind), %: 1 - busy
/ wall, busy the union of the kernel, memcpy and memset intervals of the
trace, wall the traced window on the host clock."""


def read(run):
    tr = run.trace
    if tr is None or tr.busy_s <= 0.0 or tr.window_s <= 0.0:
        return None
    return (1.0 - tr.busy_s / tr.window_s) * 100.0
