"""exchange_ms.<part>: the device time of the collectives between the
ranks per traced iteration on rank 0, ms: the NCCL kernels (named
``nccl...``) in rank 0's traced window, read from the trace's device
operations by kernel name (they are linked to no ``aten::`` operator,
so the spans' launched device time does not see them), without the
harness's own end-of-iteration all-reduce, which the trace leaves out.
A collective's kernel runs while it waits for its peers: this counts
the waits spent spinning in a collective with the transfers. Nothing to
read on one card."""

PREFIX = "nccl"


def read(run):
    if run.trace is None or not run.iterations:
        return None
    ops = [op for op in run.trace.ops if op.kernel.startswith(PREFIX)]
    if not ops:
        return None
    return sum(op.dur for op in ops) / 1e3 / run.iterations
