"""idle_share: 1 - the union of the card's kernel, copy and fill intervals
over the traced window (``torch.profiler``; layer: device).  None without a
device trace."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
