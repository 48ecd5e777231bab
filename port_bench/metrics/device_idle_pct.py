"""The traced stretch's share in which no device operation ran: 1 - (the
union of device intervals) / (the stretch's wall), in %."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_us"] / run.trace["window_us"])
