"""device.idle_share (%): 1 - the union of the device's operation intervals
over the profiled slice's wall time."""


def read(run):
    if run.slice is None or run.slice.wall_s <= 0:
        return None
    return 100.0 * (1.0 - run.slice.busy_s() / run.slice.wall_s)
