"""The device's idle share of the profiled stretch: one less the union of
its kernels', copies' and sets' intervals over the stretch's time."""


def read(run):
    trace = run.get("trace")
    if not trace or not trace["kernels"] or trace["window_s"] <= 0:
        return None
    return 1.0 - trace["busy_s"] / trace["window_s"]
