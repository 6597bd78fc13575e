"""Host milliseconds a train step: the benchmark's clock around step calls
after the window, each made on an idle device and timed to its return:
the host's dispatch of the step, including any wait for room in the
device's launch queue."""


def read(run):
    h = run.get("host", {})
    if not h.get("steps"):
        return None
    return 1e3 * h["seconds"] / h["steps"]
