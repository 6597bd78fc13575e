"""Host milliseconds a round: the benchmark's clock around ``run_block``
calls after the window, each made on an idle device and timed to its
return, over their rounds: the host's own work a round (drawing the
block's cohorts, seeds and masks, copying them over, launching each
round's graph), with no wait behind rounds already queued."""


def read(run):
    h = run.get("host", {})
    if not h.get("rounds"):
        return None
    return 1e3 * h["seconds"] / h["rounds"]
