"""Realized clients over the slots whose gradients were computed, over
every round of the run, from the trainer's realized counts: the useful
share of the cohort's work."""


def read(run):
    realized, slate = run.get("realized"), run.get("slate")
    if not realized or not slate:
        return None
    return sum(realized) / (len(realized) * slate)
