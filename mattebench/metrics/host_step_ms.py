"""host_step_ms: mean host-clock ms of the predictor's ``step`` calls,
each made after a synchronize onto an empty launch queue, after the
window (``harness.issue_steps``): the host's own cost of issuing a
step, which caching work on the host or capturing the step as a graph
would cut."""


def read(record: dict):
    steps = record.get("host_steps_ms")
    return sum(steps) / len(steps) if steps else None
