"""mattes_per_s: every matte (one stream's frame) whose bytes reached the
host inside the window, over the window's seconds. The window runs from
its start to the first matte that reaches the host once ``--seconds``
have passed, so that it holds whole steps."""


def read(record: dict):
    return len(record["mattes"]) * record["streams"] / record["seconds"]
