"""Device milliseconds a frame from the ``label`` mark to the
``associate`` mark (the depth probe, Bayesian association and relabel),
over the window's calls."""


def read(record):
    ms = record["stage_ms"].get("associate")
    return None if ms is None else ms / record["stage_frames"]
