"""Seconds from the process's start to the window's first call: imports,
CUDA context, kernel builds (a first run in a checkout), the inputs and
weights drawn on the card, and the warm-up calls."""


def read(record):
    return record["setup_s"]
