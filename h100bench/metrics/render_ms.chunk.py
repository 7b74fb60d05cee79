"""Device milliseconds a frame ending at the ``refresh`` (candidate set)
and ``render`` (splat and shade) marks, over the window's calls."""


def read(record):
    st = record["stage_ms"]
    if "render" not in st:
        return None
    return (st["render"] + st.get("refresh", 0.0)) / record["stage_frames"]
