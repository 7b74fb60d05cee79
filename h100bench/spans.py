"""What the metrics of the port's own spans and counters share: the
newest profiler session that the port's recorder kept
(``slam_maskrcnn_tpu_torch.utils.profiling.last_session``), which is the
traced stretch's, since its calls are the run's last under a profiler.
A program without that recorder, or a run with no traced stretch, gives
None, and so does a metric with nothing to read."""

from __future__ import annotations


def session(record):
    """The traced stretch's session of spans, or None."""
    if not record.get("trace_frames"):
        return None
    try:
        from slam_maskrcnn_tpu_torch.utils import profiling
    except ImportError:
        return None
    last = getattr(profiling, "last_session", None)
    return last() if last is not None else None


def host_ms(record, names=(), prefix=None):
    """Host milliseconds a traced frame in the spans named ``names`` (or
    whose name starts with ``prefix``); None where there are none."""
    s = session(record)
    if s is None:
        return None
    ms = [(x.end_ns - x.start_ns) * 1e-6 for x in s.spans
          if x.end_ns is not None and (
              x.name in names
              or (prefix is not None and x.name.startswith(prefix)))]
    if not ms:
        return None
    return sum(ms) / record["trace_frames"]


def counted(record, prefix: str):
    """The session's counters whose name starts with ``prefix``, summed,
    a traced frame; None without a session."""
    s = session(record)
    if s is None:
        return None
    return sum(v for k, v in s.counters.items()
               if k.startswith(prefix)) / record["trace_frames"]
