"""One reader per metric (``<metric name>.py``, ``read(rec) -> float | None``)
and the shared arithmetic they use (``_counts.py``)."""
