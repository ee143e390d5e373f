"""One reader per per-layer metric, ``<metric>.py``, found by the metric's name."""
