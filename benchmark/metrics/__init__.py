"""One module per per-layer metric, ``read(ctx)`` returning the metric's
value or None where the traced run holds nothing to read. Kernel names a
metric attributes to its layer are listed in ``<metric>.d/*.txt``, so a
later kernel adds a file there instead of editing one."""
