"""One reader per metric, ``<metric name>.py`` with ``read(run)``: the
metric's value, or None where the run holds nothing to read it from."""
