"""Tools of the port, run with ``python3 -m``: the frame profiler and the
head-stage training entry point."""
