"""Profiling plane of the port: the tuning registry of dispatch knobs."""
