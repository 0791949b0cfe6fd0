"""Utilities of the port: metrics, checkpoint loading, reference
checkpoint conversion, profiling."""
