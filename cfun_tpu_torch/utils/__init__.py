"""Utilities of the port: metrics, checkpoints, reference checkpoint
conversion, profiling, training logs."""
