"""Host-side (NumPy) molding and resampling of the port."""
