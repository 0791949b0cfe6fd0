"""Host-side data of the port (NumPy): NIfTI IO, datasets, LiTS
preprocessing, molding and resampling."""
