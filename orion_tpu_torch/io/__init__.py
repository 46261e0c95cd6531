"""Scene-file and image I/O (NumPy only)."""
