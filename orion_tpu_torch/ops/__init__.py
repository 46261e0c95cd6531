"""Intersection, shading and the CUDA kernels with their plain versions."""
