"""Measurement scripts for the port, run on a CUDA device."""
