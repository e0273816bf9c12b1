"""Diagnostics of the port's kernels, run by hand on the card."""
