"""Mechanism, grid, wire codec and privacy accounting (RQM slice)."""
