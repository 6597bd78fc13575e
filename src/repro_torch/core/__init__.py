"""Mechanisms, grid, wire codec and privacy accounting."""
