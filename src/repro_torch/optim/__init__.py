"""Server optimizers (plain SGD in this slice)."""
