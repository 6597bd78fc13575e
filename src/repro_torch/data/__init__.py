"""Synthetic EMNIST data and its federated partition (numpy)."""
