"""Synthetic data (numpy): EMNIST and its federated partition, and the
LM token stream."""
