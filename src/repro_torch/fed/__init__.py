"""Federated training: the EMNIST task, round step, engine and trainer."""
