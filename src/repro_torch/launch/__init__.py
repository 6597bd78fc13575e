"""Process groups for the distributed round engine."""
