"""Utilities (copied from the reference's ``utils``): the metrics
registry."""
