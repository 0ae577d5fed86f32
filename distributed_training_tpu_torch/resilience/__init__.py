"""Resilience of the port's training runs: the background checkpoint writer."""
