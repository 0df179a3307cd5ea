"""Decoders of the port (greedy CTC so far)."""
