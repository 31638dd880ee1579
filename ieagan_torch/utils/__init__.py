"""Checkpoint reading for the port."""
