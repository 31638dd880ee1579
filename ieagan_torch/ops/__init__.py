"""Functional building blocks of the port's models."""
