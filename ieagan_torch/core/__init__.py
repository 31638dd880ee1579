"""Config surface of the port."""
