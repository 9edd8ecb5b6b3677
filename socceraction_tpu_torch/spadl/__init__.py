"""SPADL vocabulary (the port's own copy)."""
