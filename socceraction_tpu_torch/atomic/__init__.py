"""Atomic-SPADL: its vocabulary and the Atomic-VAEP model."""
