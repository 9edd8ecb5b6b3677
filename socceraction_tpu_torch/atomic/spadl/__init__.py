"""The Atomic-SPADL action language."""
