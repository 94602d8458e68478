"""Cross-cutting infrastructure of the port (its own copies)."""
