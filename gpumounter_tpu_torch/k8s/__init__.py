"""Kubernetes object accessors (the port's own copies)."""
