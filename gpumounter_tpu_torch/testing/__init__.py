"""Test rigs of the port: fixture nodes and containers for driving the
control plane without a cluster."""
