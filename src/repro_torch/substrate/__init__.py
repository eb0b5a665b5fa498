"""Numeric substrate of the port: precision policies and plain layers."""
