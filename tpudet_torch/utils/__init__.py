"""Utilities: metrics logging."""
