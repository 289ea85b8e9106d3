"""Utilities: metrics logging, timing and tracing."""
