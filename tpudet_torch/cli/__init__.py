"""Presets of the configurations the port runs."""
