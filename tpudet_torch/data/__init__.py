"""Input pipeline: the device-side preprocess."""
