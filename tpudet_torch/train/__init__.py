"""Steps: the batched inference step."""
