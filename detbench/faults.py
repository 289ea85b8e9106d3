"""Faults planted in the program's timed path, for the checks that
``correct`` has to fail: each wraps the step the window calls."""

from __future__ import annotations

import torch


def moved_answer(step):
    """The first image's detections of every batch moved off the canvas
    and scored 1, where the program produces them."""
    def broken(batch):
        out = dict(step(batch))
        boxes, scores = out["boxes"].clone(), out["scores"].clone()
        boxes[0] += 8192.0
        scores[0] = torch.where(out["valid"][0], 1.0, scores[0])
        out.update(boxes=boxes, scores=scores)
        return out
    return broken


def unchanged_state(step):
    """A step that computes its loss and returns its state unchanged."""
    def broken(state, batch):
        named = dict(state.model.core.named_parameters())
        before = {n: p.detach().clone() for n, p in named.items()}
        state, metrics = step(state, batch)
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(before[n])
        return state, metrics
    return broken


def half_batch(step):
    """Half of the batch left out, the mean taken over the rest."""
    def broken(state, batch):
        half = batch["image"].shape[0] // 2
        return step(state, {k: v[:half] for k, v in batch.items()})
    return broken


FAULTS = {"moved_answer": moved_answer, "unchanged_state": unchanged_state,
          "half_batch": half_batch}
