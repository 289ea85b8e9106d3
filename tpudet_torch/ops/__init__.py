"""Box geometry, anchors, NMS and RoI Align: the plain PyTorch versions."""
