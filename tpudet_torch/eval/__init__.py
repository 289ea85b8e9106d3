"""Evaluation and visualization (``tpudet.eval``): the host-side mAP
evaluators (boxes, masks, keypoints), panoptic fusion and PQ
(``eval.panoptic``), and the detection drawing."""

from tpudet_torch.eval.metrics import (  # noqa: F401
    CocoStyleEvaluator,
    DetectionEvaluator,
    ProposalRecallEvaluator,
    average_precision,
)
from tpudet_torch.eval.visualize import draw_detections  # noqa: F401
