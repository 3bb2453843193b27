"""Evaluation of the port: top-k counts, the detection precision helpers
(``metrics``) and the COCO evaluator (``coco_eval``)."""
