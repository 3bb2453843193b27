"""Evaluation of the port: top-k counts, the detection precision helpers
(``metrics``), the COCO evaluator (``coco_eval``) and PASCAL VOC AP
(``voc``)."""
