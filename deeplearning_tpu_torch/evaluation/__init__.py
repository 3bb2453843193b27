"""Evaluation of the port: top-k counts, the detection precision helpers
(``metrics``), the COCO evaluator (``coco_eval``), PASCAL VOC AP
(``voc``) and the COCO score over every rank's shard
(``distributed``)."""
