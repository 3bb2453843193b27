"""Evaluation of the port: top-k counts, the detection precision helpers
(``metrics``), the COCO evaluator (``coco_eval``), PASCAL VOC AP
(``voc``), the COCO score over every rank's shard
(``distributed``), segmentation's confusion matrix and mIoU
(``metrics``), re-ID retrieval (``retrieval``) and keypoint decoding and
OKS (``keypoints``)."""
