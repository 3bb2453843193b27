"""Detection models of the port: RetinaNet, FCOS, Faster R-CNN, YOLOv5
(and its spec builder) and YOLOX, and the shared predict builder the
serving engine uses."""

from . import (faster_rcnn, fcos, fpn, predict, retinanet,  # noqa: F401
               yolo_builder, yolov5, yolox)
from .predict import (DETECTION_PREFIXES, build_predict_fn,  # noqa: F401
                      is_detection_model)
