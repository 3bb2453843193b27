"""Detection models of the port: the YOLOX family, and the shared
predict builder the serving engine uses."""

from . import predict, yolox  # noqa: F401
from .predict import (DETECTION_PREFIXES, build_predict_fn,  # noqa: F401
                      is_detection_model)
