from .decode import decode_level, decode_predictions
from .postprocess import detections_to_original, scale_coords
from .predictor import Detector
from .preprocess import preprocess_batch, preprocess_image

__all__ = [
    "decode_level", "decode_predictions", "detections_to_original",
    "scale_coords", "Detector", "preprocess_batch", "preprocess_image",
]
