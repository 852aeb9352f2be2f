from .decode import decode_level, decode_predictions
from .postprocess import detections_to_original, scale_coords
from .predictor import REFERENCE_SWEEP, Detector, VideoClassifier, detections_to_coco
from .preprocess import preprocess_batch, preprocess_image

__all__ = [
    "decode_level", "decode_predictions", "detections_to_original",
    "scale_coords", "REFERENCE_SWEEP", "Detector", "VideoClassifier", "detections_to_coco",
    "preprocess_batch", "preprocess_image",
]
