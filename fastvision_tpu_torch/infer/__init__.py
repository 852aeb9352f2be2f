from .decode import decode_level, decode_predictions
from .export import (
    classifier_program,
    detector_program,
    export_program,
    load_exported,
    load_program,
    node_count,
    op_counts,
)
from .postprocess import detections_to_original, scale_coords
from .predictor import REFERENCE_SWEEP, Detector, VideoClassifier, detections_to_coco
from .preprocess import preprocess_batch, preprocess_image
from .quantize import calibrate, quantize_model, quantize_variables
from .serving import ServerClosing, VisionService, make_server, serve

__all__ = [
    "decode_level", "decode_predictions", "classifier_program", "detector_program",
    "export_program", "load_exported", "load_program", "node_count", "op_counts",
    "detections_to_original",
    "scale_coords", "REFERENCE_SWEEP", "Detector", "VideoClassifier", "detections_to_coco",
    "preprocess_batch", "preprocess_image", "calibrate", "quantize_model",
    "quantize_variables", "ServerClosing", "VisionService", "make_server",
    "serve",
]
