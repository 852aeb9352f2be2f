from .dataset import IMG_EXTS, imread_rgb, letterbox
from .pipeline import normalize_images

__all__ = ["IMG_EXTS", "imread_rgb", "letterbox", "normalize_images"]
