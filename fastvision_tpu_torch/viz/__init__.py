from .draw import draw_box_label, draw_detections, get_color

__all__ = ["draw_box_label", "draw_detections", "get_color"]
