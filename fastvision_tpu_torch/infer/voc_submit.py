"""VOC challenge submission writer (port of fastvision_tpu/infer/voc_submit.py).

Writes ``<out_dir>/VOC<year>/Main/<comp>_det_test_<class>.txt``, one line a
detection: ``<image_id> <score> <x1> <y1> <x2> <y2>`` (VOC is 1-based)."""
from __future__ import annotations

import os
from typing import Sequence


def write_voc_submission(detections: dict[str, dict], class_names: Sequence[str],
                         out_dir: str = "results", year: str = "2012",
                         comp: str = "comp3") -> str:
    """``detections``: {image_id: {boxes [N, 4] xyxy 0-based, scores,
    classes}}; classes outside ``class_names`` are left out. -> the
    ``Main`` directory written."""
    main_dir = os.path.join(out_dir, f"VOC{year}", "Main")
    os.makedirs(main_dir, exist_ok=True)
    files = {ci: open(os.path.join(main_dir, f"{comp}_det_test_{name}.txt"), "w")
             for ci, name in enumerate(class_names)}
    try:
        for image_id, res in detections.items():
            for box, score, cls in zip(res["boxes"], res["scores"], res["classes"]):
                f = files.get(int(cls))
                if f is None:
                    continue
                x1, y1, x2, y2 = (float(v) + 1 for v in box)  # 0- -> 1-based
                f.write(f"{image_id} {float(score):.6f} {x1:.1f} {y1:.1f} {x2:.1f} {y2:.1f}\n")
    finally:
        for f in files.values():
            f.close()
    return main_dir
