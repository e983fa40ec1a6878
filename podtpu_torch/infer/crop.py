"""Crop annotated objects into class-sorted folders.

Counterpart of ``podtpu/infer/crop.py``, with the reference's contract
(`miso/object_detection/crop.py:9-34`): for every annotated image, each box
(integer corner coordinates, clipped to the image) is sliced out of the
full image and saved as ``<stem>_<x>_<y>_<w>_<h><suffix>`` under
``output/<"{task_id} - {task_name}" | relpath | ''>/<label>/``.  Images are
decoded by :func:`podtpu_torch.data.imageio.read_rgb`; Pillow, which writes
the crops, is imported inside :func:`crop_objects`.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from podtpu_torch.data import imageio
from podtpu_torch.data.project import Project


def crop_objects(project: Project, output_dir: str,
                 relative_to: Optional[str] = None) -> int:
    """Returns the number of crops written."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    output_path = Path(output_dir)
    written = 0

    for image in project.image_dict.values():
        if not image.boxes:
            continue
        arr = imageio.read_rgb(image.full_path)
        h, w = arr.shape[:2]
        src = Path(image.full_path)
        for box in image.boxes:
            if relative_to is not None:
                label_path = (output_path
                              / src.relative_to(relative_to).parent
                              / box.label)
            elif project.task_names:
                task_name = project.task_names.get(image.dataset_id,
                                                   str(image.dataset_id))
                label_path = (output_path
                              / f"{image.dataset_id} - {task_name}"
                              / box.label)
            else:
                label_path = output_path / box.label
            label_path.mkdir(parents=True, exist_ok=True)

            x1, y1, x2, y2 = box.coords_int
            x1c, y1c = max(x1, 0), max(y1, 0)
            x2c, y2c = min(x2, w), min(y2, h)
            if x2c <= x1c or y2c <= y1c:
                continue
            crop = arr[y1c:y2c, x1c:x2c]
            bx, by, bw, bh = box.bounds
            filename = (f"{src.stem}_{bx:.0f}_{by:.0f}_{bw:.0f}_{bh:.0f}"
                        f"{src.suffix}")
            Image.fromarray(crop).save(label_path / filename)
            written += 1
    return written
