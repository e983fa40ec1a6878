"""Image metadata record.

Parity: reference `miso/object_detection/dataset/image.py:9-61` — an image is
identified by ``{dataset_id}_{frame_id}_{path}`` where ``path`` is relative to
a ``container`` root directory; it carries its list of box annotations and a
free-form metadata dict.  Counterpart of ``podtpu/data/image.py``.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Union

from podtpu_torch.data.annotation import RectangleAnnotation


class ImageMetadata:
    def __init__(
        self,
        path,
        container,
        dataset_id: int = 0,
        frame_id: int = 0,
        metadata: Optional[Dict] = None,
    ):
        # Path to the image inside the container root.
        self.path = path
        # Container root directory.
        self.container = container
        # Id of the dataset (CVAT task) this image belongs to.
        self.dataset_id = dataset_id
        # Index of the image within the dataset.
        self.frame_id = frame_id
        # Box annotations.
        self.boxes: List[RectangleAnnotation] = []
        # Free-form metadata.
        self.metadata: Dict = metadata if metadata is not None else {}

    @property
    def id(self) -> str:
        return ImageMetadata.create_id(self.path, self.dataset_id, self.frame_id)

    @staticmethod
    def create_id(path, dataset_id: int = 0, frame_id: int = 0) -> str:
        return f"{dataset_id}_{frame_id}_{path}"

    @property
    def full_path(self) -> str:
        return os.path.join(str(self.container), str(self.path))

    @property
    def labels(self) -> List[str]:
        return list({box.label for box in self.boxes})

    def has_label(self, label: Union[str, list]) -> bool:
        wanted = [label] if isinstance(label, str) else list(label)
        return any(box.label in wanted for box in self.boxes)

    def add_annotation(self, annotation: RectangleAnnotation) -> None:
        self.boxes.append(annotation)

    def __repr__(self) -> str:
        return f"ImageMetadata({self.id!r}, boxes={len(self.boxes)})"
