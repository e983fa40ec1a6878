"""In-memory dataset model: labels + images + their annotations.

Parity: reference `miso/object_detection/dataset/project.py:7-124`.  All the
reference's label/image operations are reproduced, including merge semantics
(`add_project` raises ``KeyError`` on duplicate image ids, project.py:83-92)
and auto-registration of unseen labels in `add_image` (project.py:77-81).

One deliberate fix (SURVEY.md §"quirks"): the reference's
`remove_annotations_below_threshold` keeps ``score < threshold`` — inverted
logic (project.py:37-39, unused in its main paths).  Here it does what its
name says; `keep_annotations_below_threshold` preserves the legacy behavior.

Counterpart of ``podtpu/data/project.py``.
"""
from __future__ import annotations

from typing import Dict, List, Union

from podtpu_torch.data.image import ImageMetadata
from podtpu_torch.data.label import Label


class Project:
    def __init__(self):
        self.filename = ""
        self.task_names: Dict[int, str] = {}
        self.image_dict: Dict[str, ImageMetadata] = {}
        self.label_dict: Dict[str, Label] = {}

    # -- labels --------------------------------------------------------------
    @property
    def label_names(self) -> List[str]:
        return [label.name for label in self.label_dict.values()]

    def add_label(self, id_, name, colour) -> None:
        if name not in self.label_dict:
            self.label_dict[name] = Label(id_, name, colour)

    def keep_annotations_with_label(self, labels: Union[str, list]) -> None:
        if isinstance(labels, str):
            labels = [labels]
        for image in self.image_dict.values():
            image.boxes = [ann for ann in image.boxes if ann.label in labels]

    def remove_annotations_with_label(self, labels: Union[str, list]) -> None:
        if isinstance(labels, str):
            labels = [labels]
        for image in self.image_dict.values():
            image.boxes = [ann for ann in image.boxes if ann.label not in labels]

    def remove_annotations_below_threshold(self, threshold: float) -> None:
        for image in self.image_dict.values():
            image.boxes = [ann for ann in image.boxes if ann.score >= threshold]

    def keep_annotations_below_threshold(self, threshold: float) -> None:
        for image in self.image_dict.values():
            image.boxes = [ann for ann in image.boxes if ann.score < threshold]

    def label_counts(self) -> Dict[str, int]:
        counts = {name: 0 for name in self.label_dict}
        for image in self.image_dict.values():
            for box in image.boxes:
                counts[box.label] = counts.get(box.label, 0) + 1
        return counts

    def labels_in_use(self) -> Dict[str, Label]:
        labels: Dict[str, Label] = {}
        for image in self.image_dict.values():
            for box in image.boxes:
                if box.label in self.label_dict:
                    labels[box.label] = self.label_dict[box.label]
                elif box.label not in labels:
                    labels[box.label] = Label(None, box.label, None)
        return labels

    def update_label_dict(self) -> None:
        self.label_dict = self.labels_in_use()

    def rename_label(self, old_label: str, new_label: str) -> None:
        """Relabel annotations in place. Call `update_label_dict` afterwards."""
        for image in self.image_dict.values():
            for ann in image.boxes:
                if ann.label == old_label:
                    ann.label = new_label

    # -- images --------------------------------------------------------------
    def add_image(self, image: ImageMetadata) -> None:
        self.image_dict[image.id] = image
        for box in image.boxes:
            if box.label not in self.label_dict:
                self.label_dict[box.label] = Label(None, box.label, None)

    def add_project(self, project: "Project") -> None:
        for key, image in project.image_dict.items():
            if key in self.image_dict:
                raise KeyError("Image from project already exists in this project")
            self.image_dict[key] = image
        for key, label in project.label_dict.items():
            if key not in self.label_dict:
                self.label_dict[key] = label
        for tid, name in project.task_names.items():
            self.task_names.setdefault(tid, name)

    def remove_unlabelled_images(self) -> None:
        self.image_dict = {k: v for k, v in self.image_dict.items() if v.boxes}

    def remove_labelled_images(self) -> None:
        self.image_dict = {k: v for k, v in self.image_dict.items() if not v.boxes}

    def box_counts(self) -> Dict[str, int]:
        counts = {"0": 0, "1-10": 0, "11-100": 0, "100+": 0}
        for image in self.image_dict.values():
            n = len(image.boxes)
            if n == 0:
                counts["0"] += 1
            elif n <= 10:
                counts["1-10"] += 1
            elif n <= 100:
                counts["11-100"] += 1
            else:
                counts["100+"] += 1
        return counts

    @property
    def images(self) -> List[ImageMetadata]:
        return list(self.image_dict.values())

    def __len__(self) -> int:
        return len(self.image_dict)

    def summary(self) -> str:
        """Pretty-print dataset stats; returns the text it prints."""
        counts = self.label_counts()
        lines = ["-" * 80, "Project summary", "Labels:"]
        for label in self.label_dict.values():
            lines.append(
                f"- {label.name} - id: {label.id}, colour: {label.colour}, "
                f"count: {counts.get(label.name, 0)}")
        lines.append(f"- total boxes: {sum(counts.values())}")
        lines.append("Image:")
        for rng, count in self.box_counts().items():
            lines.append(f"- {rng}: {count}")
        lines.append(f"- total images: {len(self.image_dict)}")
        lines.append("-" * 80)
        text = "\n".join(lines)
        print(text)
        print()
        return text
