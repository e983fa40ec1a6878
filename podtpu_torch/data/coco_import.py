"""COCO-format dataset import/export.

Counterpart of the reference's plain-COCO loaders
(`miso/object_detection/engine/coco_utils.py:223-252` ``get_coco`` /
``CocoDetection``, used by its vendored generic trainer): loads a COCO
``instances_*.json`` annotation file into the framework's :class:`Project`
data model, so COCO-style datasets train through the exact same path as
CVAT tasks.  Polygon segmentations import as :class:`PolygonAnnotation`
(enabling mask training); everything else as boxes.

Also exports a Project's annotations back to COCO json (handy for
interoperating with external tooling).

Counterpart of ``podtpu/data/coco_import.py``, on the port's data model.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

from podtpu_torch.data.annotation import PolygonAnnotation, RectangleAnnotation
from podtpu_torch.data.image import ImageMetadata
from podtpu_torch.data.project import Project


def load_coco_json(annotations_json: str, image_root: str,
                   dataset_id: int = 0) -> Project:
    """Build a Project from a COCO annotation file.

    Args:
      annotations_json: path to ``instances_*.json``.
      image_root: directory containing the images (``file_name`` is
        resolved against it).
    """
    with open(annotations_json) as fp:
        coco = json.load(fp)

    project = Project()
    cat_by_id: Dict[int, str] = {}
    for cat in coco.get("categories", []):
        cat_by_id[cat["id"]] = cat["name"]
        project.add_label(cat["id"], cat["name"], None)

    images: Dict[int, ImageMetadata] = {}
    for i, im in enumerate(coco.get("images", [])):
        meta = ImageMetadata(im["file_name"], image_root, dataset_id,
                             frame_id=i)
        meta.metadata["coco_id"] = im["id"]
        if "height" in im:
            meta.metadata["height"] = im["height"]
            meta.metadata["width"] = im.get("width")
        images[im["id"]] = meta

    for ann in coco.get("annotations", []):
        meta = images.get(ann["image_id"])
        if meta is None:
            continue
        label = cat_by_id.get(ann["category_id"], str(ann["category_id"]))
        seg = ann.get("segmentation")
        # COCO person_keypoints_*.json: flat [x1, y1, v1, x2, y2, v2, ...]
        # triples on box annotations (the Keypoint R-CNN training signal).
        kp = ann.get("keypoints")
        keypoints = [tuple(kp[i: i + 3]) for i in range(0, len(kp), 3)] \
            if kp else None
        if isinstance(seg, list) and seg and isinstance(seg[0], list) \
                and len(seg[0]) >= 6 and not ann.get("iscrowd", 0):
            pts = seg[0]
            # person_keypoints_*.json annotations carry BOTH segmentation
            # and keypoints: keep the polygon (mask training) with the
            # triples attached.
            meta.add_annotation(PolygonAnnotation(
                pts[0::2], pts[1::2], label, uid=ann.get("id"),
                keypoints=keypoints))
        else:
            x, y, w, h = ann["bbox"]
            meta.add_annotation(RectangleAnnotation(
                x, y, w, h, label, uid=ann.get("id"),
                keypoints=keypoints))

    for meta in images.values():
        project.add_image(meta)
    return project


def export_coco_json(project: Project, out_path: str,
                     info: Optional[dict] = None) -> None:
    """Write the project's annotations as a COCO instances json."""
    labels = project.label_names
    cat_ids = {name: i + 1 for i, name in enumerate(labels)}
    images, annotations = [], []
    ann_id = 1
    for img_idx, meta in enumerate(project.image_dict.values()):
        entry = {"id": img_idx + 1, "file_name": str(meta.path)}
        if meta.metadata.get("height"):
            entry["height"] = meta.metadata["height"]
            entry["width"] = meta.metadata.get("width")
        images.append(entry)
        for box in meta.boxes:
            x, y, w, h = box.bounds
            ann = {
                "id": ann_id,
                "image_id": img_idx + 1,
                "category_id": cat_ids[box.label],
                "bbox": [float(x), float(y), float(w), float(h)],
                "area": float(w * h),
                "iscrowd": 0,
                "score": float(box.score),
            }
            if isinstance(box, PolygonAnnotation):
                seg = []
                for px, py in zip(box.xs, box.ys):
                    seg += [float(px), float(py)]
                ann["segmentation"] = [seg]
            kp = getattr(box, "keypoints", None)
            if kp:
                flat = [float(v) for t in kp for v in t]
                ann["keypoints"] = flat
                ann["num_keypoints"] = int(sum(1 for t in kp if t[2] > 0))
            annotations.append(ann)
            ann_id += 1
    payload = {
        "info": info or {"description": "podtpu export"},
        "images": images,
        "annotations": annotations,
        "categories": [{"id": cid, "name": name}
                       for name, cid in cat_ids.items()],
    }
    with open(out_path, "w") as fp:
        json.dump(payload, fp)
