"""Annotation geometry types.

Behavioral parity with the reference's annotation model
(`miso/object_detection/dataset/annotation.py:33-293`):

* ``RectangleAnnotation`` stores a box as top-left (x, y) plus width/height,
  a string class label, a score, annotator/validator provenance, and optional
  track (sequence) fields used by CVAT track interpolation.
* ``bounds`` is (x, y, w, h); ``coords`` is (x1, y1, x2, y2); the ``*_int``
  variants round-then-int (reference :124-132).
* ``iou`` is the classic box IoU on xywh (reference :82-106);
  ``centre_point_distance`` down-weights the y axis by ``y_weight``
  (reference :108-114).
* CVAT XML element emit/parse (``to_cvat`` / ``to_cvat_sequenced`` /
  ``from_cvat``) matches the reference's attribute sets exactly
  (reference :137-169, :253-293) so dumps are interchangeable.
* ``PolygonAnnotation`` keeps xs/ys point lists with the CVAT
  ``"x,y;x,y;..."`` points-string encoding (reference :253-293) and JSON
  round-trip (reference :225-238).

The reference's broken ``__main__`` demo blocks (calls to nonexistent
``to_dict``/``to_via`` on rectangles) are deliberately not reproduced; instead
both types get working ``to_dict``/``from_dict``/``to_json``/``from_json``.

Counterpart of ``podtpu/data/annotation.py``.  ``lxml`` and Pillow are
imported inside the functions that use them, so the data model loads on a
machine that has neither.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import List, Optional



@dataclass
class Annotation:
    """Common fields for all annotation shapes."""

    label: str
    score: float = 1.0
    annotator: Optional[str] = None
    validator: Optional[str] = None
    uid: Optional[int] = None

    def iou(self, other: "Annotation") -> float:
        raise NotImplementedError

    def centre_point_distance(self, other: "Annotation", y_weight: float = 2) -> float:
        raise NotImplementedError

    @property
    def bounds(self):
        raise NotImplementedError


@dataclass
class RectangleAnnotation(Annotation):
    """Axis-aligned box: top-left corner + size, in image pixel coordinates."""

    x: float = 0.0
    y: float = 0.0
    width: float = 0.0
    height: float = 0.0
    frame_id: int = 0
    track_id: Optional[int] = None
    track_idx: int = 0
    track_len: int = 1
    track_is_keypoint: bool = True
    shape: str = "rect"

    def __init__(
        self,
        x,
        y,
        width,
        height,
        label,
        score=1.0,
        annotator=None,
        validator=None,
        uid=None,
        frame_id=0,
        track_id=None,
        track_idx=0,
        track_len=1,
        track_is_keypoint=True,
        shape="rect",
        keypoints=None,
    ):
        # Positional order mirrors the reference constructor
        # (annotation.py:34-49) so call sites are drop-in compatible.
        super().__init__(label=label, score=score, annotator=annotator,
                         validator=validator, uid=uid)
        self.x = float(x)
        self.y = float(y)
        self.width = float(width)
        self.height = float(height)
        self.frame_id = frame_id
        self.track_id = track_id
        self.track_idx = track_idx
        self.track_len = track_len
        self.track_is_keypoint = track_is_keypoint
        self.shape = "rect"
        # Optional instance keypoints: list of (x, y, visibility) triples in
        # image coordinates (COCO "keypoints" convention; visibility 0 =
        # unlabelled, 1 = occluded, 2 = visible — inference writes its
        # heatmap score here instead).  The reference's data model has no
        # keypoint channel; this feeds the Keypoint R-CNN family.
        self.keypoints = keypoints

    # -- geometry ------------------------------------------------------------
    @property
    def bounds(self):
        """(x, y, w, h) — top-left + size."""
        return self.x, self.y, self.width, self.height

    @property
    def coords(self):
        """(x1, y1, x2, y2) corner coordinates."""
        return self.x, self.y, self.x + self.width, self.y + self.height

    @property
    def coords_int(self):
        return tuple(int(round(c)) for c in self.coords)

    @property
    def bounds_int(self):
        return tuple(int(round(c)) for c in self.bounds)

    @property
    def centre(self):
        return self.x + self.width / 2, self.y + self.height / 2

    @property
    def area(self) -> float:
        return self.width * self.height

    def iou(self, other: "RectangleAnnotation") -> float:
        ix1 = max(self.x, other.x)
        iy1 = max(self.y, other.y)
        ix2 = min(self.x + self.width, other.x + other.width)
        iy2 = min(self.y + self.height, other.y + other.height)
        inter = max(ix2 - ix1, 0.0) * max(iy2 - iy1, 0.0)
        if inter == 0:
            return 0.0
        union = self.area + other.area - inter
        return inter / float(union)

    def centre_point_distance(self, other: "RectangleAnnotation", y_weight: float = 2) -> float:
        cx, cy = self.centre
        ox, oy = other.centre
        dx = abs(cx - ox)
        dy = abs(cy - oy) / y_weight
        return math.hypot(dx, dy)

    # -- serialisation -------------------------------------------------------
    def to_dict(self) -> dict:
        d = dict(
            shape="rect", x=self.x, y=self.y, width=self.width, height=self.height,
            label=self.label, score=self.score, annotator=self.annotator,
            validator=self.validator, uid=self.uid, frame_id=self.frame_id,
            track_id=self.track_id, track_idx=self.track_idx,
            track_len=self.track_len,
        )
        if self.keypoints is not None:
            d["keypoints"] = [list(kp) for kp in self.keypoints]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "RectangleAnnotation":
        d = dict(d)
        d.pop("shape", None)
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "RectangleAnnotation":
        return cls.from_dict(json.loads(s))

    # -- CVAT XML ------------------------------------------------------------
    def to_cvat(self) -> etree._Element:
        from lxml import etree

        x1, y1, x2, y2 = self.coords
        return etree.Element("box", attrib={
            "label": self.label,
            "occluded": "0",
            "source": "manual",
            "xtl": str(x1),
            "ytl": str(y1),
            "xbr": str(x2),
            "ybr": str(y2),
            "z_order": "0",
        })

    def to_cvat_sequenced(self, frame: int) -> etree._Element:
        from lxml import etree

        x1, y1, x2, y2 = self.coords
        return etree.Element("box", attrib={
            "frame": str(frame),
            "outside": "0",
            "occluded": "0",
            "keyframe": "1",
            "xtl": str(x1),
            "ytl": str(y1),
            "xbr": str(x2),
            "ybr": str(y2),
            "z_order": "0",
        })

    @staticmethod
    def from_cvat(el: etree._Element) -> "RectangleAnnotation":
        x1 = float(el.get("xtl"))
        y1 = float(el.get("ytl"))
        return RectangleAnnotation(
            x1, y1, float(el.get("xbr")) - x1, float(el.get("ybr")) - y1,
            el.get("label"),
        )

    def __str__(self) -> str:
        return (f"{self.label} - x: {self.x}, y: {self.y}, "
                f"w: {self.width}, h: {self.height}")


@dataclass
class PolygonAnnotation(Annotation):
    """Closed polygon given as parallel x/y coordinate lists."""

    xs: List[float] = field(default_factory=list)
    ys: List[float] = field(default_factory=list)
    track_id: Optional[int] = None
    track_idx: int = 0
    track_len: int = 1
    shape: str = "polygon"

    def __init__(
        self,
        xs,
        ys,
        label,
        score=1.0,
        annotator=None,
        validator=None,
        uid=None,
        track_id=None,
        track_idx=0,
        track_len=1,
        shape="polygon",
        keypoints=None,
    ):
        super().__init__(label=label, score=score, annotator=annotator,
                         validator=validator, uid=uid)
        self.xs = list(xs)
        self.ys = list(ys)
        self.track_id = track_id
        self.track_idx = track_idx
        self.track_len = track_len
        self.shape = "polygon"
        # Optional instance keypoints (same (x, y, visibility) convention
        # as RectangleAnnotation — COCO person_keypoints annotations carry
        # BOTH a segmentation polygon and keypoint triples).
        self.keypoints = keypoints

    # -- geometry ------------------------------------------------------------
    @property
    def bounds(self):
        """Axis-aligned bounding box (x, y, w, h) of the polygon."""
        x1, y1 = min(self.xs), min(self.ys)
        return x1, y1, max(self.xs) - x1, max(self.ys) - y1

    @property
    def coords(self):
        """Bounding box corners (x1, y1, x2, y2) — lets polygons flow through
        box-consuming code paths (dataset targets, crop export)."""
        x, y, w, h = self.bounds
        return x, y, x + w, y + h

    @property
    def coords_int(self):
        return tuple(int(round(c)) for c in self.coords)

    @property
    def bounds_int(self):
        return tuple(int(round(c)) for c in self.bounds)

    def to_rectangle(self) -> RectangleAnnotation:
        x, y, w, h = self.bounds
        return RectangleAnnotation(x, y, w, h, self.label, self.score)

    def rasterize(self, height: int, width: int, scale: float = 1.0):
        """Fill the polygon into a [height, width] uint8 bitmap (coordinates
        multiplied by ``scale``) — host-side mask target generation for
        Mask R-CNN training."""
        from PIL import Image, ImageDraw

        im = Image.new("L", (width, height), 0)
        pts = [(x * scale, y * scale) for x, y in zip(self.xs, self.ys)]
        if len(pts) >= 3:
            ImageDraw.Draw(im).polygon(pts, outline=1, fill=1)
        import numpy as _np
        return _np.asarray(im, dtype=_np.uint8)

    # Unlike the reference (NotImplemented, annotation.py:211-223), polygon
    # IoU/centre-distance work via the bounding-box approximation.
    def iou(self, other: "Annotation") -> float:
        return self.to_rectangle().iou(
            other.to_rectangle() if isinstance(other, PolygonAnnotation) else other)

    def centre_point_distance(self, other: "Annotation", y_weight: float = 2) -> float:
        return self.to_rectangle().centre_point_distance(
            other.to_rectangle() if isinstance(other, PolygonAnnotation) else other,
            y_weight=y_weight)

    # -- serialisation -------------------------------------------------------
    def to_dict(self) -> dict:
        d = dict(shape="polygon", xs=self.xs, ys=self.ys, label=self.label,
                 score=self.score, annotator=self.annotator,
                 validator=self.validator, uid=self.uid,
                 track_id=self.track_id, track_idx=self.track_idx,
                 track_len=self.track_len)
        if self.keypoints is not None:
            d["keypoints"] = [list(kp) for kp in self.keypoints]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "PolygonAnnotation":
        d = dict(d)
        d.pop("shape", None)
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "PolygonAnnotation":
        return cls.from_dict(json.loads(s))

    # -- CVAT XML ------------------------------------------------------------
    @property
    def points_str(self) -> str:
        return ";".join(f"{x},{y}" for x, y in zip(self.xs, self.ys))

    def to_cvat(self) -> etree._Element:
        from lxml import etree

        return etree.Element("polygon", attrib={
            "label": self.label,
            "occluded": "0",
            "source": "manual",
            "points": self.points_str,
            "z_order": "0",
        })

    def to_cvat_sequenced(self, frame: int) -> etree._Element:
        from lxml import etree

        return etree.Element("polygon", attrib={
            "frame": str(frame),
            "outside": "0",
            "occluded": "0",
            "keyframe": "1",
            "points": self.points_str,
            "z_order": "0",
        })

    @staticmethod
    def from_cvat(el: etree._Element) -> "PolygonAnnotation":
        xs, ys = [], []
        for pair in el.get("points").split(";"):
            sx, sy = pair.split(",")
            xs.append(float(sx))
            ys.append(float(sy))
        return PolygonAnnotation(xs, ys, el.get("label"))
