"""Dataset/annotation data model and input pipeline.

Reproduces the semantics of the reference's ``miso/object_detection/dataset``
package (Project / ImageMetadata / Label / Rectangle+Polygon annotations, CVAT
REST + XML I/O) and a fixed-shape input pipeline.  Counterpart of
``podtpu/data/__init__.py``, with the same exports.
"""
from podtpu_torch.data.label import Label
from podtpu_torch.data.annotation import Annotation, RectangleAnnotation, PolygonAnnotation
from podtpu_torch.data.image import ImageMetadata
from podtpu_torch.data.project import Project

__all__ = [
    "Label",
    "Annotation",
    "RectangleAnnotation",
    "PolygonAnnotation",
    "ImageMetadata",
    "Project",
]
