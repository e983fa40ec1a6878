"""Offline CVAT XML dump parser.

Counterpart of the reference's legacy parser
(`miso/object_detection/dataset/cvat/parse_cvat_xml.py:8-155`), which was
broken (imports ``xmltodict``, absent from its own dependency list, and is
unimported by any caller — SURVEY.md §2).  This version works, uses lxml
(already a dependency), and produces the same :class:`Project` data model as
the REST client, so exported ``annotations.xml`` dumps are a first-class
offline alternative to a live server.

Accepts either a single dump directory (``annotations.xml`` + ``images/``)
or a folder of such folders (the reference's two layouts,
`parse_cvat_xml.py:17-36`).

Counterpart of ``podtpu/data/cvat/xml.py``, on the port's data model.  lxml
is imported inside the functions that use it, so the module imports on a
machine without it.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional


from podtpu_torch.data.annotation import PolygonAnnotation, RectangleAnnotation
from podtpu_torch.data.image import ImageMetadata
from podtpu_torch.data.project import Project


def parse_annotations_xml(xml_path: str, image_root: Optional[str] = None,
                          dataset_id: int = 0) -> Project:
    """Parse one CVAT-for-images ``annotations.xml`` dump into a Project."""
    from lxml import etree

    tree = etree.parse(str(xml_path))
    root = tree.getroot()
    project = Project()

    task_name = root.findtext(".//task/name")
    if task_name:
        project.task_names[dataset_id] = task_name
    if image_root is None:
        image_root = str(Path(xml_path).parent / "images")

    for label_el in root.iterfind(".//task/labels/label"):
        name = label_el.findtext("name")
        colour = label_el.findtext("color")
        if name:
            project.add_label(None, name, colour)

    for image_el in root.iterfind("image"):
        frame_id = int(image_el.get("id", 0))
        meta = ImageMetadata(image_el.get("name"), image_root,
                             dataset_id, frame_id)
        for box_el in image_el.iterfind("box"):
            meta.add_annotation(RectangleAnnotation.from_cvat(box_el))
        for poly_el in image_el.iterfind("polygon"):
            meta.add_annotation(PolygonAnnotation.from_cvat(poly_el))
        project.add_image(meta)
    return project


def load_cvat_dump(path: str, dataset_id: int = 0) -> Project:
    """Load a dump directory, or merge a folder of dump directories."""
    p = Path(path)
    direct = p / "annotations.xml"
    if direct.exists():
        return parse_annotations_xml(str(direct), dataset_id=dataset_id)
    project = Project()
    found = False
    for i, sub in enumerate(sorted(p.iterdir())):
        xml = sub / "annotations.xml"
        if sub.is_dir() and xml.exists():
            project.add_project(
                parse_annotations_xml(str(xml), dataset_id=dataset_id + i))
            found = True
    if not found:
        raise FileNotFoundError(f"No annotations.xml found under {path}")
    return project


def write_annotations_xml(project: Project, out_path: str,
                          task_name: str = "podtpu-export") -> None:
    """Emit a CVAT-for-images dump for the project (round-trip capable)."""
    from lxml import etree

    root = etree.Element("annotations")
    etree.SubElement(root, "version").text = "1.1"
    meta = etree.SubElement(root, "meta")
    task = etree.SubElement(meta, "task")
    etree.SubElement(task, "name").text = task_name
    labels_el = etree.SubElement(task, "labels")
    for label in project.label_dict.values():
        label_el = etree.SubElement(labels_el, "label")
        etree.SubElement(label_el, "name").text = label.name
        if label.colour:
            etree.SubElement(label_el, "color").text = label.colour

    for image in project.image_dict.values():
        image_el = etree.SubElement(root, "image", attrib={
            "id": str(image.frame_id), "name": str(image.path)})
        for box in image.boxes:
            image_el.append(box.to_cvat())

    tree = etree.ElementTree(root)
    tree.write(str(out_path), pretty_print=True, xml_declaration=True,
               encoding="utf-8")
