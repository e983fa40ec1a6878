"""CVAT REST API client: load tasks into Projects, push annotations back.

Counterpart of the reference's CVAT web client
(`miso/object_detection/dataset/cvat/cvat_web_api.py`), with the same
protocol surface:

* v1/v2 path prefixes (``api/v1`` vs ``api``, reference :188-193);
* ``load()`` = GET ``/tasks/{id}`` (name, labels, data id, :313-336)
  → GET ``/tasks/{id}/data/meta`` (frame names, :350-358)
  → GET ``/tasks/{id}/annotations`` (shapes + tracks, :360-369)
  → project build with linear track-keyframe interpolation (:243-277);
* image root resolution: explicit root, WSL2 docker-volume path, or the
  in-container ``/home/django/data/data/{data_id}/raw`` default with the
  ``/home/django/share`` per-frame fallback (:324-330, :227-232);
* upload: ``add_missing_labels`` → PATCH ``/projects/{id}`` labels
  (:371-405), then ``add_shapes`` → PATCH
  ``/tasks/{id}/annotations?action=create`` with integer corner coords
  (:407-432).

Deliberate fixes over the reference (documented per SURVEY.md §2):
credentials are configurable instead of hardcoded ``admin/admin`` (:317);
interpolated track boxes attach to their OWN frame (the reference attaches
them all to the end keyframe, :253); missing image files can't misalign
frame indices (frame->image mapping is a dict, not a compacted list);
polygon shapes are imported as PolygonAnnotations rather than silently
skipped (:279-280).

Counterpart of ``podtpu/data/cvat/client.py`` on the port's data model, with
the same protocol, JSON bodies and retry rule.  HTTP goes through the
standard library's ``urllib.request`` (HTTP Basic authorisation, JSON
bodies), so the client runs where ``requests`` is not installed; there is
no ``session=`` argument.
"""
from __future__ import annotations

import base64
import json
import os
import socket
from time import sleep
from typing import Dict, List, Optional
from urllib import error, request

import numpy as np

from podtpu_torch.data.annotation import PolygonAnnotation, RectangleAnnotation
from podtpu_torch.data.image import ImageMetadata
from podtpu_torch.data.label import Label
from podtpu_torch.data.project import Project

WSL2_DATA_ROOT = ("/mnt/w/version-pack-data/community/docker/volumes/"
                  "cvat_cvat_data/_data/data")
CONTAINER_DATA_ROOT = "/home/django/data/data"
SHARE_ROOT = "/home/django/share"


def api_prefix(api: str) -> str:
    if api == "v1":
        return "api/v1"
    if api == "v2":
        return "api"
    raise ValueError("api parameter must be 'v1' or 'v2'")


class Http:
    """JSON over HTTP with Basic authorisation (the header ``requests``'
    ``HTTPBasicAuth`` sends)."""

    def __init__(self, username: str, password: str):
        token = base64.b64encode(f"{username}:{password}".encode("latin1"))
        self.headers = {"Authorization": "Basic " + token.decode("ascii")}

    def open(self, method: str, url: str, body=None):
        """The response of one request; raises ``urllib.error.HTTPError``
        on a 4xx or 5xx status."""
        headers = dict(self.headers)
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        return request.urlopen(request.Request(url, data=data,
                                               headers=headers,
                                               method=method))

    def get_json(self, url: str):
        with self.open("GET", url) as resp:
            return json.loads(resp.read())

    def send(self, method: str, url: str, body) -> int:
        """Send a JSON body; returns the status, an error's too."""
        try:
            with self.open(method, url, body) as resp:
                return resp.status
        except error.HTTPError as exc:
            exc.close()
            return exc.code

    def send_json(self, method: str, url: str, body):
        with self.open(method, url, body) as resp:
            return json.loads(resp.read())


def labeled_shape_json(points, frame: int, label_id: int,
                       shape_type: str = "rectangle", group: int = 0,
                       occluded: bool = False) -> dict:
    """One element of the annotations-PATCH ``shapes`` list."""
    return {
        "type": shape_type,
        "occluded": bool(occluded),
        "z_order": 0,
        "points": list(points),
        "frame": int(frame),
        "label_id": int(label_id),
        "group": group,
        "attributes": [],
    }


def labeled_data_json(shapes=None, tracks=None, version: int = 0) -> dict:
    """The annotations-PATCH body (reference ``CvatLabeledData``)."""
    return {
        "version": version,
        "tags": [],
        "shapes": list(shapes or []),
        "tracks": list(tracks or []),
    }


def tracked_shape_json(points, frame: int, outside: bool) -> dict:
    return {
        "type": "rectangle",
        "occluded": False,
        "points": [float(p) for p in points],
        "frame": int(frame),
        "outside": bool(outside),
        "attributes": [],
    }


def track_json(frame: int, label_id: int, shapes) -> dict:
    return {
        "frame": int(frame),
        "label_id": int(label_id),
        "group": 0,
        "shapes": list(shapes),
        "attributes": [],
    }


class CvatTask:
    def __init__(self,
                 server: str,
                 task_id: int,
                 image_root: Optional[str] = None,
                 is_wsl2: bool = False,
                 api: str = "v1",
                 debug: bool = True,
                 username: str = "admin",
                 password: str = "admin"):
        self.server = server.rstrip("/")
        self.task_id = task_id
        self.api = api_prefix(api)
        self.image_root = image_root
        self.explicit_root = image_root is not None
        self.is_wsl2 = is_wsl2
        self.debug = debug
        self.http = Http(username, password)

        self.project_id: Optional[int] = None
        self.data_location = None
        self.name: Optional[str] = None
        self.label_dict_by_name: Dict[str, dict] = {}
        self.label_dict_by_id: Dict[int, dict] = {}
        self.frames: List[str] = []
        self.shapes: List[dict] = []
        self.tracks: List[dict] = []
        self.project = Project()

    # -- loading -------------------------------------------------------------
    def load(self) -> "CvatTask":
        if self.debug:
            print("=" * 80)
            print(f"Loading CVAT task {self.task_id}")
            print("-" * 80)
        self._get_metadata()
        self._get_frames()
        self._get_annotations()
        self._build_project()
        if self.debug:
            print("=" * 80)
        return self

    def _get(self, path: str, retries: int = 3,
             backoff: float = 1.0) -> dict:
        """GET with retry/backoff (the reference had no HTTP failure
        handling at all — SURVEY.md §5 failure detection)."""
        url = f"{self.server}/{self.api}/{path}"
        if self.debug:
            print(f"GET {url}")
        last_exc = None
        for attempt in range(retries):
            try:
                return self.http.get_json(url)
            except error.HTTPError as exc:
                exc.close()
                if 400 <= exc.code < 500:
                    raise  # client errors don't retry
                last_exc = exc
            except (error.URLError, socket.timeout, ConnectionError) as exc:
                last_exc = exc
            if attempt + 1 < retries:
                sleep(backoff * (2 ** attempt))
        raise last_exc

    def _get_metadata(self) -> None:
        data = self._get(f"tasks/{self.task_id}")
        self.name = data["name"]
        self.project_id = data.get("project_id")
        self.label_dict_by_name = {l["name"]: l for l in data["labels"]}
        self.label_dict_by_id = {l["id"]: l for l in data["labels"]}
        self.data_location = data.get("data")
        if not self.explicit_root:
            if self.is_wsl2:
                self.image_root = \
                    f"{WSL2_DATA_ROOT}/{self.data_location}/raw"
            else:
                self.image_root = \
                    f"{CONTAINER_DATA_ROOT}/{self.data_location}/raw"
        elif self.data_location is not None:
            self.image_root = os.path.join(
                self.image_root, str(self.data_location), "raw")
        if self.debug:
            print(f"- Name: {self.name}")
            print(f"- Image root: {self.image_root}")
            print(f"- Labels: {list(self.label_dict_by_name)}")

    def _refresh_labels(self) -> None:
        data = self._get(f"tasks/{self.task_id}")
        self.label_dict_by_name = {l["name"]: l for l in data["labels"]}
        self.label_dict_by_id = {l["id"]: l for l in data["labels"]}

    def _get_frames(self) -> None:
        data = self._get(f"tasks/{self.task_id}/data/meta")
        self.frames = [frame["name"] for frame in data["frames"]]
        if self.debug:
            print(f"- {len(self.frames)} frames")

    def _get_annotations(self) -> None:
        data = self._get(f"tasks/{self.task_id}/annotations")
        self.shapes = data["shapes"]
        self.tracks = data["tracks"]
        if self.debug:
            print(f"- {len(self.shapes)} shapes, {len(self.tracks)} tracks")

    def _build_project(self) -> None:
        self.project = Project()
        self.project.task_names[self.task_id] = self.name
        for label in self.label_dict_by_name.values():
            self.project.add_label(label["id"], label["name"],
                                   label.get("color"))

        frame_to_image: Dict[int, ImageMetadata] = {}
        for idx, frame in enumerate(self.frames):
            if os.path.exists(os.path.join(self.image_root, frame)):
                image = ImageMetadata(frame, self.image_root, self.task_id,
                                      idx)
            elif os.path.exists(os.path.join(SHARE_ROOT, frame)):
                image = ImageMetadata(frame, SHARE_ROOT, self.task_id, idx)
            else:
                print(f"Image {frame} could not be found.")
                continue
            self.project.add_image(image)
            frame_to_image[idx] = image

        # Boxes created per frame (with their CVAT group ids) — the
        # association targets for "points" shapes below.
        created = []  # (frame, group, annotation)

        # Tracks: rectangles with linear interpolation between keyframes.
        for track in self.tracks:
            label = self.label_dict_by_id[track["label_id"]]["name"]
            seq_id = track.get("id")
            tgroup = track.get("group") or 0
            keyframes = [s for s in track["shapes"]
                         if s["type"] == "rectangle"]
            seq_len = max(len(keyframes) - 1, 1)
            seq_idx = 0
            prev_frame, prev_p = None, None
            for shape in keyframes:
                frame_idx = shape["frame"]
                if shape.get("outside"):
                    prev_frame, prev_p = None, None
                    continue
                p = np.asarray(shape["points"], dtype=np.float64)
                if prev_frame is not None and frame_idx - prev_frame > 1:
                    for mid in range(prev_frame + 1, frame_idx):
                        t = (mid - prev_frame) / (frame_idx - prev_frame)
                        q = prev_p + (p - prev_p) * t
                        image = frame_to_image.get(mid)
                        if image is not None:
                            ann = RectangleAnnotation(
                                q[0], q[1], q[2] - q[0], q[3] - q[1], label,
                                track_id=seq_id, track_len=seq_len,
                                track_idx=seq_idx, frame_id=mid,
                                track_is_keypoint=False)
                            image.boxes.append(ann)
                            created.append((mid, tgroup, ann))
                        seq_idx += 1
                image = frame_to_image.get(frame_idx)
                if image is not None:
                    ann = RectangleAnnotation(
                        p[0], p[1], p[2] - p[0], p[3] - p[1], label,
                        track_id=seq_id, track_len=seq_len,
                        track_idx=seq_idx, frame_id=frame_idx)
                    image.boxes.append(ann)
                    created.append((frame_idx, tgroup, ann))
                prev_frame, prev_p = frame_idx, p
                seq_idx += 1

        # Plain shapes.  Rectangles/polygons first (remembering their CVAT
        # group ids), then "points" shapes are attached to an instance.
        pending_points = []
        for shape in self.shapes:
            image = frame_to_image.get(shape["frame"])
            if image is None:
                continue
            if shape["type"] == "rectangle":
                label = self.label_dict_by_id[shape["label_id"]]["name"]
                p = np.asarray(shape["points"], dtype=np.float64)
                ann = RectangleAnnotation(
                    p[0], p[1], p[2] - p[0], p[3] - p[1], label,
                    track_id=shape.get("id"))
                image.boxes.append(ann)
                created.append((shape["frame"], shape.get("group") or 0,
                                ann))
            elif shape["type"] == "polygon":
                # First-class polygons (box views via .coords/.bounds; mask
                # targets via .rasterize); the reference silently skipped
                # these (cvat_web_api.py:279-280,302-303).
                label = self.label_dict_by_id[shape["label_id"]]["name"]
                p = np.asarray(shape["points"], dtype=np.float64)
                ann = PolygonAnnotation(
                    p[0::2].tolist(), p[1::2].tolist(), label,
                    uid=shape.get("id"))
                image.boxes.append(ann)
                created.append((shape["frame"], shape.get("group") or 0,
                                ann))
            elif shape["type"] == "points":
                pending_points.append(shape)

        # Keypoints: a CVAT "points" shape becomes the (x, y, v) triples of
        # an instance (the reference skipped points like polygons).  The
        # owning instance is found by the shapes' shared CVAT group id,
        # else the smallest same-frame box containing the points' centroid;
        # ungrouped free points become a standalone box over their extent.
        for shape in pending_points:
            image = frame_to_image.get(shape["frame"])
            if image is None:
                continue
            label = self.label_dict_by_id[shape["label_id"]]["name"]
            p = np.asarray(shape["points"], dtype=np.float64)
            vis = 1.0 if shape.get("occluded") else 2.0
            kps = [(float(x), float(y), vis)
                   for x, y in zip(p[0::2], p[1::2])]
            group = shape.get("group") or 0
            frame_anns = [(g, a) for f, g, a in created
                          if f == shape["frame"]]
            target = None
            if group:
                grouped = [a for g, a in frame_anns if g == group]
                target = grouped[0] if grouped else None
            if target is None:
                cx, cy = float(p[0::2].mean()), float(p[1::2].mean())
                containing = [
                    a for _, a in frame_anns
                    if a.coords[0] <= cx <= a.coords[2]
                    and a.coords[1] <= cy <= a.coords[3]]
                if containing:
                    target = min(
                        containing,
                        key=lambda a: (a.coords[2] - a.coords[0])
                        * (a.coords[3] - a.coords[1]))
            if target is not None:
                # A second points shape in the same group extends the
                # instance's skeleton (annotators often split one).
                existing = getattr(target, "keypoints", None)
                target.keypoints = (list(existing) if existing else []) \
                    + kps
            else:
                # Standalone: a box over the points' extent, padded so a
                # single landmark doesn't create a degenerate zero-area gt
                # (the RPN matcher would force-match it and its encoded
                # size targets blow up).
                pad = 2.0
                x1 = float(p[0::2].min()) - pad
                y1 = float(p[1::2].min()) - pad
                x2 = float(p[0::2].max()) + pad
                y2 = float(p[1::2].max()) + pad
                image.boxes.append(RectangleAnnotation(
                    x1, y1, x2 - x1, y2 - y1, label,
                    track_id=shape.get("id"), keypoints=kps))

    # -- uploading -----------------------------------------------------------
    def add_missing_labels(self, project: Project) -> None:
        self._refresh_labels()
        cvat_names = set(self.label_dict_by_name)
        new_labels = [label for label in project.label_dict.values()
                      if label.name not in cvat_names]
        if new_labels:
            if self.debug:
                print(f"Adding labels: {[l.name for l in new_labels]}")
            self.add_labels(new_labels)
            self._refresh_labels()

    def add_labels(self, labels: List[Label]) -> None:
        url = f"{self.server}/{self.api}/projects/{self.project_id}"
        payload = []
        for label in labels:
            entry = {"name": label.name}
            if label.colour is not None:
                entry["color"] = label.colour
            if label.id is not None:
                entry["id"] = label.id
            payload.append(entry)
        status = self.http.send("PATCH", url, {"labels": payload})
        print(f"Add labels result: {status}")

    def add_shapes(self, project: Project) -> None:
        """Push every annotation of ``project`` as new task annotations.

        Rectangles upload with int coords (the reference's behavior,
        `cvat_web_api.py:424-432`); PolygonAnnotations upload as real
        CVAT polygon shapes (e.g. mask-model contours from ``infer()``);
        instance keypoints upload as a companion "points" shape sharing a
        fresh group id with its box — the same linkage the import side
        resolves."""
        self.add_missing_labels(project)
        shapes = []
        # Fresh group ids must not collide with the task's EXISTING groups
        # (CVAT would merge the uploaded pair into a manual group).
        group_counter = max(
            [0] + [s.get("group") or 0 for s in self.shapes]
            + [t.get("group") or 0 for t in self.tracks])
        for image in project.image_dict.values():
            for box in image.boxes:
                label_id = self.label_dict_by_name[box.label]["id"]
                # Only LABELLED keypoints upload (v=0 triples are COCO
                # placeholders at (0, 0) — not real points).
                kps = [kp for kp in (getattr(box, "keypoints", None) or [])
                       if kp[2] > 0]
                group = 0
                if kps:
                    group_counter += 1
                    group = group_counter
                if isinstance(box, PolygonAnnotation):
                    pts = [float(v) for xy in zip(box.xs, box.ys)
                           for v in xy]
                    shapes.append(labeled_shape_json(
                        pts, image.frame_id, label_id,
                        shape_type="polygon", group=group))
                else:
                    shapes.append(labeled_shape_json(
                        list(box.coords_int), image.frame_id, label_id,
                        group=group))
                if kps:
                    flat = [float(v) for kp in kps for v in kp[:2]]
                    # CVAT has no per-point visibility channel: the shape
                    # is marked occluded when every point carries the COCO
                    # occluded code (v == 1 exactly) — the import side then
                    # restores v=1.  Inference keypoints store a confidence
                    # in [0, 1] instead and upload as visible.
                    shapes.append(labeled_shape_json(
                        flat, image.frame_id, label_id,
                        shape_type="points", group=group,
                        occluded=all(kp[2] == 1 for kp in kps)))
        body = labeled_data_json(shapes=shapes)
        url = (f"{self.server}/{self.api}/tasks/{self.task_id}"
               f"/annotations?action=create")
        if self.debug:
            print(f"Creating {len(shapes)} shapes for task {self.task_id}...")
        status = self.http.send("PATCH", url, body)
        print(f"Add shapes result: {status}")


class CvatProject:
    """Project-level operations: task listing, creation, label management."""

    def __init__(self, server: str, project_id: int, api: str = "v1",
                 debug: bool = True, username: str = "admin",
                 password: str = "admin",
                 create_task_wait: float = 15.0):
        self.server = server.rstrip("/")
        self.project_id = project_id
        self.api = api_prefix(api)
        self.debug = debug
        self.http = Http(username, password)
        self.create_task_wait = create_task_wait
        self.tasks: Dict[int, CvatTask] = {}
        self.id_to_label: Dict[int, str] = {}
        self.label_to_id: Dict[str, int] = {}
        self.metadata: dict = {}

    def load(self) -> "CvatProject":
        url = f"{self.server}/{self.api}/projects/{self.project_id}"
        if self.debug:
            print(f"GET {url}")
        data = self.http.get_json(url)
        self.id_to_label = {l["id"]: l["name"] for l in data["labels"]}
        self.label_to_id = {l["name"]: l["id"] for l in data["labels"]}
        self.metadata = data
        return self

    def load_task(self, task_id: int, **kw) -> CvatTask:
        if task_id not in self.tasks:
            task = CvatTask(self.server, task_id, debug=self.debug, **kw)
            task.load()
            self.tasks[task_id] = task
        return self.tasks[task_id]

    def create_task(self, task_name: str, filenames: List[str]) -> int:
        """Create a task + attach server files; returns the new task id.

        (The reference sleeps a flat 15 s for CVAT to ingest the images,
        `cvat_web_api.py:492-494`; configurable here.)
        """
        url = f"{self.server}/{self.api}/tasks"
        task_id = self.http.send_json("POST", url, {
            "project_id": self.project_id, "name": task_name})["id"]
        data_url = f"{self.server}/{self.api}/tasks/{task_id}/data"
        content = {"chunk_size": 4, "image_quality": 70, "client_files": [],
                   "server_files": filenames, "remote_files": [],
                   "use_zip_chunks": False, "use_cache": True}
        self.http.send("POST", data_url, content)
        if self.create_task_wait:
            print("Waiting for CVAT to ingest task images...")
            sleep(self.create_task_wait)
        return task_id


class Cvat:
    """Server-level operations: project listing and lookup by name."""

    def __init__(self, server: str, api: str = "v1", debug: bool = True,
                 username: str = "admin", password: str = "admin"):
        self.server = server.rstrip("/")
        self.api = api_prefix(api)
        self.debug = debug
        self.http = Http(username, password)
        self.id_to_project: Dict[int, str] = {}
        self.project_to_id: Dict[str, int] = {}
        self.projects: Dict[int, CvatProject] = {}

    def load(self) -> "Cvat":
        url = f"{self.server}/{self.api}/projects?names_only=true"
        data = self.http.get_json(url)
        self.id_to_project = {p["id"]: p["name"] for p in data["results"]}
        self.project_to_id = {p["name"]: p["id"] for p in data["results"]}
        if self.debug:
            print("Projects:")
            for key, val in self.id_to_project.items():
                print(f" - {key:3d}: {val}")
        return self

    def load_project(self, project_id: int) -> CvatProject:
        if project_id not in self.projects:
            self.projects[project_id] = CvatProject(
                self.server, project_id, debug=self.debug).load()
        return self.projects[project_id]

    def load_project_by_name(self, name: str) -> CvatProject:
        return self.load_project(self.project_to_id[name])
