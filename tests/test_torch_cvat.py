"""The port's CVAT client, CVAT XML and COCO import against the JAX
package's (CPU).

Both clients talk to one fake CVAT server (``tests/fake_cvat.py``) holding
the same state.  What is held, exactly: the projects ``load()`` builds
(every attribute of every image, box, polygon, keypoint and track field,
the labels and task names) for both API versions, for gapped and
``outside`` tracks, grouped, contained and free points and missing frames;
the image root each rule resolves; the PATCH bodies of ``add_shapes``
(labels PATCH included) and the POST bodies of ``CvatProject.create_task``;
what ``CvatProject`` and ``Cvat`` load; the retry rule of ``_get`` against a
server of the test's own (a 5xx is retried with backoff 1 s then 2 s, a 4xx
is raised at once, a refused connection is retried); the Basic
authorisation header, against ``requests``' ``HTTPBasicAuth``; the bytes of
``write_annotations_xml`` and the projects ``parse_annotations_xml`` and
``load_cvat_dump`` read back; and ``load_coco_json`` / ``export_coco_json``
on ``tests/test_coco_import.py``'s data with polygons and keypoints added.
"""
import json
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import requests
from PIL import Image

from podtpu.data import coco_import as jax_coco
from podtpu.data.annotation import PolygonAnnotation as JaxPolygon
from podtpu.data.annotation import RectangleAnnotation as JaxRect
from podtpu.data.cvat import client as jax_client
from podtpu.data.cvat import xml as jax_xml
from podtpu.data.project import Project as JaxProject
from podtpu_torch.data import coco_import
from podtpu_torch.data.annotation import PolygonAnnotation, RectangleAnnotation
from podtpu_torch.data.cvat import client
from podtpu_torch.data.cvat import xml as cvat_xml
from podtpu_torch.data.image import ImageMetadata
from podtpu_torch.data.project import Project
from tests.fake_cvat import FakeCvatServer, FakeCvatState
from tests.synthetic import make_project
from tests.test_coco_import import write_coco

LABELS = [{"id": 10, "name": "Coccolith", "color": "#ff0000"},
          {"id": 11, "name": "Foram", "color": "#00ff00"}]
FRAMES = [f"frame{i}.jpg" for i in range(6)]


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    """Frames 0-4 on disk under ``<root>/7/raw``; frame5.jpg is missing."""
    root = tmp_path_factory.mktemp("torch_cvat")
    raw = root / "7" / "raw"
    raw.mkdir(parents=True)
    for name in FRAMES[:5]:
        Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(raw / name)
    return str(root)


SHAPES = [
    {"id": 1, "type": "rectangle", "frame": 0, "label_id": 10,
     "points": [10.0, 20.0, 50.0, 60.0], "outside": False, "group": 7},
    {"id": 2, "type": "points", "frame": 0, "label_id": 10,
     "points": [20.0, 30.0, 30.0, 40.0], "group": 7, "outside": False},
    {"id": 3, "type": "points", "frame": 0, "label_id": 10,
     "points": [25.0, 35.0], "group": 7, "outside": False},
    {"id": 4, "type": "polygon", "frame": 1, "label_id": 11,
     "points": [0.0, 0.0, 10.0, 0.0, 10.0, 10.0], "outside": False},
    {"id": 5, "type": "rectangle", "frame": 1, "label_id": 10,
     "points": [0.0, 0.0, 30.0, 30.0], "outside": False},
    {"id": 6, "type": "rectangle", "frame": 1, "label_id": 10,
     "points": [5.0, 5.0, 20.0, 20.0], "outside": False},
    {"id": 7, "type": "points", "frame": 1, "label_id": 10,
     "points": [10.0, 10.0, 12.0, 12.0], "outside": False,
     "occluded": True},
    {"id": 8, "type": "points", "frame": 2, "label_id": 11,
     "points": [1.0, 2.0, 9.0, 6.0], "outside": False},
    {"id": 9, "type": "points", "frame": 3, "label_id": 11,
     "points": [3.0, 3.0], "group": 5, "outside": False},
    {"id": 10, "type": "rectangle", "frame": 5, "label_id": 10,
     "points": [1.0, 1.0, 4.0, 4.0], "outside": False},
]
TRACKS = [
    {"id": 99, "label_id": 10, "frame": 0, "group": 5, "shapes": [
        {"type": "rectangle", "frame": 0, "outside": False,
         "points": [0.0, 0.0, 10.0, 10.0]},
        {"type": "rectangle", "frame": 3, "outside": False,
         "points": [30.0, 30.0, 40.0, 46.0]},
        {"type": "rectangle", "frame": 4, "outside": True,
         "points": [30.0, 30.0, 40.0, 46.0]},
        {"type": "rectangle", "frame": 5, "outside": False,
         "points": [1.0, 2.0, 3.0, 4.0]}]},
    {"id": 100, "label_id": 11, "frame": 1, "shapes": [
        {"type": "rectangle", "frame": 1, "outside": False,
         "points": [5.0, 5.0, 9.0, 9.0]},
        {"type": "rectangle", "frame": 4, "outside": False,
         "points": [8.0, 2.0, 20.0, 21.0]}]},
]


def make_state():
    state = FakeCvatState()
    state.add_task(5, "plankton_task", LABELS, FRAMES, shapes=SHAPES,
                   tracks=TRACKS)
    state.add_task(8, "empty_task", LABELS, FRAMES[:2])
    return state


def state_of(project):
    """Every attribute of a project's labels, images and annotations."""
    return dict(
        tasks=sorted(project.task_names.items()),
        labels=[(l.id, l.name, l.colour)
                for l in project.label_dict.values()],
        images=[(k, {a: v for a, v in vars(im).items() if a != "boxes"},
                 [(type(b).__name__, vars(b)) for b in im.boxes])
                for k, im in project.image_dict.items()])


@pytest.mark.parametrize("api", ["v1", "v2"])
def test_load_builds_equal_projects(image_root, api, capsys):
    with FakeCvatServer(make_state()) as srv:
        tasks = [mod.CvatTask(srv.url, 5, image_root=image_root, api=api)
                 for mod in (jax_client, client)]
        outs = []
        for task in tasks:
            task.load()
            outs.append(capsys.readouterr().out)
    want, got = tasks
    assert state_of(got.project) == state_of(want.project)
    assert got.project.images and got.name == want.name == "plankton_task"
    assert (got.image_root, got.project_id, got.frames, got.shapes,
            got.tracks) == (want.image_root, want.project_id, want.frames,
                            want.shapes, want.tracks)
    # The same printout, URLs included; the missing frame is reported.
    assert outs[0] == outs[1] and "frame5.jpg could not be found" in outs[1]
    boxes = [b for im in got.project.images for b in im.boxes]
    assert {type(b).__name__ for b in boxes} == {"RectangleAnnotation",
                                                 "PolygonAnnotation"}
    assert any(b.keypoints for b in boxes)
    assert any(b.track_id == 99 and b.frame_id == 2 for b in boxes)


@pytest.mark.parametrize("rule", ["wsl2", "container"])
def test_image_root_rules(rule):
    with FakeCvatServer(make_state()) as srv:
        tasks = [mod.CvatTask(srv.url, 8, is_wsl2=rule == "wsl2",
                              debug=False)
                 for mod in (jax_client, client)]
        for task in tasks:
            task.load()
    want, got = tasks
    assert got.image_root == want.image_root
    assert got.image_root.endswith("/7/raw") and not got.project.images
    with pytest.raises(ValueError, match="v1"):
        client.CvatTask("http://x", 1, api="v3")


def upload(mod, url, image_root, detections):
    task = mod.CvatTask(url, 5, image_root=image_root, debug=False)
    task.load()
    task.add_shapes(detections(task))
    return task


def detections_for(rect, polygon, project_cls):
    def make(task):
        out = project_cls()
        im = task.project.images[0]
        im.boxes = [
            rect(1.2, 2.7, 10.0, 10.0, "Coccolith", score=0.9),
            polygon([1.0, 9.0, 5.0], [1.0, 1.0, 8.0], "Coccolith",
                    score=0.8),
            rect(10, 10, 20, 20, "Foram_NV", score=0.9,
                 keypoints=[(15.0, 15.0, 1.0), (0.0, 0.0, 0.0),
                            (25.0, 20.0, 1.0)]),
            rect(40, 40, 10, 10, "Foram", score=0.5,
                 keypoints=[(0.0, 0.0, 0.0)]),
            rect(3, 4, 5, 6, "Foram", keypoints=[(4.0, 5.0, 0.7)]),
        ]
        out.add_image(im)
        out.add_label(None, "Foram_NV", "#123456")
        return out
    return make


def test_add_shapes_sends_equal_bodies(image_root):
    bodies = []
    for mod, rect, poly, proj in (
            (jax_client, JaxRect, JaxPolygon, JaxProject),
            (client, RectangleAnnotation, PolygonAnnotation, Project)):
        state = make_state()
        with FakeCvatServer(state) as srv:
            task = upload(mod, srv.url, image_root,
                          detections_for(rect, poly, proj))
        bodies.append((state.patches, task.label_dict_by_name))
    (want, want_labels), (got, got_labels) = bodies
    assert [p["path"] for p in got] == [p["path"] for p in want]
    for g, w in zip(got, want):
        assert json.dumps(g["body"]) == json.dumps(w["body"])  # key order
    assert got_labels == want_labels and "Foram_NV" in got_labels
    label_patch, shapes_patch = got
    assert label_patch["path"].endswith("/projects/1")
    assert [s["type"] for s in shapes_patch["body"]["shapes"]] == [
        "rectangle", "polygon", "rectangle", "points", "rectangle",
        "rectangle", "points"]


def test_project_server_and_create_task(image_root):
    results = []
    for mod in (jax_client, client):
        state = make_state()
        with FakeCvatServer(state) as srv:
            proj = mod.CvatProject(srv.url, 1, debug=False,
                                   create_task_wait=0).load()
            new_id = proj.create_task("new_task", ["a.jpg", "b.jpg"])
            task = proj.load_task(5, image_root=image_root)
            cvat = mod.Cvat(srv.url, debug=False).load()
            by_name = cvat.load_project_by_name("project1")
        results.append(dict(
            labels=(proj.id_to_label, proj.label_to_id), meta=proj.metadata,
            new_id=new_id, posts=[(p["path"], json.dumps(p["body"]))
                                  for p in state.posts],
            task=state_of(task.project), projects=cvat.id_to_project,
            by_name=by_name.label_to_id))
    want, got = results
    assert got == want
    assert got["new_id"] == 9 and len(got["posts"]) == 2


class _Flaky(BaseHTTPRequestHandler):
    """Answers GET with the next status of ``statuses`` (200 once they run
    out) and records each request's path and Authorization header."""
    statuses: list = []
    seen: list = []

    def log_message(self, *args):
        pass

    def do_GET(self):
        self.seen.append((self.path, self.headers.get("Authorization")))
        code = self.statuses.pop(0) if self.statuses else 200
        body = json.dumps({"frames": [], "code": code}).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture
def flaky():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Flaky)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield httpd
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


@pytest.mark.parametrize("statuses, requests_made, delays, ok", [
    ([503, 502], 3, [1.0, 2.0], True),
    ([500, 500, 500], 3, [1.0, 2.0], False),
    ([404], 1, [], False),
    ([401, 500], 1, [], False),
])
def test_get_retry_rule(flaky, monkeypatch, statuses, requests_made, delays,
                        ok):
    for mod in (jax_client, client):
        slept = []
        monkeypatch.setattr(mod, "sleep", slept.append)
        _Flaky.statuses[:] = list(statuses)
        _Flaky.seen[:] = []
        host, port = flaky.server_address
        task = mod.CvatTask(f"http://{host}:{port}", 3, debug=False,
                            username="ann", password="pässwörd")
        if ok:
            assert task._get("tasks/3/data/meta")["code"] == 200
        else:
            with pytest.raises(Exception) as info:
                task._get("tasks/3/data/meta")
            code = getattr(info.value, "code", None) or \
                info.value.response.status_code
            assert code == statuses[len(_Flaky.seen) - 1]
        assert len(_Flaky.seen) == requests_made, mod.__name__
        assert slept == delays, mod.__name__
        assert {h for _, h in _Flaky.seen} == {
            requests.auth._basic_auth_str("ann", "pässwörd")}


def test_refused_connection_is_retried(monkeypatch):
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()  # nothing listens there now
    slept = []
    monkeypatch.setattr(client, "sleep", slept.append)
    task = client.CvatTask(f"http://127.0.0.1:{port}", 1, debug=False)
    with pytest.raises(OSError):
        task._get("tasks/1")
    assert slept == [1.0, 2.0]


def test_basic_header_equals_requests():
    for user, pw in (("admin", "admin"), ("a:b", ""), ("ünï", "cödé")):
        assert client.Http(user, pw).headers["Authorization"] == \
            requests.auth._basic_auth_str(user, pw)


def test_cvat_xml(tmp_path):
    jp = make_project(str(tmp_path / "images"), num_images=4, polygons=True,
                      labels=["a", "b"], seed=4)
    jp.task_names = {0: "xml_task"}
    pp = Project()
    pp.task_names = dict(jp.task_names)
    for label in jp.label_dict.values():
        pp.add_label(label.id, label.name, label.colour)
    for im in jp.image_dict.values():
        m = ImageMetadata(im.path, im.container, im.dataset_id, im.frame_id)
        for b in im.boxes:
            m.add_annotation(PolygonAnnotation(b.xs, b.ys, b.label,
                                               score=b.score))
        m.add_annotation(RectangleAnnotation(1.5, 2, 3, 4.25, "a"))
        im.add_annotation(JaxRect(1.5, 2, 3, 4.25, "a"))
        pp.add_image(m)
    for name, proj, mod in (("jax", jp, jax_xml), ("port", pp, cvat_xml)):
        dump = tmp_path / name / "dump0"
        dump.mkdir(parents=True)
        mod.write_annotations_xml(proj, str(dump / "annotations.xml"),
                                  task_name="xml_task")
        (tmp_path / name / "dump1").mkdir()
        (tmp_path / name / "dump1" / "annotations.xml").write_bytes(
            (dump / "annotations.xml").read_bytes())
    want = (tmp_path / "jax" / "dump0" / "annotations.xml").read_bytes()
    got = (tmp_path / "port" / "dump0" / "annotations.xml").read_bytes()
    assert got == want and b"<polygon" in got
    xml_path = str(tmp_path / "port" / "dump0" / "annotations.xml")
    assert state_of(cvat_xml.parse_annotations_xml(xml_path, dataset_id=3)) \
        == state_of(jax_xml.parse_annotations_xml(xml_path, dataset_id=3))
    for sub in ("dump0", ""):  # one dump, then a folder of dumps
        path = str(tmp_path / "port" / sub)
        assert state_of(cvat_xml.load_cvat_dump(path)) == \
            state_of(jax_xml.load_cvat_dump(path))
    with pytest.raises(FileNotFoundError):
        cvat_xml.load_cvat_dump(str(tmp_path / "images"))


def test_coco_import_export(tmp_path):
    path = write_coco(tmp_path)
    with open(path) as fp:
        coco = json.load(fp)
    coco["annotations"].append(
        {"id": 4, "image_id": 11, "category_id": 2, "bbox": [1, 2, 3, 4],
         "area": 12, "iscrowd": 0,
         "keypoints": [1, 2, 2, 3, 4, 1, 0, 0, 0]})
    coco["annotations"].append(
        {"id": 5, "image_id": 10, "category_id": 1, "bbox": [0, 0, 9, 9],
         "area": 81, "iscrowd": 0, "keypoints": [4, 4, 2],
         "segmentation": [[0, 0, 9, 0, 9, 9, 0, 9]]})
    coco["annotations"].append(
        {"id": 6, "image_id": 10, "category_id": 2, "bbox": [0, 0, 5, 5],
         "area": 25, "iscrowd": 1, "segmentation": [[0, 0, 5, 0, 5, 5]]})
    with open(path, "w") as fp:
        json.dump(coco, fp)
    got = coco_import.load_coco_json(path, "/data/coco", dataset_id=2)
    want = jax_coco.load_coco_json(path, "/data/coco", dataset_id=2)
    assert state_of(got) == state_of(want)
    boxes = [b for im in got.images for b in im.boxes]
    assert any(isinstance(b, PolygonAnnotation) and b.keypoints
               for b in boxes)
    for b in boxes:
        b.score = 0.25
    for b in (b for im in want.images for b in im.boxes):
        b.score = 0.25
    coco_import.export_coco_json(got, str(tmp_path / "port.json"))
    jax_coco.export_coco_json(want, str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    back = coco_import.load_coco_json(str(tmp_path / "port.json"), "/d")
    assert sorted(tuple(np.round(b.bounds, 3)) for im in back.images
                  for b in im.boxes) == sorted(
        tuple(np.round(b.bounds, 3)) for b in boxes)
