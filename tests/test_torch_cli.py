"""The port's CLI (``python -m podtpu_torch.cli``) against ``podtpu.cli``.

* Flags: every option of the nine click commands has its argparse
  counterpart with the same option strings, default, type, choices, flag
  and prompt.
* Dispatch: ``train``, ``evaluate_model``, ``infer``, ``infer_directory``,
  ``crop_objects``, ``serve`` and ``export_model`` of both packages are
  replaced by recorders, the same argv goes through click's ``CliRunner``
  and the port's ``main`` against one fake CVAT server
  (``tests/fake_cvat.py``), and the recorded calls must be equal (configs
  as ``dataclasses.asdict``, projects box by box), as must the PATCH
  bodies the upload sends; the invalid invocations are rejected by both.
* End to end on the CPU: the port alone trains at a 128 canvas for one
  epoch, uploads its detections with a PATCH, writes class-sorted crops and
  runs the directory command, as ``tests/test_cli_e2e.py`` does for JAX.
* The options the port does not run yet raise ``NotImplementedError``
  naming their ROADMAP.md items; the CLI imports neither click nor requests.
"""
import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

import click
import numpy as np
import pytest
from click.testing import CliRunner
from PIL import Image

import podtpu.cli as jax_cli
import podtpu.infer.crop as jax_crop
import podtpu.infer.export as jax_export
import podtpu.infer.inference as jax_inference
import podtpu.infer.server as jax_server
import podtpu.train.train as jax_train
import podtpu_torch.cli as port_cli
import podtpu_torch.infer.crop as port_crop
import podtpu_torch.infer.export as port_export
import podtpu_torch.infer.inference as port_inference
import podtpu_torch.infer.server as port_server
import podtpu_torch.train.train as port_train
from podtpu.data.project import Project as JaxProject
from podtpu_torch.data.project import Project
from tests.fake_cvat import FakeCvatServer, FakeCvatState
from tests.synthetic import draw_particle
from tests.test_torch_mask import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
LABELS = [{"id": 10, "name": "particle", "color": "#ff0000"},
          {"id": 11, "name": "bubble", "color": "#00ff00"}]


@pytest.fixture(scope="module")
def cvat_env(tmp_path_factory):
    """Task 5 (annotated), task 6 (the same frames, unlabelled), task 7
    (the first three frames, annotated), task 9 (those, unlabelled) and
    task 12 (the first five, annotated),
    images at ``<root>/7/raw`` and the first three also in ``<root>/few``,
    and a model directory holding a ``labels.txt``."""
    root = tmp_path_factory.mktemp("cli_cvat")
    raw = root / "7" / "raw"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(0)
    frames, shapes, sid = [], [], 1
    for i in range(8):
        img = rng.integers(10, 40, (160, 160, 3)).astype(np.uint8)
        for _ in range(int(rng.integers(1, 3))):
            bw, bh = int(rng.integers(28, 56)), int(rng.integers(28, 56))
            x = int(rng.integers(0, 160 - bw))
            y = int(rng.integers(0, 160 - bh))
            draw_particle(img, x, y, bw, bh, (235, 235, 245))
            shapes.append({"id": sid, "type": "rectangle", "frame": i,
                           "label_id": 10 + (sid % 3 == 0),
                           "points": [x, y, x + bw, y + bh],
                           "outside": False})
            sid += 1
        name = f"frame_{i:02d}.jpg"
        Image.fromarray(img).save(raw / name, quality=92)
        frames.append(name)
    state = FakeCvatState()
    state.add_task(5, "annotated_task", LABELS, frames, shapes=shapes)
    state.add_task(6, "unlabelled_task", LABELS, frames)
    state.add_task(7, "second_task", LABELS, frames[:3], shapes=[
        dict(s, id=100 + s["id"]) for s in shapes if s["frame"] < 3])
    state.add_task(9, "few_unlabelled", LABELS, frames[:3])
    state.add_task(12, "five_task", LABELS, frames[:5], shapes=[
        dict(s, id=200 + s["id"]) for s in shapes if s["frame"] < 5])
    few = root / "few"
    few.mkdir()
    for name in frames[:3]:
        (few / name).write_bytes((raw / name).read_bytes())
    models = root / "models" / "m"
    models.mkdir(parents=True)
    (models / "labels.txt").write_text("1,particle\n2,bubble\n")
    with FakeCvatServer(state) as server:
        yield dict(server=server, state=state, root=str(root),
                   raw=str(raw), few=str(few), models=str(root / "models"))


# -- flags --------------------------------------------------------------------

def click_type(param):
    if param.is_flag:
        return "bool"
    if isinstance(param.type, click.Choice):
        return "str"
    return {click.STRING: "str", click.INT: "int",
            click.FLOAT: "float"}[param.type]


def test_nine_commands():
    subs = port_cli.subparsers(port_cli.build_parser())
    assert sorted(subs) == sorted(jax_cli.cli.commands)
    assert len(subs) == 9


def click_default(param):
    """None for an option declared without a default (click 8.2 marks it
    with a sentinel)."""
    unset = getattr(click.core, "UNSET", None)
    return None if unset is not None and param.default is unset \
        else param.default


@pytest.mark.parametrize("name", sorted(jax_cli.cli.commands))
def test_flags(name):
    want = {}
    for p in jax_cli.cli.commands[name].params:
        want[p.name] = dict(
            opts=sorted(p.opts + p.secondary_opts),
            default=click_default(p),
            type=click_type(p),
            choices=list(p.type.choices)
            if isinstance(p.type, click.Choice) else None,
            prompt=p.prompt)
    sub = port_cli.subparsers(port_cli.build_parser())[name]
    got = {}
    for a in sub._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        flag = isinstance(a, argparse._StoreTrueAction)
        got[a.dest] = dict(
            opts=sorted(a.option_strings), default=a.default,
            type="bool" if flag else a.type.__name__,
            choices=list(a.choices) if a.choices else None,
            prompt=sub.prompts.get(a.dest))
    assert got == want


# -- dispatch -----------------------------------------------------------------

def project_view(p):
    return dict(
        labels=p.label_names, tasks=sorted(p.task_names.items()),
        images=[(k, str(im.path), str(im.container), im.dataset_id,
                 im.frame_id,
                 [(type(b).__name__, b.label, tuple(b.bounds), b.score)
                  for b in im.boxes])
                for k, im in p.image_dict.items()])


def view(value):
    if isinstance(value, (Project, JaxProject)):
        return project_view(value)
    if dataclasses.is_dataclass(value):
        return dataclasses.asdict(value)
    return value


@pytest.fixture
def recorders(monkeypatch):
    """Both packages' entry points replaced by recorders of their calls;
    ``infer`` returns the project it was given, so the upload sends its
    boxes.  Timestamps are fixed."""
    calls = {"jax": [], "port": []}

    def recorder(side, name, returns=None):
        def record(*args, **kwargs):
            calls[side].append((name, [view(a) for a in args],
                                {k: view(v) for k, v in kwargs.items()}))
            if returns == "artifact":
                return kwargs["out_path"] or f"{args[0]}/artifact"
            return args[0] if returns == "first" else returns
        return record

    for side, mods in (("jax", (jax_train, jax_inference, jax_crop,
                                jax_server, jax_export)),
                       ("port", (port_train, port_inference, port_crop,
                                 port_server, port_export))):
        train_mod, inference, crop, server, export = mods
        monkeypatch.setattr(train_mod, "train", recorder(side, "train"))
        monkeypatch.setattr(train_mod, "evaluate_model",
                            recorder(side, "evaluate_model"))
        monkeypatch.setattr(inference, "infer",
                            recorder(side, "infer", "first"))
        monkeypatch.setattr(inference, "infer_directory",
                            recorder(side, "infer_directory", Project()
                                     if side == "port" else JaxProject()))
        monkeypatch.setattr(crop, "crop_objects",
                            recorder(side, "crop_objects"))
        monkeypatch.setattr(server, "serve", recorder(side, "serve"))
        monkeypatch.setattr(export, "export_model",
                            recorder(side, "export_model", "artifact"))
    monkeypatch.setattr(jax_cli, "now_as_str", lambda: "NOW")
    monkeypatch.setattr(port_cli, "now_as_str", lambda: "NOW")
    return calls


def run_both(argv, calls, state, input=None, monkeypatch=None):
    """argv through click and through the port; returns (click result,
    port exit code, port output, the PATCH bodies each sent)."""
    before = len(state.patches)
    result = CliRunner().invoke(jax_cli.cli, argv, input=input)
    jax_patches = state.patches[before:]
    before = len(state.patches)
    code = 0
    if input is not None:
        answers = iter(input.splitlines())
        monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
    try:
        port_cli.main(argv, device="cpu")
    except SystemExit as exc:
        code = exc.code
    port_patches = state.patches[before:]
    for name, args, kwargs in calls["port"]:
        # An artifact's device is its platform, not the CLI's device.
        if name not in ("crop_objects", "export_model"):
            assert kwargs.pop("device") == "cpu", name
    return result, code, jax_patches, port_patches


def server_args(env):
    return ["--server", env["server"].url, "--image-root", env["root"]]


TRAIN_CASES = {
    "defaults": [],
    "labels_merge": ["--tasks", "5,7", "--labels", "particle, bubble",
                     "--merge-label", "thing"],
    "test_tasks": ["--test-tasks", "7", "--labels", "bubble",
                   "--merge-label", "b2"],
    "test_only": ["--test-only", "--labels", "particle", "--batch-size", "3"],
    "overrides": ["--optimiser", "adamw", "--lr", "0.01",
                  "--weight-decay", "0.001", "--image-size", "256",
                  "--max-epochs", "3", "--alrs-epochs", "2", "--resume",
                  "--pretrained", "/somewhere/w.pth"],
    "multistep": ["--lr-schedule", "multistep", "--lr-steps", "3, 5",
                  "--epochs", "6", "--lr-gamma", "0.5",
                  "--norm-weight-decay", "0"],
    "v2": ["--family", "faster_rcnn_v2"],
    "mobile_320": ["--backbone", "mobilenet_v3_320_fpn"],
    "ssd": ["--family", "ssd"],
    "ssdlite": ["--family", "ssdlite"],
    "v2_mask": ["--family", "faster_rcnn_v2", "--with-mask"],
    "keypoints": ["--with-keypoints", "--num-keypoints", "3",
                  "--keypoint-hflip-inds", "1,0,2",
                  "--keypoint-roi-expand", "1.3", "--num-devices", "2",
                  "--family", "faster_rcnn_v2", "--backbone",
                  "mobilenet_v2", "--with-mask", "--wsl2", "--api", "v2"],
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_dispatch(cvat_env, recorders, case, tmp_path):
    argv = ["train-object-detector", "-t", "5", *server_args(cvat_env),
            "-o", str(tmp_path), "-m", "m", *TRAIN_CASES[case]]
    result, code, jp, pp = run_both(argv, recorders, cvat_env["state"])
    assert result.exit_code == 0 and code == 0, result.output
    assert recorders["port"] == recorders["jax"]
    (name, args, kwargs), = recorders["port"]
    assert name == ("evaluate_model" if case == "test_only" else "train")
    assert jp == pp == []


def test_train_prompts_for_tasks(cvat_env, recorders, tmp_path,
                                 monkeypatch):
    argv = ["train-object-detector", *server_args(cvat_env), "-o",
            str(tmp_path)]
    result, code, _, _ = run_both(argv, recorders, cvat_env["state"],
                                  input="5\n", monkeypatch=monkeypatch)
    assert result.exit_code == 0 and code == 0, result.output
    assert recorders["port"] == recorders["jax"] and recorders["port"]


@pytest.mark.parametrize("bad, message", [
    (["--num-keypoints", "3", "--keypoint-hflip-inds", "0,1"],
     "--keypoint-hflip-inds must be a permutation of 0..2 (got 2 values: "
     "0,1)"),
    (["--test-only"], "--test-only needs --model"),
    (["--optimiser", "lbfgs"], "lbfgs"),
])
def test_train_rejects(cvat_env, recorders, tmp_path, capsys, bad, message):
    argv = ["train-object-detector", "-t", "5", *server_args(cvat_env),
            "-o", str(tmp_path), *bad]
    result, code, _, _ = run_both(argv, recorders, cvat_env["state"])
    assert result.exit_code == code == 2
    assert message in result.output
    assert message in capsys.readouterr().err
    assert recorders["port"] == recorders["jax"] == []


def test_infer_dispatch_and_upload(cvat_env, recorders):
    argv = ["infer-object-detector", "--tasks", "5,7",
            *server_args(cvat_env), "--model-dir", cvat_env["models"],
            "--model", "m", "--threshold", "0.3", "--batch-size", "3",
            "--nv"]
    result, code, jp, pp = run_both(argv, recorders, cvat_env["state"])
    assert result.exit_code == 0 and code == 0, result.output
    assert recorders["port"] == recorders["jax"]
    assert [c[0] for c in recorders["port"]] == ["infer", "infer"]
    assert len(pp) == 2 and pp == jp
    assert all("annotations?action=create" in p["path"] for p in pp)
    assert sum(len(p["body"]["shapes"]) for p in pp) > 0


@pytest.mark.parametrize("argv", [
    ["crop-objects", "--tasks", "5,7", "-o", "{tmp}/crops"],
    ["infer-object-detector-directory", "-i", "{raw}", "-o", "{tmp}/out",
     "--model-dir", "{models}", "--model", "m", "--threshold", "0.2",
     "--batch-size", "4"],
    ["serve", "--model-dir", "{models}", "--model", "m", "--host",
     "127.0.0.1", "--port", "9999", "--batch-size", "8"],
    ["serve", "--model-dir", "{models}", "--model", "m", "--exported"],
    ["export-model", "--model-dir", "{models}", "--model", "m"],
    ["export-model", "--model-dir", "{models}", "--model", "m",
     "--batch-size", "4", "--platforms", "cpu, cuda", "-o",
     "{tmp}/m.pt2"],
])
def test_other_dispatch(cvat_env, recorders, tmp_path, argv, capsys):
    argv = [a.format(tmp=tmp_path, raw=cvat_env["raw"],
                     models=cvat_env["models"]) for a in argv]
    if argv[0] == "crop-objects":
        argv += server_args(cvat_env)
    result, code, _, _ = run_both(argv, recorders, cvat_env["state"])
    assert result.exit_code == 0 and code == 0, result.output
    assert recorders["port"] == recorders["jax"] and recorders["port"]
    if argv[0] == "export-model":
        (_, args, kwargs), = recorders["port"]
        path = kwargs["out_path"] or f"{args[0]}/artifact"
        assert f"exported: {path}" in result.output
        assert f"exported: {path}" in capsys.readouterr().out


# -- stubs and imports --------------------------------------------------------

@pytest.mark.parametrize("argv, item", [
    (["infer-object-detector-tiled", "-i", "scan.tif", "--model-dir",
      "{models}", "--model", "m", "--spatial-devices", "2"], "item 20"),
    (["train-object-detector", "-t", "5", "--num-devices", "2"], "item 18"),
])
def test_unported_raise(cvat_env, tmp_path, argv, item):
    argv = [a.format(models=cvat_env["models"]) for a in argv]
    if argv[0] == "train-object-detector":
        argv += [*server_args(cvat_env), "-o", str(tmp_path)]
    with pytest.raises(NotImplementedError, match=item):
        port_cli.main(argv, device="cpu")


def test_help_imports_no_click_or_requests():
    code = (
        "import runpy, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "sys.argv = ['podtpu_torch.cli', '--help']\n"
        "try:\n"
        "    runpy.run_module('podtpu_torch.cli', run_name='__main__',"
        " alter_sys=True)\n"
        "except SystemExit as exc:\n"
        "    assert exc.code == 0, exc.code\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'click', 'requests', 'jax', 'podtpu', 'PIL', 'lxml'}))\n")
    out = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for name in jax_cli.cli.commands:
        assert name in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "[]"


# -- end to end on the CPU ----------------------------------------------------

def test_journey_on_cpu(cvat_env, tmp_path):
    """train-object-detector -> infer-object-detector (PATCH upload) ->
    crop-objects -> infer-object-detector-directory, the port alone."""
    env, state = cvat_env, cvat_env["state"]
    out = tmp_path / "models"
    port_cli.main(["train-object-detector", "--tasks", "12",
                   *server_args(env), "--image-size", "128",
                   "--batch-size", "2", "--max-epochs", "1",
                   "--alrs-epochs", "2", "-o", str(out), "-m", "cli_model"],
                  device="cpu")
    model_dir = out / "cli_model"
    for f in ("model.msgpack", "config.json", "labels.txt", "results.txt"):
        assert (model_dir / f).exists(), f
    assert (model_dir / "labels.txt").read_text() == \
        "1,particle\n2,bubble\n"

    before = len(state.patches)
    port_cli.main(["infer-object-detector", "--tasks", "9",
                   *server_args(env), "--model-dir", str(out), "--model",
                   "cli_model", "--threshold", "0.0", "--batch-size", "4"],
                  device="cpu")
    uploads = [p for p in state.patches[before:]
               if "annotations?action=create" in p["path"]]
    assert len(uploads) == 1
    shapes = uploads[0]["body"]["shapes"]
    assert uploads[0]["body"]["version"] == 0 and shapes
    for s in shapes:
        assert s["type"] == "rectangle" and s["label_id"] in (10, 11)
        assert len(s["points"]) == 4
        assert all(isinstance(v, int) for v in s["points"])

    port_cli.main(["crop-objects", "--tasks", "5", *server_args(env),
                   "-o", str(tmp_path / "crops")], device="cpu")
    crops = list((tmp_path / "crops").rglob("*.jpg"))
    assert crops
    for p in crops:  # .../<time>_5/5 - annotated_task/<label>/<crop>
        assert p.parent.parent.name == "5 - annotated_task"
        assert p.parent.name in ("particle", "bubble")

    port_cli.main(["infer-object-detector-directory", "-i", env["few"],
                   "-o", str(tmp_path / "dir_out"), "--model-dir", str(out),
                   "--model", "cli_model", "--threshold", "0.0"],
                  device="cpu")
    dir_crops = list((tmp_path / "dir_out").rglob("*.jpg"))
    assert dir_crops and all(p.parent.name in ("particle", "bubble")
                             for p in dir_crops)
