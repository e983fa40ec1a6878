"""Command-line interface of the port.

Counterpart of ``podtpu/cli.py``: the same nine commands with the same
option strings, short forms, defaults, types, choices and flags, parsed by
``argparse`` (one subparser per command) so that the CLI runs where click is
not installed.  An option that the JAX package's click declares with a
prompt is asked for with ``input()`` when it is absent.

Run as ``python -m podtpu_torch.cli <command> ...``; in Python,
``main(argv, device=...)``.  ``device`` goes to ``train``,
``evaluate_model``, ``infer``, ``infer_directory``, ``infer_tiled``,
``train_classifier``, ``classify_crops`` and ``serve``: None means the GPU,
and those raise when there is none.  There is no ``--device`` flag,
so the flag surface stays the JAX package's; ``export-model`` exports for
the device its ``--platforms`` names (``cuda`` by default, or ``cpu``).
The JAX package's group callback, which points XLA at a persistent
compilation cache, has no counterpart.

Every command runs.  The options that ``train()`` and ``infer_tiled`` do
not run yet (``--num-devices`` above 1, ``--spatial-devices`` above 1)
raise ``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import argparse
import dataclasses
import os.path
import sys
from pathlib import Path
from typing import Dict, List, Optional

from podtpu_torch.data.cvat.client import CvatTask
from podtpu_torch.data.project import Project
from podtpu_torch.shared.utils import now_as_str


def _load_tasks(tasks, server, wsl2, api, username, password,
                image_root=None) -> Project:
    project = Project()
    for task_id in tasks:
        task = CvatTask(server, task_id, is_wsl2=wsl2, api=api, debug=True,
                        username=username, password=password,
                        image_root=image_root)
        task.load()
        project.add_project(task.project)
    return project


def _read_labels(labels_path):
    from podtpu_torch.train.checkpoints import read_labels
    return read_labels(labels_path)


class _Command:
    """One subparser; ``opt`` adds an option as click declares it.  The
    subparser's ``prompts`` maps each prompted option's destination to the
    prompt that asks for it when it is absent."""

    def __init__(self, subparsers, name: str, help: str):
        self.parser = subparsers.add_parser(name, help=help,
                                            description=help)
        self.parser.prompts = {}

    def opt(self, *names, prompt: Optional[str] = None, flag: bool = False,
            **kwargs):
        if flag:
            action = self.parser.add_argument(*names, action="store_true",
                                              **kwargs)
        else:
            kwargs.setdefault("type", str)
            kwargs.setdefault("default", None)
            action = self.parser.add_argument(*names, **kwargs)
        if prompt is not None:
            self.parser.prompts[action.dest] = prompt
        return self


def _server_options(cmd: _Command) -> None:
    cmd.opt("--server", default="http://cvat:8080", help="CVAT server URL")
    cmd.opt("--username", default="admin", help="CVAT username")
    cmd.opt("--password", default="admin", help="CVAT password")
    cmd.opt("--image-root", help="Explicit image root (default: the CVAT "
            "container data path, like the reference)")


_BATCH_HELP = "Batch size for training (reduce if getting out-of-memory errors"
_WSL2_HELP = ("Running this on a windows machine using WSL2 instead of "
              "docker")
_API_HELP = "CVAT api version string, v1 or v2"
_MODEL_DIR_HELP = "Directory containing models"
_MODEL_HELP = "Name of folder containing model"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m podtpu_torch.cli",
        description="podtpu_torch: train and run detectors on one GPU.")
    sub = parser.add_subparsers(dest="command", metavar="COMMAND",
                                required=True)

    c = _Command(sub, "train-object-detector",
                 "Train an object detector on CVAT tasks")
    c.opt("-t", "--tasks", prompt="List of task ids to train on",
          help="List of task ids to train on separated by commas")
    c.opt("-l", "--labels",
          help="List of label names to train on separated by commas")
    c.opt("--merge-label", help="Merge the labels into a single label")
    c.opt("--batch-size", type=int, default=2, help=_BATCH_HELP)
    c.opt("--wsl2", flag=True, help=_WSL2_HELP)
    c.opt("--api", default="v1", help=_API_HELP)
    c.opt("-o", "--output-dir", default="/obj_det/models",
          help="Model output directory")
    c.opt("-m", "--model", help="Model name")
    c.opt("-d", "--data", default="/data", help="Data directory")
    c.opt("--max-epochs", type=int, default=100000,
          help="Maximum number of epochs")
    c.opt("--alrs-epochs", type=int, default=10,
          help="Number of epochs to monitor for alrs")
    c.opt("--optimiser", choices=["sgd", "adam", "adamw"], default="sgd",
          help="Optimiser to use (adamw = the vendored trainer's "
               "decoupled-weight-decay option)")
    c.opt("--lr", type=float,
          help="Learning rate override for the selected optimiser "
               "(defaults: sgd 0.005, the miso default, and adam/adamw "
               "0.001)")
    c.opt("--weight-decay", type=float,
          help="Weight decay override (default 5e-4, the miso SGD recipe; "
               "applies to sgd and adamw; plain adam carries no decay "
               "term, matching the reference)")
    c.opt("--lr-schedule", choices=["alrs", "multistep", "cosine"],
          default="alrs",
          help="LR schedule: adaptive early stopping (alrs, the miso "
               "default) or the vendored trainer's fixed-budget "
               "multistep/cosine schedules (run exactly --epochs epochs)")
    c.opt("--epochs", type=int, default=26,
          help="Epoch budget for --lr-schedule multistep/cosine (ignored "
               "by alrs)")
    c.opt("--lr-steps", default="16,22",
          help="Comma-separated milestone epochs for --lr-schedule "
               "multistep")
    c.opt("--lr-gamma", type=float, default=0.1,
          help="LR decay factor at each multistep milestone")
    c.opt("--norm-weight-decay", type=float,
          help="Separate weight decay for normalisation parameters "
               "(default: same as the global weight decay)")
    c.opt("--image-size", type=int, default=1024,
          help="Static training canvas size (square)")
    c.opt("--pretrained",
          help="Path to pretrained backbone weights (torchvision .pth or a "
               "model directory)")
    c.opt("--resume", flag=True,
          help="Resume from the last epoch checkpoint if present")
    c.opt("--with-mask", flag=True,
          help="Train a Mask R-CNN head on polygon annotations (rectangles "
               "train as filled boxes)")
    c.opt("--with-keypoints", flag=True,
          help="Train a Keypoint R-CNN head (annotations carry "
               "keypoint triples, e.g. CVAT points shapes grouped with "
               "their box)")
    c.opt("--num-keypoints", type=int, default=17,
          help="Keypoints per instance (COCO person skeleton = 17)")
    c.opt("--keypoint-hflip-inds",
          help="Comma-separated index permutation applied to keypoints "
               "under horizontal flip (left/right joint swap)")
    c.opt("--keypoint-roi-expand", type=float, default=1.0,
          help="Scale factor applied to detection boxes before the "
               "keypoint head's RoIAlign")
    c.opt("--num-devices", type=int,
          help="Data-parallel device count (one GPU: ROADMAP.md item 18)")
    c.opt("--backbone", choices=["resnet50_fpn", "mobilenet_v2",
                                 "mobilenet_v3_fpn", "mobilenet_v3_320_fpn"],
          help="Backbone: ResNet-50-FPN (default), MobileNetV2 (one "
               "stride-32 map), MobileNetV3-Large-FPN or its 320x320 recipe; "
               "from scratch a mobile trunk trains its BatchNorm")
    c.opt("--family", choices=["faster_rcnn", "faster_rcnn_v2", "retinanet",
                               "retinanet_v2", "fcos", "ssd", "ssdlite"],
          default="faster_rcnn",
          help="Detector family: faster_rcnn and faster_rcnn_v2 (the v2 "
               "recipe's heads), retinanet, retinanet_v2 and fcos (the "
               "one-stage families), ssd (SSD300-VGG16) and ssdlite "
               "(SSDLite320-MobileNetV3), each SSD on its own canvas")
    c.opt("--test-tasks",
          help="Comma-separated CVAT task ids held out for evaluation "
               "(default keeps the seeded 80/20 split)")
    c.opt("--test-only", flag=True,
          help="Skip training: evaluate the saved model named by --model "
               "on the given tasks and print the COCO stats")
    _server_options(c)

    c = _Command(sub, "infer-object-detector",
                 "Detect objects in CVAT tasks and upload them as shapes")
    c.opt("--tasks", prompt="List of task ids to infer on",
          help="List of task ids to infer on")
    c.opt("--model-dir", default="/obj_det/models", help=_MODEL_DIR_HELP)
    c.opt("--model", prompt=_MODEL_HELP, help=_MODEL_HELP)
    c.opt("--threshold", type=float, default=0.5, help="Detection threshold")
    c.opt("--batch-size", type=int, default=2, help=_BATCH_HELP)
    c.opt("--nv", flag=True, help="Append NV to the detected labels")
    c.opt("--wsl2", flag=True, help=_WSL2_HELP)
    c.opt("--api", default="v1", help=_API_HELP)
    _server_options(c)

    c = _Command(sub, "crop-objects",
                 "Crop the annotated objects of CVAT tasks by class")
    c.opt("--tasks", prompt="List of task ids to crop from",
          help="List of task ids to crop from")
    c.opt("-o", "--output-dir", default="/obj_det/crops",
          help="Crop output directory")
    c.opt("--wsl2", flag=True, help=_WSL2_HELP)
    c.opt("--api", default="v1", help=_API_HELP)
    _server_options(c)

    c = _Command(sub, "infer-object-detector-directory",
                 "Detect objects in a folder of images and crop them")
    c.opt("-i", "--input-dir",
          prompt="Name of folder containing images to infer on",
          help="Name of folder containing images to infer on")
    c.opt("-o", "--output-dir", prompt="Name of folder to store results",
          help="Name of folder to store results")
    c.opt("--model-dir", default="/obj_det/models", help=_MODEL_DIR_HELP)
    c.opt("--model", prompt=_MODEL_HELP, help=_MODEL_HELP)
    c.opt("--threshold", type=float, default=0.5, help="Detection threshold")
    c.opt("--batch-size", type=int, default=2, help=_BATCH_HELP)

    c = _Command(sub, "infer-object-detector-tiled",
                 "Sliding-window scan inference with cross-tile NMS")
    c.opt("-i", "--input", dest="input_path", prompt="Image file to scan",
          help="Large scan image to tile")
    c.opt("--model-dir", default="/obj_det/models", help=_MODEL_DIR_HELP)
    c.opt("--model", prompt=_MODEL_HELP, help=_MODEL_HELP)
    c.opt("--threshold", type=float, default=0.5, help="Detection threshold")
    c.opt("--overlap", type=float, default=0.25, help="Tile overlap fraction")
    c.opt("--batch-size", type=int, default=8)
    c.opt("--tile-size", type=int,
          help="Override the tile canvas (defaults to the model's training "
               "canvas)")
    c.opt("--spatial-devices", type=int, default=1,
          help="Shard each tile's height over N devices")
    c.opt("-o", "--output", help="Write detections as JSON to this path")

    c = _Command(sub, "train-crop-classifier",
                 "Train a classifier on class-sorted object crops")
    c.opt("-i", "--input-dir", prompt="Folder of class-sorted crops",
          help="Folder of class-sorted crops (crop-objects output)")
    c.opt("-o", "--output-dir", default="/obj_det/classifiers",
          help="Model output directory")
    c.opt("-m", "--model", help="Model name")
    c.opt("--batch-size", type=int, default=32)
    c.opt("--image-size", type=int, default=128)
    c.opt("--max-epochs", type=int, default=100000)
    c.opt("--alrs-epochs", type=int, default=10)

    c = _Command(sub, "classify-crops",
                 "Classify object crops with a trained crop classifier")
    c.opt("-i", "--input-dir", prompt="Folder of crops",
          help="Folder of crops to classify")
    c.opt("--model-dir", default="/obj_det/classifiers")
    c.opt("--model", prompt="Model folder name")
    c.opt("--batch-size", type=int, default=32)
    c.opt("-o", "--output",
          help="Write path->label JSON here instead of stdout")

    c = _Command(sub, "serve", "Serve a trained detector over HTTP (POST "
                 "/detect with image bytes; micro-batched inference)")
    c.opt("--model-dir", default="/obj_det/models", help=_MODEL_DIR_HELP)
    c.opt("--model", prompt=_MODEL_HELP, help=_MODEL_HELP)
    c.opt("--host", default="0.0.0.0")
    c.opt("--port", type=int, default=8500)
    c.opt("--batch-size", type=int, default=4,
          help="Micro-batch size for coalescing concurrent requests")
    c.opt("--exported", flag=True,
          help="Serve the model dir's exported artifact (model.pt2 from "
               "export-model) instead of the live model")

    c = _Command(sub, "export-model",
                 "Export the eval forward as a self-contained artifact "
                 "(weights embedded; replays without the model code)")
    c.opt("--model-dir", default="/obj_det/models", help=_MODEL_DIR_HELP)
    c.opt("--model", prompt=_MODEL_HELP, help=_MODEL_HELP)
    c.opt("--batch-size", type=int, default=1,
          help="Fixed batch size compiled into the artifact")
    c.opt("--platforms",
          help="The artifact's platform: cuda (default) or cpu; one per "
               "artifact")
    c.opt("-o", "--output",
          help="Artifact path (default: <model dir>/model.pt2)")
    return parser


def train_object_detector(a, parser, device):
    from podtpu_torch.core.config import Config
    from podtpu_torch.train import train as train_mod

    task_ids = [int(task.strip()) for task in a.tasks.split(",")]
    labels = a.labels
    if labels is not None:
        labels = [label.strip() for label in labels.split(",")]

    project = _load_tasks(task_ids, a.server, a.wsl2, a.api, a.username,
                          a.password, image_root=a.image_root)
    test_project = None
    if a.test_tasks and not a.test_only:
        test_ids = [int(t.strip()) for t in a.test_tasks.split(",")]
        test_project = _load_tasks(test_ids, a.server, a.wsl2, a.api,
                                   a.username, a.password,
                                   image_root=a.image_root)

    # --merge-label / --labels apply to training and to --test-only alike:
    # a model trained on merged labels must see the same renames when it
    # is evaluated.
    if a.merge_label is not None:
        for proj in [project] + ([test_project] if test_project else []):
            for label in list(proj.label_dict.values()):
                if labels and label.name in labels:
                    proj.rename_label(label.name, a.merge_label)
            proj.update_label_dict()
        labels = [a.merge_label]

    if a.test_only:
        if not a.model:
            parser.error("--test-only needs --model (the saved model's name "
                         "under --output-dir)")
        if labels is not None:
            project.keep_annotations_with_label(labels)
            project.update_label_dict()
        train_mod.evaluate_model(project, os.path.join(a.output_dir, a.model),
                                 batch_size=a.batch_size, device=device)
        return

    cfg = Config()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model,
                                       image_size=(a.image_size,
                                                   a.image_size)),
        train=dataclasses.replace(
            cfg.train, lr_schedule=a.lr_schedule, epochs=a.epochs,
            lr_steps=tuple(int(s.strip()) for s in a.lr_steps.split(",")),
            lr_gamma=a.lr_gamma, norm_weight_decay=a.norm_weight_decay))
    if a.lr is not None:
        # One flag steers whichever optimiser was selected.
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, lr=a.lr, adam_lr=a.lr))
    if a.weight_decay is not None:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, weight_decay=a.weight_decay))
    if a.keypoint_hflip_inds:
        inds = tuple(int(i) for i in a.keypoint_hflip_inds.split(","))
        if sorted(inds) != list(range(a.num_keypoints)):
            parser.error(
                f"--keypoint-hflip-inds must be a permutation of "
                f"0..{a.num_keypoints - 1} (got {len(inds)} values: "
                f"{a.keypoint_hflip_inds})")
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model,
                                           keypoint_hflip_inds=inds))
    if a.keypoint_roi_expand != 1.0:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(
                cfg.model, keypoint_roi_expand=a.keypoint_roi_expand))
    train_mod.train(project, labels,
                    output_dir=a.output_dir, name=a.model,
                    batch_size=a.batch_size, max_epochs=a.max_epochs,
                    alrs_epochs=a.alrs_epochs, optimiser=a.optimiser,
                    config=cfg, pretrained=a.pretrained, resume=a.resume,
                    with_mask=a.with_mask, with_keypoints=a.with_keypoints,
                    num_keypoints=a.num_keypoints,
                    num_devices=a.num_devices, backbone=a.backbone,
                    family=a.family, test_project=test_project,
                    device=device)


def infer_object_detector(a, parser, device):
    from podtpu_torch.infer import inference

    task_ids = [int(task) for task in a.tasks.split(",")]
    model_path = os.path.join(a.model_dir, a.model)
    labels = _read_labels(os.path.join(a.model_dir, a.model, "labels.txt"))
    for task_id in task_ids:
        task = CvatTask(a.server, task_id, is_wsl2=a.wsl2, api=a.api,
                        debug=True, username=a.username,
                        password=a.password, image_root=a.image_root)
        task.load()
        project = inference.infer(task.project, model_path, labels,
                                  a.threshold, a.batch_size, a.nv,
                                  device=device)
        project.summary()
        task.add_shapes(project)


def crop_objects(a, parser, device):
    from podtpu_torch.infer import crop

    task_ids = [int(task) for task in a.tasks.split(",")]
    output_dir = os.path.join(
        a.output_dir, now_as_str() + "_" + "_".join(str(t) for t in task_ids))
    for task_id in task_ids:
        task = CvatTask(a.server, task_id, is_wsl2=a.wsl2, api=a.api,
                        debug=True, username=a.username,
                        password=a.password, image_root=a.image_root)
        task.load()
        crop.crop_objects(task.project, output_dir)


def infer_object_detector_directory(a, parser, device):
    from podtpu_torch.infer import crop, inference

    model_path = os.path.join(a.model_dir, a.model)
    labels = _read_labels(os.path.join(a.model_dir, a.model, "labels.txt"))
    project = inference.infer_directory(a.input_dir, model_path, labels,
                                        a.threshold, a.batch_size,
                                        device=device)
    Path(a.output_dir).mkdir(parents=True, exist_ok=True)
    crop.crop_objects(project, a.output_dir, relative_to=a.input_dir)


def infer_object_detector_tiled(a, parser, device):
    from podtpu_torch.infer.tiled import infer_tiled

    model_path = os.path.join(a.model_dir, a.model)
    labels = _read_labels(os.path.join(a.model_dir, a.model, "labels.txt"))
    dets = infer_tiled(a.input_path, model_path, threshold=a.threshold,
                       overlap=a.overlap, batch_size=a.batch_size,
                       tile_size=a.tile_size,
                       spatial_devices=a.spatial_devices, device=device)
    rows = []
    for d in dets:
        row = {"box": d.box, "score": d.score,
               "label": labels[d.label - 1]}
        if d.polygon is not None:  # mask models: instance outline
            row["polygon"] = [[float(x), float(y)] for x, y in d.polygon]
        rows.append(row)
    _write_json(rows, a.output)
    print(f"{len(dets)} detections")


def train_crop_classifier(a, parser, device):
    from podtpu_torch.train.classify import train_classifier

    train_classifier(a.input_dir, output_dir=a.output_dir, name=a.model,
                     batch_size=a.batch_size, image_size=a.image_size,
                     max_epochs=a.max_epochs, alrs_epochs=a.alrs_epochs,
                     device=device)


def classify_crops(a, parser, device):
    from podtpu_torch.train.classify import classify_crops as classify_fn

    result = classify_fn(a.input_dir, os.path.join(a.model_dir, a.model),
                         batch_size=a.batch_size, device=device)
    _write_json(result, a.output)


def _write_json(value, output: Optional[str]) -> None:
    """``value`` as indented JSON to the file ``output``, or to stdout."""
    import json

    text = json.dumps(value, indent=2)
    if output:
        with open(output, "w") as fp:
            fp.write(text)
    else:
        print(text)


def serve(a, parser, device):
    from podtpu_torch.infer import server

    server.serve(os.path.join(a.model_dir, a.model), host=a.host,
                 port=a.port, batch_size=a.batch_size, exported=a.exported,
                 device=device)


def export_model(a, parser, device):
    from podtpu_torch.infer import export

    platforms = ([p.strip() for p in a.platforms.split(",") if p.strip()]
                 if a.platforms else None)
    path = export.export_model(os.path.join(a.model_dir, a.model),
                               batch_size=a.batch_size, platforms=platforms,
                               out_path=a.output)
    print(f"exported: {path}")


RUN = {"train-object-detector": train_object_detector,
       "infer-object-detector": infer_object_detector,
       "crop-objects": crop_objects,
       "infer-object-detector-directory": infer_object_detector_directory,
       "infer-object-detector-tiled": infer_object_detector_tiled,
       "train-crop-classifier": train_crop_classifier,
       "classify-crops": classify_crops,
       "serve": serve,
       "export-model": export_model}


def subparsers(parser: argparse.ArgumentParser
               ) -> Dict[str, argparse.ArgumentParser]:
    """Command name -> its subparser."""
    (action,) = [a for a in parser._actions
                 if isinstance(a, argparse._SubParsersAction)]
    return dict(action.choices)


def main(argv: Optional[List[str]] = None, *, device=None) -> int:
    """Parse ``argv`` (``sys.argv[1:]`` when None) and run the command.
    ``device``: where the models run, the GPU when None."""
    parser = build_parser()
    a = parser.parse_args(argv)
    sub = subparsers(parser)[a.command]
    for dest, prompt in sub.prompts.items():
        if getattr(a, dest) is None:
            setattr(a, dest, input(f"{prompt}: "))
    RUN[a.command](a, sub, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
