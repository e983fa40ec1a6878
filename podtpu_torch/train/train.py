"""Training driver: project in, trained model directory out.

Counterpart of ``podtpu/train/train.py`` (``ZeroMapMonitor``, ``train``,
``evaluate_model``), with the reference's contract
(`miso/object_detection/training.py:16-160`): deep-copy the project, filter
to the requested labels, drop unlabelled images; a seeded 80/20 split;
SGD or Adam; an epoch loop of train, evaluate and ALRS step that stops
after the LR drops; and the artifacts (model directory, ``labels.txt``,
``results.txt``) in ``output_dir/<name or timestamp>``.  Per-epoch resume
checkpoints and the NaN guard are the JAX package's additions, kept.

As in the JAX package, a dataset that fits the device budget is held on
the device (``DataConfig.device_data_cache``: "auto" and
:func:`~podtpu_torch.data.device_cache.fits`, True, or False), each step
gathers its batch there (``TrainConfig.cache_gather``), and full groups of
``TrainConfig.steps_per_dispatch`` steps run as one dispatch: on the GPU
one CUDA graph replay (:class:`~podtpu_torch.data.device_cache.
CachedMultiStep`), on the CPU a loop of the same steps; the tail of an
epoch runs single steps.  A dataset past the budget streams through the
windowed device cache, one step at a time; ``device_data_cache=False``
streams batches from the host through :class:`Loader`.  The batches come
in the order of :class:`Loader` on every path.  Each epoch's random draws
come from a ``torch.Generator`` on the model's device seeded from ``(seed,
epoch)``, drawn in step order (a group's before its replay), so a resumed
run draws what the straight run drew; ``draws`` replaces them with the
caller's.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import sys
from typing import Callable, List, Optional

import numpy as np
import torch

from podtpu_torch.core.config import (COCO_17_HFLIP_INDS, Config,
                                      fasterrcnn_v2_config, fcos_config,
                                      model_config_from_dict,
                                      retinanet_config, retinanet_v2_config)
from podtpu_torch.core.logging import MetricLogger, is_main_process
from podtpu_torch.core.profiling import start_trace, stop_trace
from podtpu_torch.data.dataset import DetectionDataset, train_test_split
from podtpu_torch.data.device_cache import (DeviceDataCache, DeviceLoader,
                                            WindowedStreamLoader,
                                            dataset_device_bytes, fits,
                                            gather_rows,
                                            make_cached_multi_step,
                                            make_cached_train_step,
                                            to_device)
from podtpu_torch.data.loader import Loader
from podtpu_torch.data.project import Project
from podtpu_torch.infer.inference import load_inference_model, resolve_device
from podtpu_torch.models.detector import init_parameters, make_detector
from podtpu_torch.models.weights import load_pretrained
from podtpu_torch.shared.utils import now_as_str
from podtpu_torch.train import checkpoints as ckpt
from podtpu_torch.train.calibrate import (calibrate_frozen_stats,
                                          needs_calibration)
from podtpu_torch.train.coco_metrics import STAT_NAMES
from podtpu_torch.train.evaluate import evaluate
from podtpu_torch.train.optim import make_optimizer
from podtpu_torch.train.schedules import make_scheduler
from podtpu_torch.train.step import (TrainDraws, draw_train, make_train_step,
                                     warmup_factor)


class ZeroMapMonitor:
    """Total-failure detection: consecutive epochs of eval mAP 0.000.

    ALRS sees only the loss, so a model whose loss plateaus at garbage
    walks through the LR drops and stops "as if converged".  After
    ``warn_epochs`` consecutive zero-mAP evals a diagnostic prints each
    epoch, and with ``abort=True`` (``TrainConfig.abort_on_zero_map``) the
    run stops.
    """

    def __init__(self, warn_epochs: int = 5, abort: bool = False):
        self.warn_epochs = max(1, int(warn_epochs))
        self.abort = abort
        self.zero_epochs = 0

    def update(self, epoch: int, map_value: float,
               ar_value: float = float("nan")) -> bool:
        """Record one epoch's eval mAP (and AR, for the diagnostic).
        Returns True when the run should abort."""
        if map_value > 0.0:
            self.zero_epochs = 0
            return False
        self.zero_epochs += 1
        if self.zero_epochs < self.warn_epochs:
            return False
        print("!" * 78)
        print(f"WARNING: eval mAP has been 0.000 for {self.zero_epochs} "
              f"consecutive epochs (epoch {epoch}, AR={ar_value:.3f}) — "
              "the model is detecting NOTHING while the loss-driven ALRS "
              "schedule proceeds as if converging.")
        print("Likely causes: a from-scratch recipe mismatch (this "
              "family may need a higher lr / longer budget — see the "
              "PARITY.md family table), missing pretrained weights, or "
              "anchors that cannot cover the object scale "
              "(tools/probe_mobilenet_v2.py quantifies coverage).")
        if self.abort:
            print("Aborting (TrainConfig.abort_on_zero_map=True).")
            print("!" * 78)
            return True
        print("Set TrainConfig.abort_on_zero_map=True to stop such runs "
              "automatically; raise zero_map_warn_epochs if this recipe "
              "is expected to start slowly.")
        print("!" * 78)
        return False


def _dispatch_groups(loader, k: int):
    """Group a loader's ``(batch, bvalid)`` stream into full groups of
    ``k`` (one dispatch each) plus single-item tail groups (a padded step
    would not be a no-op: weight decay and momentum apply even at zero loss
    weight)."""
    buf = []
    for item in loader:
        buf.append(item)
        if len(buf) == k:
            yield buf
            buf = []
    for item in buf:
        yield [item]


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The generator of one epoch's draws on ``device``, seeded from
    ``(seed, epoch)``."""
    state = np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


# Families whose backbone is fixed (``podtpu/core/config.py``).
_TIED_BACKBONE = {"ssd": "vgg16", "ssdlite": "mobilenet_v3"}


def _check_request(model_cfg, family, backbone, with_mask, with_keypoints,
                   num_devices) -> None:
    """The JAX package's ``ValueError``s for invalid combinations, then a
    ``NotImplementedError`` naming the ROADMAP.md item for what the port
    does not train yet."""
    fam = {"faster_rcnn_v2": "faster_rcnn",
           "retinanet_v2": "retinanet"}.get(family, family) \
        or model_cfg.family
    mask = with_mask or model_cfg.with_mask
    kps = with_keypoints or model_cfg.with_keypoints
    if fam in _TIED_BACKBONE:
        tied = model_cfg.backbone if model_cfg.family == fam \
            else _TIED_BACKBONE[fam]
        if backbone is not None and backbone != tied:
            raise ValueError(
                f"family={fam!r} is tied to its backbone ({tied}); "
                "--backbone is not applicable")
        if mask:
            raise ValueError("with_mask requires family='faster_rcnn' (SSD "
                             "has no RoI stage)")
    if fam in ("retinanet", "fcos"):
        if (backbone not in (None, "resnet50_fpn")
                or model_cfg.backbone != "resnet50_fpn"):
            raise ValueError(
                f"family={fam!r} requires the ResNet-50-FPN backbone (its "
                "P3-P7 pyramid head doesn't fit other backbone layouts)")
        if mask:
            raise ValueError(
                "with_mask requires family='faster_rcnn' (the Mask R-CNN "
                f"head pools RoIs; {fam} has no RoI stage)")
    if kps and fam != "faster_rcnn":
        raise ValueError(
            "with_keypoints requires family='faster_rcnn' (the keypoint "
            "head pools RoIs — torchvision keypointrcnn_resnet50_fpn)")
    if mask and kps:
        raise ValueError(
            "with_mask and with_keypoints are mutually exclusive (the "
            "torchvision zoo has no combined model)")
    net = backbone or model_cfg.backbone
    v2 = (family == "faster_rcnn_v2" or model_cfg.rpn_conv_depth != 1
          or model_cfg.box_head_type != "mlp" or model_cfg.fpn_norm)
    if fam == "faster_rcnn" and v2 and net != "resnet50_fpn":
        raise ValueError(
            "family='faster_rcnn_v2' requires the ResNet-50-FPN backbone "
            "(torchvision has no v2 recipe for the mobilenet extractors)")
    missing = None
    if fam in _TIED_BACKBONE:
        missing = f"family={fam!r} (item 14: SSD and the mobile trunks)"
    elif fam not in ("faster_rcnn", "retinanet", "fcos"):
        missing = f"family={fam!r}"
    elif net != "resnet50_fpn":
        missing = f"backbone={net!r} (item 14: the mobile trunks)"
    elif num_devices is not None and num_devices > 1:
        missing = f"num_devices={num_devices} (item 18: data parallelism)"
    if missing is not None:
        raise NotImplementedError(
            f"podtpu_torch does not train {missing} yet (ROADMAP.md)")


def train(project: Project,
          labels: Optional[List[str]] = None,
          output_dir: Optional[str] = None,
          name: Optional[str] = None,
          batch_size: int = 2,
          alrs_epochs: int = 10,
          alrs_drops: int = 4,
          alrs_startup_factor: int = 2,
          optimiser: str = "sgd",
          max_epochs: int = 500,
          config: Optional[Config] = None,
          pretrained: Optional[str] = None,
          resume: bool = False,
          seed: int = 0,
          num_workers: int = 4,
          with_mask: bool = False,
          with_keypoints: bool = False,
          num_keypoints: int = 17,
          num_devices: Optional[int] = None,
          backbone: Optional[str] = None,
          family: Optional[str] = None,
          test_project: Optional[Project] = None,
          device=None,
          draws: Optional[Callable[[int, int, dict], TrainDraws]] = None
          ) -> str:
    """Train a detector on ``project``; returns the model directory path.

    The arguments are those of ``podtpu.train.train.train``; ``batch_size``
    is per device, and one device is all the port has (``num_devices`` 1 or
    None).  ``test_project``: an optional held-out evaluation set; when
    given, all of ``project`` trains.  ``device``: where to train, the GPU
    when None (raises when there is none).  ``draws``: optional
    ``(epoch, step_in_epoch, batch) -> TrainDraws``, every random number of
    each step, in place of the epoch generator's.
    """
    dev = resolve_device(device)
    # -- project fix-up (reference training.py:27-32) -------------------------
    project = copy.deepcopy(project)
    if labels is not None:
        project.keep_annotations_with_label(labels)
    project.remove_unlabelled_images()
    project.update_label_dict()
    labels = project.label_names
    if not project.image_dict or not labels:
        raise ValueError(
            "Project has no annotated images (check --image-root / task "
            "ids / label filters)")

    cfg = config or Config()
    model_cfg = cfg.model
    _check_request(model_cfg, family, backbone, with_mask, with_keypoints,
                   num_devices)
    if family == "faster_rcnn_v2":
        # The v2 recipe's heads; the stored family stays 'faster_rcnn' (the
        # v2 fields rebuild the model from config.json).
        model_cfg = fasterrcnn_v2_config(model_cfg)
    elif family == "retinanet_v2":
        # GroupNorm subnets, GIoU, P6 from C5; stored as 'retinanet'.
        model_cfg = retinanet_v2_config(model_cfg)
    elif family == "retinanet" and model_cfg.family != "retinanet":
        model_cfg = retinanet_config(model_cfg)
    elif family == "fcos" and model_cfg.family != "fcos":
        model_cfg = fcos_config(model_cfg)

    print()
    print("=" * 80)
    if output_dir is None:
        output_dir = os.getcwd()
    if name is None:
        name = now_as_str()
    output_dir = os.path.join(output_dir, name)

    # A resumed run rebuilds the exact architecture the checkpoint was
    # trained with, not one re-derived from this call's arguments.
    restored = ckpt.load_train_checkpoint(output_dir) if resume else None
    resumed_model_cfg = False
    if restored is not None and "model_cfg" in restored:
        model_cfg = model_config_from_dict(restored["model_cfg"])
        resumed_model_cfg = True
        print("Resuming: model config restored from the checkpoint")
    elif (pretrained is None and restored is None
            and model_cfg.trainable_backbone_stages == 3):
        # torchvision's `_validate_trainable_layers`: the 3-stage freeze
        # protects pretrained features; frozen random features would stall
        # training.
        model_cfg = dataclasses.replace(model_cfg,
                                        trainable_backbone_stages=5)
        print("No pretrained weights: training all backbone stages "
              "(freezing random features would stall learning)")
    if pretrained and os.path.isdir(pretrained) and not resumed_model_cfg:
        # Fine-tuning from a model directory adopts its backbone_norm.
        pcfg_path = os.path.join(pretrained, "config.json")
        if os.path.exists(pcfg_path):
            with open(pcfg_path) as fp:
                stored_norm = json.load(fp).get("model", {}).get(
                    "backbone_norm", "frozen")
            if stored_norm != model_cfg.backbone_norm:
                model_cfg = dataclasses.replace(model_cfg,
                                                backbone_norm=stored_norm)
                print(f"Pretrained model uses backbone_norm="
                      f"{stored_norm}; matching it")
    train_cfg = dataclasses.replace(
        cfg.train, batch_size=batch_size, optimiser=optimiser,
        alrs_epochs=alrs_epochs, alrs_drops=alrs_drops,
        alrs_startup_factor=alrs_startup_factor, max_epochs=max_epochs)
    if not resumed_model_cfg:
        model_cfg = dataclasses.replace(
            model_cfg, num_classes=len(labels) + 1,
            with_mask=with_mask or cfg.model.with_mask,
            with_keypoints=with_keypoints or cfg.model.with_keypoints,
            num_keypoints=(num_keypoints if with_keypoints
                           else cfg.model.num_keypoints))
    cfg = dataclasses.replace(cfg, train=train_cfg, model=model_cfg)
    if cfg.model.with_keypoints and cfg.model.num_keypoints == 17 \
            and not cfg.model.keypoint_hflip_inds and not resumed_model_cfg:
        # COCO person-17: horizontal flips must swap left and right joints.
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, keypoint_hflip_inds=COCO_17_HFLIP_INDS))
    print("Object detector training (podtpu_torch)")
    print(f"- output directory: {output_dir}")
    project.summary()

    # -- data ---------------------------------------------------------------
    def make_ds(p):
        return DetectionDataset(p, image_size=cfg.model.image_size,
                                max_gt=cfg.model.max_gt_boxes,
                                label_names=labels,
                                with_masks=cfg.model.with_mask,
                                mask_stride=cfg.model.mask_gt_stride,
                                with_keypoints=cfg.model.with_keypoints,
                                num_keypoints=cfg.model.num_keypoints,
                                cache=cfg.data.decode_cache)

    dataset = make_ds(project)
    if test_project is not None:
        tp = copy.deepcopy(test_project)
        tp.keep_annotations_with_label(labels)
        tp.remove_unlabelled_images()
        test_dataset = make_ds(tp)
        if len(test_dataset) == 0:
            raise ValueError("test_project has no annotated images with the "
                             "requested labels")
        train_idx = np.arange(len(dataset))
        test_idx = np.arange(len(test_dataset))
    else:
        test_dataset = dataset
        train_idx, test_idx = train_test_split(
            len(dataset), cfg.train.split_fraction, cfg.train.split_seed)
    print("Training set images")
    print(f"- total: {len(dataset)}")
    print(f"- train: {len(train_idx)}")
    print(f"- test:  {len(test_idx)}"
          + (" (held-out tasks)" if test_project is not None else ""))

    # Device-resident training data: a dataset within the budget is held on
    # the device once and each step gathers its batch there; past the budget
    # it streams through the windowed cache; device_data_cache=False
    # streams batches from the host.
    use_device_cache = (cfg.data.device_data_cache is not False
                        and (cfg.data.device_data_cache is True
                             or fits(dataset)))
    use_window_stream = (not use_device_cache
                         and cfg.data.device_data_cache is not False)
    cache = None
    if use_device_cache:
        cache = DeviceDataCache(dataset, device=dev)
        loader_train = DeviceLoader(cache, batch_size, indices=train_idx,
                                    shuffle=True, seed=seed, raw=True)
        total_mib = dataset_device_bytes(
            len(dataset), cfg.model.image_size, cfg.model.max_gt_boxes,
            cfg.model.with_mask, cfg.model.mask_gt_stride) >> 20
        print(f"Training data pinned on device ({total_mib} MiB)")
    elif use_window_stream:
        loader_train = WindowedStreamLoader(dataset, batch_size,
                                            indices=train_idx, shuffle=True,
                                            seed=seed, device=dev)
        print(f"Streaming via windowed device cache "
              f"({loader_train.window} samples/window, double-buffered)")
    else:
        # With device_prefetch the loader's thread copies each batch to
        # the device on a side stream, overlapping the previous step.
        loader_train = Loader(dataset, batch_size, indices=train_idx,
                              shuffle=True, seed=seed,
                              num_workers=num_workers,
                              place=dev if cfg.data.device_prefetch
                              else None)
    loader_test = Loader(test_dataset, batch_size, indices=test_idx,
                         shuffle=False, num_workers=num_workers)

    # -- model + optimiser ----------------------------------------------------
    num_classes = len(labels) + 1
    print(f"Number of classes: {num_classes}")
    print(f"Optimiser: {cfg.train.optimiser}")
    model = make_detector(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(seed))
    if pretrained:
        load_pretrained(model, pretrained)
    model = model.to(dev, memory_format=torch.channels_last)
    if not pretrained and restored is None \
            and cfg.train.calibrate_bn is not False \
            and cfg.model.backbone_norm != "batch":
        # From scratch: set the FrozenBN statistics from one real batch
        # when the feature taps vanish ("auto") or always (True).
        sample = dataset.load_batch(
            [int(i) for i in train_idx[: max(2, min(8, batch_size))]])
        images = np.stack([s.image for s in sample])
        if cfg.train.calibrate_bn is True \
                or needs_calibration(model, images):
            calibrate_frozen_stats(model, images)
            print("FrozenBN statistics calibrated on a sample batch "
                  "(from-scratch run: feature taps were vanishing)")

    optimizer = make_optimizer(cfg.train, model)
    base_lr = cfg.train.adam_lr if optimiser in ("adam", "adamw") \
        else cfg.train.lr
    sched = make_scheduler(cfg.train, base_lr)

    start_epoch = 0
    steps_done = 0
    if restored is not None:
        model.load_state_dict(restored["model"])
        optimizer.load_state_dict(restored["optimizer"])
        steps_done = int(restored["step"])
        sched.load_state_dict(restored["alrs"])
        start_epoch = restored["epoch"] + 1
        print(f"Resumed from epoch {restored['epoch']}")
    train_step = make_train_step(model, optimizer, cfg, device=dev)
    cached_step = multi_step = None
    if use_device_cache or use_window_stream:
        # The gather from the device-resident arrays (the pinned dataset or
        # the stream's current window) inside the step.
        cached_step = make_cached_train_step(train_step,
                                             gather=cfg.train.cache_gather)
    if use_device_cache and cfg.train.steps_per_dispatch > 1:
        # Full groups: K steps in one dispatch, a CUDA graph replay on the
        # GPU.  Tail steps run singly.
        multi_step = make_cached_multi_step(
            train_step, cfg.train.steps_per_dispatch,
            gather=cfg.train.cache_gather)
    # The shape of a batch's gt slots, all that drawing a step needs.
    gt_shape = {"boxes": torch.empty((batch_size, cfg.model.max_gt_boxes, 4),
                                     device="meta")}

    def step_batch(idx, bvalid):
        """A cached step's batch as the step sees it (for ``draws``)."""
        arrays = cache.arrays if use_device_cache else loader_train.arrays
        out = gather_rows(arrays, to_device(idx, dev, torch.int64),
                          cfg.train.cache_gather)
        out["image_weight"] = torch.from_numpy(bvalid.astype(np.float32))
        return out

    def eval_forward(images):
        with torch.inference_mode():
            return model(torch.as_tensor(images).to(dev))

    # -- epoch loop (reference training.py:120-127) ---------------------------
    print("=" * 80)
    # Optional profiler trace of dispatches 3 to 6 of the first epoch.
    trace_dir = os.environ.get("PODTPU_TRACE_DIR")
    prof = None
    epoch = start_epoch
    stats = None
    final_eval = None
    zero_monitor = ZeroMapMonitor(cfg.train.zero_map_warn_epochs,
                                  cfg.train.abort_on_zero_map)
    for epoch in range(start_epoch, max_epochs):
        if sched.exhausted(epoch):
            # A resumed run whose budget is already spent trains no further
            # epoch instead of overwriting the final model.
            print(f"Schedule budget already spent at epoch {epoch}; "
                  "not training further")
            break
        loader_train.set_epoch(epoch)
        logger = MetricLogger()
        iters = len(loader_train)
        gen = epoch_generator(seed, epoch, dev) if draws is None else None
        k_dispatch = cfg.train.steps_per_dispatch if multi_step is not None \
            else 1
        n_dispatch = iters // k_dispatch + iters % k_dispatch
        trace_from = min(3, n_dispatch - 1)
        loss_sum = None  # on the device; read at log dispatches and the end
        bi = 0  # the step within the epoch (warmup, draws)
        for it, group in enumerate(
                logger.log_every(_dispatch_groups(loader_train, k_dispatch),
                                 cfg.train.log_every,
                                 header=f"Epoch: [{epoch}]",
                                 total=n_dispatch)):
            if trace_dir and epoch == start_epoch and it == trace_from:
                prof = start_trace(dev)
            lrs = [sched.lr_for(epoch)
                   * warmup_factor(cfg, epoch, bi + j, iters)
                   for j in range(len(group))]
            if len(group) > 1:
                # A full group: K steps in one dispatch, each with its own
                # lr and draws, drawn here in step order.
                step_draws = [
                    draws(epoch, bi + j, step_batch(*item)) if draws
                    is not None else draw_train(gen, cfg, gt_shape)
                    for j, item in enumerate(group)]
                metrics = multi_step(
                    cache.arrays, np.stack([b for b, _ in group]),
                    np.stack([v.astype(np.float32) for _, v in group]),
                    np.asarray(lrs, np.float32), step_draws)
                group_loss = metrics["loss"].sum()
                metrics = {k: v[-1] for k, v in metrics.items()}
            elif cached_step is not None:
                # `batch` is the [B] index vector; the step gathers from
                # the pinned dataset or the stream's current window.
                batch, bvalid = group[0]
                arrays = cache.arrays if use_device_cache \
                    else loader_train.arrays
                metrics = cached_step(
                    arrays, batch, bvalid.astype(np.float32), lrs[0],
                    generator=gen,
                    draws=None if draws is None
                    else draws(epoch, bi, step_batch(batch, bvalid)))
                group_loss = metrics["loss"]
            else:
                batch, bvalid = group[0]
                batch = dict(batch)
                batch["image_weight"] = torch.from_numpy(
                    bvalid.astype(np.float32))
                metrics = train_step(
                    batch, lrs[0], generator=gen,
                    draws=None if draws is None else draws(epoch, bi, batch))
                group_loss = metrics["loss"]
            bi += len(group)
            steps_done += len(group)
            loss_sum = group_loss if loss_sum is None \
                else loss_sum + group_loss
            if prof is not None and it >= trace_from + 3:
                stop_trace(prof, trace_dir)
                prof = None
            if it % cfg.train.log_every == 0 or it == n_dispatch - 1:
                host = {k: float(v) for k, v in metrics.items()}
                if cfg.train.nan_is_fatal and not np.isfinite(host["loss"]):
                    print(f"Loss is {host['loss']}, stopping training")
                    print({k: v for k, v in host.items() if k != "lr"})
                    sys.exit(1)
                logger.update(**host)
        if prof is not None:
            stop_trace(prof, trace_dir)
            prof = None
        epoch_loss = float(loss_sum) / iters if loss_sum is not None else 0.0
        if cfg.train.nan_is_fatal and not np.isfinite(epoch_loss):
            print(f"Epoch loss is {epoch_loss}, stopping training")
            sys.exit(1)
        # The per-epoch evaluation is the final evaluation for the last
        # epoch.
        final_eval, stats = evaluate(eval_forward, loader_test,
                                     num_classes=len(labels))
        abort = zero_monitor.update(epoch, float(stats[0]), float(stats[8]))
        # ALRS steps before the checkpoint, so a resumed scheduler has this
        # epoch's loss in its buffer.
        should_stop = sched.step(epoch, epoch_loss)
        ckpt.save_train_checkpoint(output_dir, model, optimizer, steps_done,
                                   epoch, sched.state_dict(),
                                   model_cfg=cfg.model)
        if should_stop or abort:
            break

    print("-" * 80)
    print(f"Training finished, {epoch + 1} epochs")
    if stats is None:
        # No epoch ran (resume of a finished run): evaluate once so the
        # artifacts still reflect the restored model.
        final_eval, stats = evaluate(eval_forward, loader_test,
                                     num_classes=len(labels))
    print("=" * 80)

    # -- artifacts (reference training.py:135-160) ----------------------------
    if is_main_process():
        os.makedirs(output_dir, exist_ok=True)
        ckpt.save_model(output_dir, model, cfg.model, labels)
        _save_aux_results(output_dir, final_eval, stats, labels)
    return output_dir


def _save_aux_results(output_dir, final_eval, stats, labels):
    ckpt.save_labels(output_dir, labels)
    ckpt.save_results(output_dir, stats, STAT_NAMES)
    if getattr(final_eval, "segm_stats", None) is not None:
        ckpt.save_results(output_dir, final_eval.segm_stats, STAT_NAMES,
                          filename="results_segm.txt")
    if getattr(final_eval, "keypoints_stats", None) is not None:
        ckpt.save_results(output_dir, final_eval.keypoints_stats,
                          STAT_NAMES, filename="results_keypoints.txt")
    if len(labels) > 1:
        # Per-class breakdown (beyond the reference's class-averaged
        # stats).
        per_class = final_eval.per_class_text(labels)
        with open(os.path.join(output_dir, "results_per_class.txt"),
                  "w") as f:
            f.write(per_class + "\n")
        print(per_class)


def evaluate_model(project: Project,
                   model_dir: str,
                   batch_size: int = 2,
                   num_workers: int = 4,
                   output_dir: Optional[str] = None,
                   device=None):
    """Evaluate a saved model on ``project`` without training (the vendored
    trainer's ``--test-only``); returns the 12 bbox COCO stats (a mask
    model's segm stats and a keypoint model's keypoints stats are printed,
    and written with the others).  Every
    annotated image of ``project`` is scored; with ``output_dir`` the
    results files are written there in the training artifacts' format.
    ``device``: the GPU when None (raises when there is none)."""
    forward, _, model_cfg, labels = load_inference_model(model_dir, device)
    project = copy.deepcopy(project)
    project.keep_annotations_with_label(labels)
    project.remove_unlabelled_images()
    project.update_label_dict()
    if not project.image_dict:
        raise ValueError("Project has no annotated images with the model's "
                         f"labels {labels}")
    dataset = DetectionDataset(project, image_size=model_cfg.image_size,
                               max_gt=model_cfg.max_gt_boxes,
                               label_names=labels,
                               with_masks=model_cfg.with_mask,
                               mask_stride=model_cfg.mask_gt_stride,
                               with_keypoints=model_cfg.with_keypoints,
                               num_keypoints=model_cfg.num_keypoints)
    loader = Loader(dataset, batch_size, shuffle=False,
                    num_workers=num_workers)
    print(f"Evaluating {model_dir} on {len(dataset)} images")
    final_eval, stats = evaluate(forward, loader, num_classes=len(labels))
    if output_dir is not None and is_main_process():
        os.makedirs(output_dir, exist_ok=True)
        _save_aux_results(output_dir, final_eval, stats, labels)
    return stats
