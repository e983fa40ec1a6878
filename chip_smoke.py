#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, serve,
train.

Run from the repository root on a machine with a CUDA GPU and ``nvcc``:

    python3 chip_smoke.py

Phases, one JSON line each:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile ``podtpu_torch/csrc/*.cu`` for ``sm_90a`` into ``build/``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving and the training shapes (keep masks equal for NMS, each case
   twice for equal bits, one unsorted case through the kernel's ``order``
   path against the sorted path, kept boxes per segment; RoIAlign
   forward within atol 2e-2, rtol 1e-2 of a float32 plain run on the same
   bf16 inputs; RoIAlign backward within atol 2e-2, rtol 1e-2 in bf16 and
   atol 1e-4, rtol 1e-4 in float32 of the float32 plain backward; both
   RoIAlign kernels in both output layouts, the backward also on RoIs
   placed against its 8x8 tiles and twice for equal bits), with CUDA-event
   times and the least time the card could take for the same work;
4. reference: a small float32 model on the card against the same weights on
   the CPU (plain versions), detection by detection;
5. slice: Faster R-CNN ResNet-50-FPN at the ``ModelConfig`` defaults
   (1024x1024 canvas, bf16, 1000 proposals, 300 detections, 4 classes) with
   seeded random weights, saved as a model directory and served by
   ``DetectionServer(batch_size=4)`` behind HTTP; 8 client threads send
   canvas-sized images; both forward kernels must have launched during the
   run.  A ``breakdown`` line follows: each stage of the eval forward timed
   with CUDA events, and the device's busy share and busiest kernels over a
   ``torch.profiler`` window;
6. train_reference: one training step of a small float32 model on the CPU
   and on the card, there once with K3 and once with its plain version,
   same weights and draws, six seeds, TF32 off: losses, gradients and
   updated parameters must agree, and the ReLU inputs whose sign differs
   between runs are counted; then the same for a small Mask R-CNN
   (``mask_train_reference``) and Keypoint R-CNN
   (``keypoint_train_reference``), whose K3 also runs at 14;
7. train: the same detector trained at the ``TrainConfig`` defaults (batch
   2, SGD, miso augmentation) on seeded synthetic batches, 3 warm-up and 20
   timed steps; every loss finite and NMS, RoIAlign forward and RoIAlign
   backward launched on every step; the trained model saved and served one
   batch through ``load_inference_model``.  A ``train_breakdown`` line
   follows: CUDA-event times of augmentation, forward and losses, backward
   and optimiser, recorded through the step's ``mark`` hook, and a
   ``torch.profiler`` window of 3 steps.
8. driver: ``train()`` at the ``Config()`` defaults on a seeded in-memory
   project (24 canvas-sized images with 1-30 boxes each, three labels;
   ``podtpu_torch.data.imageio.read_rgb`` replaced by a lookup of seeded
   arrays, so that no image library is needed) for 2 epochs, resumed for
   a third, then ``evaluate_model`` on the 4 test images: losses finite,
   the resumed run starting at epoch 2, the artifacts, the model loading
   on the card, the 12 stats in [-1, 1] and within 0.01 of the last
   epoch's eval, K3 launched once per step and K1, K2 at least once per
   step and eval batch; per-epoch times, images/s beside the step loop's.
   Then one ``evaluate_model`` batch with its K1 and K2 inputs captured,
   and the train ``Loader``'s batches placed on the card against its host
   batches;
9. infer: ``infer()`` over 8 unlabelled in-memory images at batch 4 with
   that model, at threshold 0.5 (the counted run, K1 and K2 launched), at
   0 and at the median of the scores the model returns, where it must keep
   boxes; every kept box finite, above the threshold and inside the canvas
   divided by the image's scale.  The median run's first batch has its K1
   and K2 inputs captured.
10. cli: the port's commands through ``podtpu_torch.cli.main`` against the
   repository's fake CVAT server (``tests/fake_cvat.py``) on 16 seeded
   1024^2 PNG frames: ``train-object-detector`` (2 epochs, batch 2) and
   ``infer-object-detector`` at threshold 0.05 and 0, whose PATCH upload
   must carry shapes with 4 integer points and known labels; where Pillow
   imports, ``crop-objects`` and ``infer-object-detector-directory``.  The
   frames decode through the native host library, built before the first
   phase (``native_build`` line), or where it did not build through
   Pillow, or failing both through a lookup of the seeded arrays.  One
   line per command (wall seconds, images/s, model load, launches, decode
   path, shapes uploaded or crops); one ``evaluate_model`` batch of the
   trained model has its K1 and K2 inputs captured.

11. mask: Mask R-CNN ResNet-50-FPN (``ModelConfig(with_mask=True)``).
   ``mask_reference``: phase 4 for a mask model, detections and masks.
   ``mask_train``: phase 7 for the full-width mask model, on the same
   batches with an ellipse mask target per gt at 1/8 of the canvas, 3
   warm-up and 10 timed steps, then 3 with copy-paste; every loss finite, per step K1 once, K2 twice (7 and
   14), K3 twice; ``mask_train_breakdown``: the step's parts and the mask
   branch's (RoIAlign at 14, head, loss, backward).  ``mask_eval``: the
   eval forward of a seeded random mask model (300 detections an image)
   at batch 4, stage by stage.
   ``mask_driver``: ``train(with_mask=True)`` on 24 in-memory images of
   ellipse polygons for 2 epochs, ``evaluate_model`` (bbox and segm),
   ``infer`` at 0.5 and at the median of the images' best scores
   (polygons counted), and one ``DetectionServer`` batch.  One
   mask training step's K2 and K3 calls at 14 and one eval forward's K2
   call at 14 are captured.
12. keypoint: Keypoint R-CNN ResNet-50-FPN (``ModelConfig(with_keypoints=
   True)``: 17 keypoints, a 512-channel head, 2 classes, the COCO flip
   permutation).  ``keypoint_reference`` and ``keypoint_train_reference``:
   phases 4 and 6 for a keypoint model (heatmap logits, and keypoints on
   clear peaks).  ``keypoint_train``: phase 7 on the train cell's batches,
   17 keypoints a gt, 3 warm-up and 10 timed steps, then 3 with
   ``keypoint_roi_expand`` 1.3; per step K1 once, K2 twice (7 and 14), K3
   twice; ``keypoint_train_breakdown``: the parts and the keypoint
   branch's (RoIAlign at 14, head, loss, backward).  ``keypoint_eval``:
   the eval forward at batch 4, every detection slot filled, stage by
   stage with the decode; K1 twice, K2 twice.  ``keypoint_driver``:
   ``train(with_keypoints=True, num_keypoints=5)`` at
   ``keypoint_roi_expand`` 1.3 on 24 in-memory images whose boxes carry
   their centre and four axis extremes, 2 epochs, ``evaluate_model``
   (bbox and keypoints), ``infer`` (keypoints attached) and one
   ``DetectionServer`` batch.  One keypoint training step's K2 and K3
   calls at 14, at each expansion, and one eval forward's K2 call at 14
   are captured; the share of their RoIs that reach past the canvas is
   printed, and must be above 0 at 1.3.

13. v2: the v2 recipe (``fasterrcnn_v2_config``: the normed FPN, a 2-deep
   RPN tower, the ConvFC box head, the normed mask tower).
   ``v2_reference`` and ``mask_v2_reference``: phase 4 for Faster and
   Mask R-CNN v2.  ``v2_train_reference``: phase 6 for Faster R-CNN v2
   under ``lsj``, two seeds.  ``v2_serve``: phase 5 for
   ``fasterrcnn_v2_config(ModelConfig(num_classes=4))``, K1 twice and K2
   once a batch, with its ``v2_breakdown`` (the ``box_head`` stage is the
   ConvFC head).  ``v2_train``: phase 7 under ``lsj``, 3 warm-up and 10
   timed steps, K1, K2 and K3 once a step, with ``v2_train_breakdown``
   (its augmentation is the resample); one step's K2 and K3 calls at 7
   are captured.  ``mask_v2_train``: Mask R-CNN v2 under ``multiscale``,
   3 + 5 steps, K2 and K3 twice a step (7 and 14); one step's calls at 14
   are captured.  ``v2_driver``: ``train(family="faster_rcnn_v2")`` under
   ``lsj`` on the driver phase's 24 images for 2 epochs, the stored config
   checked, ``evaluate_model``, ``infer`` at the median of the best scores
   (boxes kept) and one ``DetectionServer`` batch.

14. one-stage: RetinaNet, RetinaNet v2 and FCOS R50-FPN (``ONE_STAGE``;
   ``retinanet_config``, ``retinanet_v2_config``, ``fcos_config``).
   ``retinanet_reference``, ``retinanet_v2_reference``,
   ``fcos_reference``: phase 4 for each, scores lifted (``lift_scores``:
   random heads score every class at the prior 0.01, under the
   thresholds); ``*_train_reference``: phase 6 for each, two seeds, no
   kernel launched on the card.  ``retinanet_serve`` and ``fcos_serve``:
   phase 5 with lifted scores, K1 once a batch on 4 segments of 5,000 or
   3,960 boxes, each at least 90 % valid, no K2, with their breakdowns
   (backbone + FPN, head, scores with the per-level top-k, decode and
   pool, NMS, output).  ``retinanet_train``, ``retinanet_v2_train``,
   ``fcos_train``: phase 7, 3 + 10 steps, no kernel.  ``fcos_driver`` and
   ``retinanet_v2_driver``: ``train(family=...)`` for 2 epochs on the v2
   driver's 24 images from a start whose class prior clears the
   thresholds, the stored config checked, ``evaluate_model`` at batch 4,
   ``infer`` at the median best score (boxes kept), 4 server requests; K1
   once per eval and infer batch, each segment's valid boxes printed.

15. tiled and classifier: ``infer_tiled`` on a seeded 3000 x 4000 grey
   scan (400 filled boxes of 16-256 px, the driver's images' look) with
   the driver phase's trained Faster R-CNN, batch 8: ``tiled`` at its
   1024^2 canvas (overlap 0.25: 20 tiles, 3 batches, the last padded with
   4 zero tiles) and ``tiled_2048`` at ``tile_size=2048`` (6 tiles, one
   batch), each first at threshold 0 (the threshold: 0.5, or the score of
   the 2 x tiles-th best merged detection when lower) with its first
   batch's K1 and K2 inputs captured, then counted: K1 twice and K2 once
   a batch exactly; tiles/s with the model load apart, the merge's ms,
   detections before and after it, peak memory.  ``tiled_tiff``: the
   scan as a 16-bit grey TIFF read from its path gives the uint8 run's
   detections; ``tiled_cli``: ``infer-object-detector-tiled`` on its PNG
   through ``podtpu_torch.cli.main``, the same detections and launches
   (both need Pillow).  ``tiled_mask``: a 2048^2 scan with the mask
   driver's trained model (9 tiles, K1 and K2 twice a batch, polygons
   and their host seconds); ``tiled_one_stage``: the full scan with the
   RetinaNet v2 driver's model (K1 once a batch, 8 segments of 5,000).
   ``classifier_reference``: a float32 ``CropClassifier`` at 128^2 on the
   card against the CPU (logits within 1e-4; one AdamW step: loss 1e-5
   relative, gradients 2e-3 of each tensor's largest, parameters 1e-6
   where Adam's ``sqrt(v_hat)`` is at least 1e-5, twice the learning rate
   elsewhere; seeds with ReLU sign flips passed over).  ``classifier``:
   ``train_classifier`` on 4 x 64 seeded PNG crops (128^2, batch 32, 3
   epochs), ``classify_crops`` on them, then ``train-crop-classifier``
   and ``classify-crops`` through the CLI; images/s, each epoch's
   seconds, held-out accuracy, peak memory; no kernel of ours launched.

16. device-resident data and K steps per dispatch: ``train()`` at the
   ``Config()`` defaults holds its dataset on the card
   (``podtpu_torch.data.device_cache``), gathers each batch in the step
   and runs full groups of 8 steps as one CUDA graph replay, so the
   drivers above (``driver``, the head, v2 and one-stage drivers and the
   CLI's ``train-object-detector``) run that path, except ``driver``'s
   resumed third epoch, which streams through the ``Loader``
   (``device_data_cache=False``; the line's ``loaders`` says which loader
   each epoch took); each driver line also
   carries its runner's captures and replays and its epoch losses beside
   PR 11's streamed run's, where it had one.  ``adam_capturable_reference``
   and ``adamw_capturable_reference``: Adam and AdamW made capturable on
   the card (step counters there, a tensor rate), three updates of a
   detector's parameter sizes against the CPU's host-side update on the
   same gradients (parameters and moments within 1e-6 of each tensor's
   largest; each parameter's change within 1e-5 of its largest plus its
   float32 rounding; the card's float32 1 - 0.999^t moves the update by
   about 6.4e-6).  ``cached_reference``
   (Faster R-CNN with SGD, again with AdamW, and RetinaNet): a 128^2
   float32 model, TF32 off, cuDNN deterministic, K = 3: the eager group,
   the capture and its replay, then one replay held against 3 eager
   cached steps from the same state with the same draws (losses,
   parameters, optimiser state within 1e-6 of each tensor's largest
   value; bitwise expected).  ``cached_train``: Faster R-CNN at the
   defaults from a device cache of 32 seeded 1024^2 canvases
   (``synthetic_batch``'s boxes; MiB against ``dataset_device_bytes``):
   the eager group, the capture (seconds), one group held against 8
   eager steps as above, 5 timed replays (images/s, step ms = replay ms
   / 8, peak memory with the graph's pool), our kernels' launches per
   replay from the counts and from ``torch.profiler`` over one more
   replay (equal), the device's idle share there, and the streamed
   ``train`` phase's images/s beside it.  ``cached_<family>_train``
   (``mask``, ``keypoint``, ``v2``, ``mask_v2``, ``retinanet``,
   ``retinanet_v2``, ``fcos``): the same with 3 timed replays, after each
   family's streamed train phase.  ``windowed_driver``: ``train()`` for
   one epoch on the driver's 24 images with ``PODTPU_DEVICE_CACHE_BYTES``
   set so that a window holds 8 samples, its batches, epoch loss and
   parameters held against the ``driver`` phase's first epoch (the full
   cache, the same start).

Launches under graph replay: a capture calls the kernels' wrappers, which
count, but launches nothing; a replay launches without calling them.  The
runner (``CachedMultiStep``) holds apart what its capture counted and adds
it to ``podtpu_torch.ops._build.launches`` on every replay, so the counts
keep meaning kernels the card ran, and ``check_driver_launches`` holds as
before; ``cached_train`` checks them against ``torch.profiler``.

Then K1 on the inputs the main paths gave it (one serving batch's RPN and
postprocess calls, one training step's call, one batch of
``evaluate_model`` and of ``infer``, and one ``evaluate_model`` batch of
the CLI's model, captured after the timed runs; the same for the v2
serving batch and v2 training step, the one-stage serving batches and
the one-stage drivers' ``evaluate_model`` and ``infer`` calls, and the
first batch of each tiled path): as
the path calls it and in score order, against the plain version, twice,
with times; K2 on the captured ``evaluate_model``, ``infer`` and CLI
batches, on the tiled paths' first batches (at 7, and 14 for the mask
model), on the mask and keypoint calls at 14 and on the v2 step's call
at 7 against its float32 plain version, twice, with times; and K3 on the
mask, mask v2 and keypoint steps' gradients at 14 and the v2 step's at 7
against its float32 plain backward, on the gradient
scaled to unit RMS and relative to the largest wanted value, with two
wrong results (zeros, a one-row shift) that must fail.  Then the
``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Any failure exits non-zero before that line.  Without a CUDA device,
or without the ``podtpu_torch`` package beside it, the script fails.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib.util
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zlib
from http.server import ThreadingHTTPServer

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): memory rate and the float32
# rate outside the tensor cores (both kernels do float32 arithmetic).
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
NMS_OPS_PER_IOU = 13       # 4 min/max, 2 sub, 2 clamp, mul, add, sub, div, cmp
# RoIAlign, forward and backward alike: 4 multiply-adds (8 operations) per
# inside sample and channel (forward: each corner's value times its weight
# into the sum; backward: the gradient times each weight into its corner's
# cell), the sample's 4 weights once for all channels (2 fractions, their
# complements, 4 products), and the mean's scaling once per output value.
ROI_OPS_PER_CHANNEL = 8
ROI_OPS_PER_SAMPLE = 8
K3_TILE = 8                  # K3's tile side in cells (csrc/roi_align.cu),
K3_SPLIT_TARGET = 128        # the tiles under which a level's tiles are
K3_MAX_SPLIT = 8             # split over blocks, and the most blocks a tile
SEED = 0
TRAIN_B, TRAIN_K = 2, 512  # images per step, sampled RoIs per image


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# -- phase 3: kernels against their plain versions ---------------------------

def clustered_boxes(rng, s, n, canvas=1024.0, clusters=40):
    """Score-sorted RPN-like boxes: jittered copies around a few objects."""
    centres = rng.uniform(0, canvas, (s, clusters, 2))
    sizes = rng.uniform(16, 300, (s, clusters, 2))
    pick = rng.integers(0, clusters, (s, n))
    c = np.take_along_axis(centres, pick[..., None], 1)
    wh = np.take_along_axis(sizes, pick[..., None], 1)
    c = c + rng.normal(0, 0.15, (s, n, 2)) * wh
    wh = wh * rng.uniform(0.7, 1.3, (s, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    return np.clip(boxes, 0, canvas).astype(np.float32)


def nms_cases(rng):
    """(name, boxes [S, N, 4], valid [S, N], threshold) in sorted order."""
    cases = []
    b = clustered_boxes(rng, 20, 1000)
    v = rng.uniform(size=(20, 1000)) > 0.03
    v[4::5, 768:] = False            # P6 holds 768 real boxes of 1000
    cases.append(("rpn_s20_n1000", b, v, 0.7))
    b = clustered_boxes(rng, 10, 2000)
    v = rng.uniform(size=(10, 2000)) > 0.03
    v[4::5, 768:] = False            # P6 holds 768 real boxes of 2000
    cases.append(("train_rpn_s10_n2000", b, v, 0.7))
    b = clustered_boxes(rng, 12, 1000)
    v = rng.uniform(size=(12, 1000)) > 0.3
    cases.append(("postprocess_s12_n1000", b, v, 0.5))
    x = 4.0 * np.arange(512, dtype=np.float32)
    b = np.stack([x, np.zeros(512, np.float32), x + 10,
                  np.full(512, 10, np.float32)], 1)[None]
    cases.append(("adversarial_chain_n512", b, np.ones((1, 512), bool), 0.3))
    b = np.tile(np.array([[[10, 10, 50, 50]]], np.float32), (1, 64, 1))
    cases.append(("identical_n64", b, np.ones((1, 64), bool), 0.5))
    cx = rng.uniform(40, 60, 2048)
    cy = rng.uniform(40, 60, 2048)
    w = rng.uniform(20, 40, 2048)
    b = np.stack([cx - w / 2, cy - w / 2, cx + w / 2, cy + w / 2],
                 1).astype(np.float32)[None]
    cases.append(("cross_tile_cluster_n2048", b, np.ones((1, 2048), bool),
                  0.5))
    xy = rng.uniform(0, 1024, (8192, 2))
    wh = rng.uniform(1, 256, (8192, 2))
    b = np.concatenate([xy, xy + wh], 1).astype(np.float32)[None]
    cases.append(("random_n8192", b, np.ones((1, 8192), bool), 0.5))
    return cases


def nms_needed_ops(keep, valid, order=None) -> int:
    """IoUs greedy NMS must evaluate on this data: each kept box against
    every later valid box of its segment, in score order."""
    if order is not None:
        keep, valid = keep.gather(1, order), valid.gather(1, order)
    later_valid = valid.flip(-1).cumsum(-1).flip(-1) - valid.long()
    return int((later_valid * keep).sum()) * NMS_OPS_PER_IOU


def plain_keep(torch, nms, boxes, valid, t, order=None):
    """The plain version's keep mask, through ``order`` as the kernel reads
    and writes it: gather, plain NMS in score order, scatter back."""
    if order is None:
        return nms.nms_keep_plain(boxes, valid, t)
    sb = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    kept = nms.nms_keep_plain(sb, torch.gather(valid, 1, order), t)
    return torch.zeros_like(kept).scatter_(1, order, kept)


def nms_record(torch, nms, name, boxes, valid, t, order=None, timed=False):
    """K1 on one case against its plain version, twice for equal bits; the
    kept boxes of each segment; with ``timed``, CUDA-event times of the
    wrapper and the plain version and the bound."""
    got = nms.nms_keep_batched(boxes, valid, t, order)
    again = nms.nms_keep_batched(boxes, valid, t, order)
    want = plain_keep(torch, nms, boxes, valid, t, order)
    torch.cuda.synchronize()
    rec = {"phase": "kernels", "kernel": "nms", "case": name,
           "shape": list(boxes.shape), "threshold": t,
           "order": order is not None, "kept": int(got.sum()),
           "kept_per_segment": got.sum(-1).tolist(),
           "valid": int(valid.sum()),
           "valid_per_segment": valid.sum(-1).tolist(),
           "mismatches": int((got != want).sum()),
           "equal_bits_twice": bool(torch.equal(got, again))}
    if timed:
        ms = time_ms(lambda: nms.nms_keep_batched(boxes, valid, t, order))
        plain_ms = time_ms(lambda: plain_keep(torch, nms, boxes, valid, t,
                                              order), reps=20)
        nbytes = boxes.shape[0] * boxes.shape[1] * (
            16 + 1 + 1 + (8 if order is not None else 0))
        ops = nms_needed_ops(got, valid, order)
        t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / F32_OPS_PER_S
        rec.update(kernel_ms=ms, plain_ms=plain_ms,
                   bound_ms=max(t_bytes, t_ops) * 1e3, bytes=nbytes, ops=ops,
                   bound_by="operations" if t_ops > t_bytes else "bytes")
    emit(rec)
    if rec["mismatches"] or not rec["equal_bits_twice"]:
        raise AssertionError(f"nms {name}: {rec['mismatches']} keep flags "
                             "differ from the plain version, or two runs "
                             "differ")
    return got, rec


def check_nms(torch, nms, dev):
    """Keep masks against the plain version on every case, each twice for
    equal bits, and once through the ``order`` path on unsorted input; the
    serving cases' times summed per batch (the kernels line reports
    those)."""
    rng = np.random.default_rng(SEED)
    serving = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for name, b, v, t in nms_cases(rng):
        boxes = torch.from_numpy(b).to(dev)
        valid = torch.from_numpy(v).to(dev)
        timed = name.startswith(("rpn", "postprocess", "train"))
        got, rec = nms_record(torch, nms, name, boxes, valid, t, timed=timed)
        if name.startswith("adversarial"):
            assert bool(got[0, 0]) and not bool(got[0, 1]) and bool(got[0, 2])
        if name.startswith("identical"):
            assert bool(got[0, 0]) and not bool(got[0, 1:].any())
        if timed and not name.startswith("train"):
            serving["ms"] += rec["kernel_ms"]
            serving["plain_ms"] += rec["plain_ms"]
            serving["bound_ms"] += rec["bound_ms"]
            serving["bound_by"] = rec["bound_by"]
    # Unsorted input through the order path: the same boxes shuffled, with
    # scores that put them back in their first order.
    b, v, t = nms_cases(np.random.default_rng(SEED))[0][1:]
    perm = np.stack([rng.permutation(b.shape[1]) for _ in range(b.shape[0])])
    boxes = torch.from_numpy(np.take_along_axis(b, perm[..., None], 1)).to(dev)
    valid = torch.from_numpy(np.take_along_axis(v, perm, 1)).to(dev)
    scores = -torch.from_numpy(perm).to(dev).float()
    order = nms.sort_by_score(scores, valid)
    got, _ = nms_record(torch, nms, "rpn_s20_n1000_unsorted", boxes, valid,
                        t, order=order, timed=True)
    sorted_path = nms.nms_keep_batched(torch.from_numpy(b).to(dev),
                                       torch.from_numpy(v).to(dev), t)
    segments = nms.nms_keep_segments(boxes, scores, t, valid)
    back = torch.gather(sorted_path, 1, torch.from_numpy(perm).to(dev))
    if not (torch.equal(got, back) and torch.equal(segments, got)):
        raise AssertionError("nms: the order path differs from the sorted "
                             "path")
    serving["max_abs_err"] = 0.0
    return serving


def capture_nms(nms, run, limit=None):
    """The inputs of the first ``limit`` (default: every) K1 calls that
    ``run()`` makes, as the main path hands them to ``nms_keep_batched``
    (boxes, validity, threshold and order), cloned."""
    calls = []
    launch = nms.nms_keep_batched

    def recording(boxes, valid, t, order=None):
        if limit is None or len(calls) < limit:
            calls.append((boxes.clone(), valid.clone(), t,
                          None if order is None else order.clone()))
        return launch(boxes, valid, t, order)

    nms.nms_keep_batched = recording
    try:
        run()
    finally:
        nms.nms_keep_batched = launch
    return calls


def check_nms_main_path(torch, nms, captured):
    """K1 on the inputs the main paths gave it (one batch's RPN and
    postprocess calls of serving, ``evaluate_model`` and ``infer``, one
    training step's call): as the path calls it, and in score order through
    the sorted-form wrapper, against the plain version, twice, with
    times.  Returns the records of the calls as the paths made them, by
    path and call."""
    out = {}
    for path, calls in captured:
        for k, (boxes, valid, t, order) in enumerate(calls):
            name = f"{path}_call{k}_s{boxes.shape[0]}_n{boxes.shape[1]}"
            out[(path, k)] = nms_record(torch, nms, name, boxes, valid, t,
                                        order, timed=True)[1]
            if order is not None:
                sb = torch.gather(boxes, 1,
                                  order[..., None].expand(-1, -1, 4))
                nms_record(torch, nms, name + "_sorted", sb.contiguous(),
                           torch.gather(valid, 1, order), t, timed=True)
    return out


def capture_roi_align(run, limit=None):
    """The inputs of the first ``limit`` (default: every) K2 calls that
    ``run()`` makes through the box head's pooling
    (``models.roi_heads.batched_roi_align``), cloned."""
    from podtpu_torch.models import roi_heads

    calls = []
    launch = roi_heads.batched_roi_align

    def recording(levels, boxes, strides, **kwargs):
        if limit is None or len(calls) < limit:
            calls.append(([f.detach().clone() for f in levels],
                          boxes.detach().clone(), tuple(strides), kwargs))
        return launch(levels, boxes, strides, **kwargs)

    roi_heads.batched_roi_align = recording
    try:
        run()
    finally:
        roi_heads.batched_roi_align = launch
    return calls


def crossing_share(boxes, canvas_hw):
    """Share of the ``[B, K, 4]`` boxes of positive area that reach past
    the ``(H, W)`` canvas on some side."""
    h, w = canvas_hw
    real = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
    out = ((boxes[..., 0] < 0) | (boxes[..., 1] < 0) | (boxes[..., 2] > w)
           | (boxes[..., 3] > h)) & real
    return float(out.sum()) / max(int(real.sum()), 1)


def check_roi_align_main_path(torch, roi_align, captured):
    """K2 on the inputs the main paths gave it, called as the path calls
    it, against the float32 plain run on the same inputs (atol 2e-2, rtol
    1e-2, as ``check_roi_align``), twice for equal bits, with times and the
    bound of this data.  Returns each call's record."""
    recs = []
    for path, calls in captured:
        for k, (levels, boxes, strides, kw) in enumerate(calls):
            got = roi_align.batched_roi_align(levels, boxes, strides, **kw)
            again = roi_align.batched_roi_align(levels, boxes, strides, **kw)
            levels32 = [f.float() for f in levels]
            want = roi_align.batched_roi_align_plain(levels32, boxes,
                                                     strides, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want).abs().max())
            ok = bool(torch.allclose(got.float(), want, atol=2e-2,
                                     rtol=1e-2))
            same = bool(torch.equal(got, again))
            ms = time_ms(lambda: roi_align.batched_roi_align(
                levels, boxes, strides, **kw))
            plain_ms = time_ms(lambda: roi_align.batched_roi_align_plain(
                levels32, boxes, strides, **kw), reps=20)
            out, ratio = kw.get("output_size", 7), kw.get("sampling_ratio", 2)
            nbytes, ops, touched = roi_bound(torch, roi_align, levels, boxes,
                                             strides, out, ratio)
            t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / F32_OPS_PER_S
            rec = {"phase": "kernels", "kernel": "roi_align_fwd",
                   "case": f"{path}_call{k}_out{out}_b{boxes.shape[0]}"
                           f"_k{boxes.shape[1]}_{str(levels[0].dtype)[6:]}",
                   "shape": list(got.shape), "max_abs_err": err,
                   "want_max_abs": float(want.abs().max()),
                   "rois_crossing_canvas": crossing_share(boxes, (
                       levels[0].shape[1] * strides[0],
                       levels[0].shape[2] * strides[0])),
                   "within_tolerance": ok, "equal_bits_twice": same,
                   "kernel_ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(t_bytes, t_ops) * 1e3, "bytes": nbytes,
                   "ops": ops, "touched_cells": touched,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            emit(rec)
            if not (ok and same):
                raise AssertionError(
                    f"roi_align {path} call {k}: max abs error {err} "
                    f"(atol 2e-2, rtol 1e-2), equal bits twice {same}")
            recs.append(rec)
    return recs


def roi_boxes(rng, b, k, canvas=1024.0):
    """RoIs of every kind the serving path meets: ordinary boxes, degenerate,
    partly outside, near-canvas, elongated (level bump), all-zero slots."""
    size = rng.uniform(4, 600, (b, k))
    ar = np.exp(rng.uniform(-1.0, 1.0, (b, k)))
    w, h = size * np.sqrt(ar), size / np.sqrt(ar)
    x = rng.uniform(-20, canvas - 10, (b, k))
    y = rng.uniform(-20, canvas - 10, (b, k))
    boxes = np.stack([x, y, x + w, y + h], -1)
    boxes[:, 0:20] = np.tile(boxes[:, 0:20, :2], 2)                  # zero-size
    boxes[:, 20:30] = [0, 0, canvas - 1, canvas - 1]                 # canvas
    boxes[:, 30:40] = [[-50, 100, 80, 140]]                          # outside
    boxes[:, 40:50] = [[10, 500, 1010, 530]]                         # elongated
    boxes[:, 50:60] = [[1000, 1000, 1030, 1030]]                     # edge
    boxes[:, -40:] = 0.0                                             # invalid
    return boxes.astype(np.float32)


def roi_samples(torch, roi_align, levels, boxes, strides, out=7, ratio=2):
    """Level, neighbour cells and inside flags of every sample of every RoI
    (``[B, K, out * ratio]`` per axis), by the plain version's arithmetic."""
    lvl = roi_align.assign_levels(boxes, len(strides),
                                  base_stride=float(strides[0])).long()
    dev = boxes.device
    heights = torch.tensor([f.shape[1] for f in levels], device=dev)
    widths = torch.tensor([f.shape[2] for f in levels], device=dev)
    scale = 1.0 / torch.tensor(strides, dtype=torch.float32, device=dev)
    n = out * ratio
    g = torch.arange(n, dtype=torch.float32, device=dev)
    g = torch.div(g, ratio, rounding_mode="floor") + (g % ratio + 0.5) / ratio
    s = scale[lvl]
    x1, y1 = boxes[..., 0] * s, boxes[..., 1] * s
    rw = (boxes[..., 2] * s - x1).clamp(min=1.0)
    rh = (boxes[..., 3] * s - y1).clamp(min=1.0)
    ys = y1[..., None] + g * (rh / out)[..., None]
    xs = x1[..., None] + g * (rw / out)[..., None]
    hgt, wid = heights[lvl][..., None], widths[lvl][..., None]
    ylo, yhi, _, _, yin = roi_align._interp_axis(ys, hgt)
    xlo, xhi, _, _, xin = roi_align._interp_axis(xs, wid)
    return lvl, heights, widths, (ylo, yhi, yin), (xlo, xhi, xin)


def roi_bound(torch, roi_align, levels, boxes, strides, out=7, ratio=2):
    """Bytes and operations RoIAlign must spend on this data: every feature
    cell some inside sample touches, read once; boxes read once; the output
    written once; the operations of ``roi_ops``."""
    b, k = boxes.shape[:2]
    c = levels[0].shape[-1]
    dev = boxes.device
    lvl, heights, widths, (ylo, yhi, yin), (xlo, xhi, xin) = roi_samples(
        torch, roi_align, levels, boxes, strides, out, ratio)
    offsets = torch.cumsum(heights * widths, 0) - heights * widths
    wid = widths[lvl][..., None]
    inside = yin[..., :, None] & xin[..., None, :]            # [B, K, n, n]
    base = (torch.arange(b, device=dev)[:, None] * int((heights * widths)
            .sum()) + offsets[lvl])[..., None, None]
    cells = []
    for yi in (ylo, yhi):
        for xi in (xlo, xhi):
            idx = base + yi[..., :, None] * wid[..., None] + xi[..., None, :]
            cells.append(idx[inside])
    touched = int(torch.unique(torch.cat(cells)).numel())
    nbytes = (touched * c * levels[0].element_size() + boxes.numel() * 4
              + b * k * out * out * c * levels[0].element_size())
    return nbytes, roi_ops(int(inside.sum()), c, b * k * out * out), touched


def roi_ops(inside, c, outputs):
    """Operations RoIAlign (forward or backward) must do for ``inside``
    samples of ``c`` channels and ``outputs`` output cells."""
    return (inside * (c * ROI_OPS_PER_CHANNEL + ROI_OPS_PER_SAMPLE)
            + outputs * c)


def k3_tile_hits(torch, roi_align, levels, boxes, strides, out=7, ratio=2):
    """(RoI, tile) pairs K3 visits: for each RoI the tiles of K3_TILE cells
    a side that the rectangle of its inside samples' cells meets."""
    _, _, _, (ylo, yhi, yin), (xlo, xhi, xin) = roi_samples(
        torch, roi_align, levels, boxes, strides, out, ratio)
    big = 1 << 30

    def span(lo, hi, inside):
        first = torch.where(inside, lo, big).amin(-1) // K3_TILE
        last = torch.where(inside, hi, -1).amax(-1) // K3_TILE
        return torch.where(inside.any(-1), last - first + 1, 0)

    return int((span(ylo, yhi, yin) * span(xlo, xhi, xin)).sum())


def random_levels(torch, dev, gen, b, c=256, canvas=1024,
                  strides=(4, 8, 16, 32), dtype=None):
    """P2..P5-shaped levels as the model hands them to RoIAlign: the
    contiguous NHWC view of channels_last NCHW tensors."""
    levels = []
    for st in strides:
        nchw = torch.randn((b, c, canvas // st, canvas // st), device=dev,
                           generator=gen).to(dtype or torch.bfloat16)
        nchw = nchw.contiguous(memory_format=torch.channels_last)
        levels.append(nchw.permute(0, 2, 3, 1))
    return levels


def check_roi_align(torch, roi_align, dev, b=4, k=1000, seed=SEED + 1,
                    case="serving_b4_k1000_c256_bf16"):
    """K2 in both output layouts against the float32 plain run on the same
    bf16 inputs.  ``kernel_ms`` is the JAX package's layout, ``[B, K, out,
    out, C]``; ``kernel_ms_channels_first`` the box head's, which the
    model's paths launch."""
    rng = np.random.default_rng(seed)
    c, canvas = 256, 1024
    strides = (4, 8, 16, 32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    levels = random_levels(torch, dev, gen, b, c, canvas, strides)
    boxes = torch.from_numpy(roi_boxes(rng, b, k, canvas)).to(dev)
    got = roi_align.batched_roi_align(levels, boxes, strides)
    got_cf = roi_align.batched_roi_align(levels, boxes, strides,
                                         channels_first=True)
    levels32 = [f.float() for f in levels]
    want = roi_align.batched_roi_align_plain(levels32, boxes, strides)
    # The card computes each box's level in one kernel of its own; the
    # plain version computes it with torch operations.
    level_mismatches = int((roi_align._assign_levels_kernel(
        boxes, len(strides), 224.0, 4, 2, float(strides[0]))
        != roi_align.assign_levels(boxes, len(strides),
                                   base_stride=float(strides[0]))).sum())
    torch.cuda.synchronize()
    same_layouts = bool(torch.equal(got_cf, got.permute(0, 1, 4, 2, 3)))
    err = float((got.float() - want).abs().max())
    ok = bool(torch.allclose(got.float(), want, atol=2e-2, rtol=1e-2))
    del got_cf
    ms = time_ms(lambda: roi_align.batched_roi_align(levels, boxes, strides))
    ms_cf = time_ms(lambda: roi_align.batched_roi_align(
        levels, boxes, strides, channels_first=True))
    plain_ms = time_ms(lambda: roi_align.batched_roi_align_plain(
        levels32, boxes, strides), reps=20)
    nbytes, ops, touched = roi_bound(torch, roi_align, levels, boxes, strides)
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / F32_OPS_PER_S
    rec = {"phase": "kernels", "kernel": "roi_align_fwd",
           "case": case, "shape": list(got.shape),
           "max_abs_err": err, "within_tolerance": ok,
           "channels_first_equal_bits": same_layouts,
           "level_mismatches": level_mismatches, "kernel_ms": ms,
           "kernel_ms_channels_first": ms_cf,
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bytes": nbytes, "ops": ops, "touched_cells": touched,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    emit(rec)
    if not ok:
        raise AssertionError(f"roi_align: max abs error {err} exceeds atol "
                             "2e-2 / rtol 1e-2")
    if not same_layouts:
        raise AssertionError("roi_align: the channels-first output differs "
                             "from the permuted channels-last output")
    if level_mismatches:
        raise AssertionError(f"roi_align: {level_mismatches} boxes get "
                             "another level on the card than in torch")
    return {"ms": ms_cf, "plain_ms": plain_ms, "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "max_abs_err": err}


def tile_case_boxes(rng, b, k, canvas=1024.0):
    """RoIs placed against K3's 8x8-cell tiles (32 px at P2, 64 at P3, 128
    at P4, 256 at P5): straddling tile borders and corners on every level,
    wholly inside one tile, covering all of P5, stacked on one spot, at and
    beyond the canvas edge, zero-size, then random ones."""
    fixed = np.array([
        [36, 36, 56, 56], [2, 2, 20, 28],            # inside one P2 tile
        [20, 20, 44, 44], [28, 60, 70, 68],          # across P2 borders
        [200, 200, 330, 330], [130, 120, 250, 260],  # P3, across corners
        [136, 136, 180, 184],                        # inside one P3 tile
        [300, 100, 600, 380], [250, 250, 520, 516],  # P4 across borders
        [0, 0, 1023, 1023], [0, 0, 1024, 1024],      # all of P5
        [100, 200, 900, 760], [500, 500, 1100, 1100],
        [10, 500, 1010, 530], [-50, 100, 80, 140],   # elongated, outside
        [1000, 1000, 1030, 1030], [0, 0, 0, 0], [512, 512, 512, 512],
    ], np.float32)
    boxes = roi_boxes(rng, b, k, canvas)
    n = len(fixed)
    boxes[:, :n] = fixed
    boxes[:, n:2 * n] = fixed      # every fixed RoI twice: sums over RoIs
    boxes[:, 2 * n:2 * n + 6] = [[250, 250, 520, 516]]
    return boxes


def check_roi_align_cases(torch, roi_align, dev):
    """K2 and K3 on RoIs placed against K3's tiles, in bf16 and float32,
    both layouts, output sizes 7 and 14, at the training level shapes with
    48 channels (one ragged chunk and group), against the float32 plain
    versions; K3 twice for equal bits."""
    b, k, c, canvas = 2, 64, 48, 1024
    strides = (4, 8, 16, 32)
    rng = np.random.default_rng(SEED + 4)
    boxes = torch.from_numpy(tile_case_boxes(rng, b, k, canvas)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    tols = {torch.bfloat16: dict(atol=2e-2, rtol=1e-2),
            torch.float32: dict(atol=1e-4, rtol=1e-4)}
    worst = {}
    for out_size in (7, 14):
        for dtype, tol in tols.items():
            if out_size == 14 and dtype == torch.float32:
                # 196 bins a RoI and stacked RoIs: sums of hundreds of
                # float32 terms, in the plain version too.
                tol = dict(atol=5e-4, rtol=1e-4)
            levels = random_levels(torch, dev, gen, b, c, canvas, strides,
                                   dtype)
            levels32 = [f.float() for f in levels]
            g = torch.randn((b, k, out_size, out_size, c), device=dev,
                            generator=gen).to(dtype)
            want_f = roi_align.batched_roi_align_plain(
                levels32, boxes, strides, out_size)
            want_b = roi_align.batched_roi_align_backward_plain(
                g.float(), levels32, boxes, strides, out_size)
            for cf in (False, True):
                name = (f"out{out_size}_"
                        f"{'bf16' if dtype == torch.bfloat16 else 'f32'}_"
                        f"{'channels_first' if cf else 'channels_last'}")
                got_f = roi_align.batched_roi_align(
                    levels, boxes, strides, out_size, channels_first=cf)
                if cf:
                    got_f = got_f.permute(0, 1, 3, 4, 2)
                g_in = g.permute(0, 1, 4, 2, 3).contiguous() if cf else g
                got_b = roi_align.batched_roi_align_backward(
                    g_in, levels, boxes, strides, out_size,
                    channels_first=cf)
                again = roi_align.batched_roi_align_backward(
                    g_in, levels, boxes, strides, out_size,
                    channels_first=cf)
                torch.cuda.synchronize()
                # The forward's own tolerance in float32: sums of four
                # products of values near 1 in another order.
                f_tol = tol if dtype == torch.bfloat16 else dict(
                    atol=1e-4, rtol=1e-4)
                rec = {"phase": "kernels", "kernel": "roi_align_cases",
                       "case": name,
                       "fwd_max_abs_err": float(
                           (got_f.float() - want_f).abs().max()),
                       "fwd_ok": bool(torch.allclose(got_f.float(), want_f,
                                                     **f_tol)),
                       "bwd_max_abs_err": max(
                           float((x.float() - w).abs().max())
                           for x, w in zip(got_b, want_b)),
                       "bwd_ok": all(
                           x.dtype == dtype
                           and torch.allclose(x.float(), w, **tol)
                           for x, w in zip(got_b, want_b)),
                       "bwd_equal_bits": all(
                           torch.equal(x, y) for x, y in zip(got_b, again))}
                emit(rec)
                if not (rec["fwd_ok"] and rec["bwd_ok"]
                        and rec["bwd_equal_bits"]):
                    raise AssertionError(f"roi_align cases {name}: {rec}")
                worst[name] = rec
    return worst


def roi_bwd_bound(torch, roi_align, levels, boxes, strides, grad, out=7,
                  ratio=2):
    """Bytes and operations RoIAlign's backward must spend on this data:
    the upstream gradient and the boxes read once, every level-gradient
    cell written once in the levels' dtype, the operations of ``roi_ops``
    (as many as the forward's); and the cells the inside samples touch."""
    _, ops, touched = roi_bound(torch, roi_align, levels, boxes, strides,
                                out, ratio)
    nbytes = (grad.numel() * grad.element_size() + boxes.numel() * 4
              + sum(f.numel() for f in levels) * levels[0].element_size())
    return nbytes, ops, touched


def check_roi_align_bwd(torch, roi_align, dev):
    """K3 at the training shapes, in bf16 (the training path) and float32,
    in both layouts of the upstream gradient, against the float32 plain
    backward on the same inputs, and twice for equal bits.  Its bound
    counts what the function must move: the upstream gradient and the
    boxes, read once, and every cell of the level gradients, written once
    in the level dtype (the untouched cells as zeros).  ``bytes_moved``
    counts what this design moves: the level and preparing passes (boxes
    read, levels, each RoI's sample entries and 8 bytes of rectangle
    written), each block's scan of its image's rectangles, the upstream
    gradient and the sample entries of a RoI once for every tile its
    rectangle meets, the float32 partial tiles of the split coarse levels
    written and read once, and the level gradients written once."""
    rng = np.random.default_rng(SEED + 2)
    b, k, c, canvas = TRAIN_B, TRAIN_K, 256, 1024
    strides = (4, 8, 16, 32)
    boxes = torch.from_numpy(roi_boxes(rng, b, k, canvas)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    out = {}
    for dtype, tol in ((torch.bfloat16, dict(atol=2e-2, rtol=1e-2)),
                       (torch.float32, dict(atol=1e-4, rtol=1e-4))):
        levels = random_levels(torch, dev, gen, b, c, canvas, strides, dtype)
        g = torch.randn((b, k, 7, 7, c), device=dev, generator=gen).to(dtype)
        g_cf = g.permute(0, 1, 4, 2, 3).contiguous()
        got = roi_align.batched_roi_align_backward(g, levels, boxes, strides)
        again = roi_align.batched_roi_align_backward(g, levels, boxes,
                                                     strides)
        got_cf = roi_align.batched_roi_align_backward(
            g_cf, levels, boxes, strides, channels_first=True)
        levels32 = [f.float() for f in levels]
        want = roi_align.batched_roi_align_backward_plain(
            g.float(), levels32, boxes, strides)
        torch.cuda.synchronize()
        err = max(float((x.float() - w).abs().max())
                  for x, w in zip(got, want))
        ok = all(x.dtype == dtype and torch.allclose(x.float(), w, **tol)
                 for x, w in zip(got, want))
        equal_bits = all(torch.equal(x, y) for x, y in zip(got, again))
        same_layouts = all(torch.equal(x, y) for x, y in zip(got, got_cf))
        del got, again, got_cf, want
        ms = time_ms(lambda: roi_align.batched_roi_align_backward(
            g, levels, boxes, strides))
        ms_cf = time_ms(lambda: roi_align.batched_roi_align_backward(
            g_cf, levels, boxes, strides, channels_first=True))
        plain_ms = time_ms(lambda: roi_align.batched_roi_align_backward_plain(
            g.float(), levels32, boxes, strides), reps=10)
        nbytes, ops, touched = roi_bwd_bound(torch, roi_align, levels, boxes,
                                             strides, g)
        size = levels[0].element_size()
        cells = sum(f.numel() for f in levels)
        per_roi = 2 * 7 * 2 * 8                # sample entries, bytes
        groups = -(-c * size // 512)           # 32 16-byte vectors a block
        units = partial_tiles = 0
        for f in levels:
            n = -(-f.shape[1] // K3_TILE) * -(-f.shape[2] // K3_TILE)
            split = min(max(K3_SPLIT_TARGET // n, 1), K3_MAX_SPLIT)
            units += n * split
            partial_tiles += n * split if split > 1 else 0
        hits = k3_tile_hits(torch, roi_align, levels, boxes, strides)
        partial = b * partial_tiles * K3_TILE * K3_TILE * c * 4
        moved = (b * k * (16 + 4) + b * k * (16 + 4 + per_roi + 8)
                 + b * units * groups * k * 8
                 + hits * (49 * c * size + per_roi * groups)
                 + 2 * partial + cells * size)
        t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / F32_OPS_PER_S
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        rec = {"phase": "kernels", "kernel": "roi_align_bwd",
               "case": f"train_b{b}_k{k}_c{c}_{name}",
               "grad_shape": list(g.shape), "max_abs_err": err,
               "tolerance": tol, "within_tolerance": ok,
               "equal_bits_twice": equal_bits,
               "channels_first_equal_bits": same_layouts, "kernel_ms": ms,
               "kernel_ms_channels_first": ms_cf,
               "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bytes": nbytes, "bytes_moved": moved, "tile_hits": hits,
               "blocks": b * units * groups, "partial_bytes": partial,
               "ops": ops,
               "touched_cells": touched,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        emit(rec)
        if not ok:
            raise AssertionError(f"roi_align_bwd {name}: max abs error {err} "
                                 f"exceeds {tol}")
        if not (equal_bits and same_layouts):
            raise AssertionError(f"roi_align_bwd {name}: two runs, or the "
                                 "two layouts, differ in bits")
        out[name] = {"ms": ms_cf, "plain_ms": plain_ms,
                     "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                     "max_abs_err": err}
    return out["bf16"]


# -- phase 4: small float32 model on the card vs the CPU ---------------------

# The heads each model adds to Faster R-CNN, by the name the phases use,
# and the v2 recipe's models (``fasterrcnn_v2_config``).  A keypoint model
# flips its left and right joints as ``train()`` makes it do for the COCO
# skeleton (a chiral skeleton: no vertical flip).
MODELS = ("faster", "mask", "keypoint", "faster_v2", "mask_v2",
          "retinanet", "retinanet_v2", "fcos")
# The one-stage families (phase 14): no RoI stage, one class-offset NMS
# segment an image.
ONE_STAGE = ("retinanet", "retinanet_v2", "fcos")
# The augmentation policy each model trains with: the v2 recipes' scale
# jitters, the reference pipeline's miso for the others.
MODEL_POLICY = {"faster_v2": "lsj", "mask_v2": "multiscale"}


def model_config(model, **kw):
    """The ``ModelConfig`` of ``model`` (one of ``MODELS``) with the fields
    ``kw``: a one-stage family's preset over ``ModelConfig(**kw)``."""
    from podtpu_torch.core import config

    cfg = config.ModelConfig(**kw, **model_kwargs(model))
    preset = {"retinanet": config.retinanet_config,
              "retinanet_v2": config.retinanet_v2_config,
              "fcos": config.fcos_config}.get(model)
    return preset(cfg) if preset else cfg


def lift_scores(torch, net, prior=None):
    """A seeded one-stage model whose scores clear its thresholds: random
    weights score every class near the prior 0.01, under RetinaNet's 0.05
    and FCOS's 0.2, and K1 would see segments of invalid boxes only.  The
    class logits get bias 0 and, behind a tower without GroupNorm (whose
    outputs are about 100 times smaller than a normed tower's), their
    kernel times 100: scores spread around 0.5 either way.  With
    ``prior`` the bias is ``logit(prior)`` instead, the kernel as it was: a
    start that training does not blow up (at 0.5 on every anchor the
    focal loss of the background alone is over 100 a foreground anchor).
    FCOS's distances get bias 1 (boxes about two strides wide)."""
    head = net.head
    normed = any(isinstance(m, torch.nn.GroupNorm)
                 for m in head.classification_head.modules())
    with torch.no_grad():
        head.classification_head.cls_logits.bias.fill_(
            0.0 if prior is None else float(np.log(prior / (1 - prior))))
        if not normed and prior is None:
            head.classification_head.cls_logits.weight.mul_(100.0)
        if hasattr(head.regression_head, "bbox_ctrness"):
            head.regression_head.bbox_reg.bias.fill_(1.0)
    return net


def model_kwargs(model):
    """``ModelConfig`` arguments of ``model``, one of ``MODELS`` (none for
    a one-stage family: see ``model_config``)."""
    from podtpu_torch.core.config import (COCO_17_HFLIP_INDS, ModelConfig,
                                          fasterrcnn_v2_config)

    if model in ONE_STAGE:
        return {}
    head = {"mask": dict(with_mask=True),
            "keypoint": dict(with_keypoints=True,
                             keypoint_hflip_inds=COCO_17_HFLIP_INDS)}.get(
        head_of(model), {})
    if not model.endswith("_v2"):
        return head
    v2 = fasterrcnn_v2_config(ModelConfig())
    return dict(head, **{k: getattr(v2, k) for k in (
        "rpn_conv_depth", "box_head_type", "fpn_norm", "mask_head_norm")})


def head_of(model):
    """The extra head of ``model`` ("mask", "keypoint") or None."""
    head = model.split("_")[0]
    return head if head in ("mask", "keypoint") else None


def model_title(model):
    """``model``'s name in the records, e.g. mask_rcnn_resnet50_fpn_v2,
    retinanet_resnet50_fpn_v2."""
    base, _, v2 = model.partition("_")
    kind = "" if model in ONE_STAGE else "_rcnn"
    return f"{base}{kind}_resnet50_fpn" + ("_v2" if v2 else "")


def phase_name(model, name):
    """The phase line of ``model``: ``name`` for Faster R-CNN, ``v2_name``
    for its v2 recipe, else ``model_name``."""
    return {"faster": name, "faster_v2": f"v2_{name}"}.get(
        model, f"{model}_{name}")


def peak_margins(torch, logits):
    """``[..., K]`` top-two margins of ``[..., K, H, W]`` heatmap logits."""
    top = logits.flatten(-2).topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def check_reference(torch, dev, model="faster"):
    """A small float32 model (``model`` one of ``MODELS``) on the card
    against the same weights on the CPU (plain versions), TF32 off: valid
    slots and labels equal, boxes within 1e-3, scores within 1e-4 and, on
    valid slots, masks within 1e-3 (six convolutions and a sigmoid after
    the pooling, summed in another order).  A keypoint model's heatmap
    logits over the CPU's detections are held within 1e-4 of their
    largest, as the CPU tests hold the port's against JAX's, and its
    keypoints where a heatmap's peak clears its runner-up by ten times
    that (at least half of them): x and y within 1e-2 px, scores within
    1e-3 relative.  Seeds whose scores nearly tie are passed over: a near
    tie would make slot order fragile.  A one-stage model's scores are
    lifted (``lift_scores``)."""
    from podtpu_torch.models.detector import init_parameters, make_detector

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(model_config(
        model, image_size=(128, 128), rpn_pre_nms_topk_test=128,
        rpn_post_nms_topk_test=64, compute_dtype="float32", num_classes=4),
        detections_per_image=16)
    try:
        for seed in range(SEED, SEED + 5):
            cpu = make_detector(cfg)
            init_parameters(cpu, torch.Generator().manual_seed(seed))
            if model in ONE_STAGE:
                lift_scores(torch, cpu)
            cpu = cpu.to(memory_format=torch.channels_last).eval()
            gpu = copy.deepcopy(cpu).to(dev)
            img = np.random.default_rng(seed).integers(
                0, 256, (2, 128, 128, 3)).astype(np.uint8)
            with torch.inference_mode():
                want = cpu(torch.from_numpy(img))
                got = gpu(torch.from_numpy(img).to(dev))
            head = head_of(model)
            if head:
                (want, want_x), (got, got_x) = want, got
            s = want.scores[want.valid].sort().values
            if s.numel() > 1 and float(s.diff().min()) < 1e-5:
                continue
            v = want.valid
            rec = {"phase": phase_name(model, "reference"),
                   "seed": seed, "detections": int(v.sum()),
                   "same_valid": torch.equal(got.valid.cpu(), v),
                   "same_labels": torch.equal(got.labels.cpu(), want.labels),
                   "box_max_abs_err": float(
                       (got.boxes.cpu() - want.boxes).abs().max()),
                   "score_max_abs_err": float(
                       (got.scores.cpu() - want.scores).abs().max())}
            ok = True
            if head == "mask":
                rec.update(mask_shape=list(got_x.shape),
                           mask_max_abs_err=float(
                               (got_x.cpu()[v] - want_x[v]).abs().max()))
                ok = rec["mask_max_abs_err"] <= 1e-3
            elif head == "keypoint":
                x = torch.from_numpy(img)
                with torch.inference_mode():
                    want_l = cpu._keypoint_logits(cpu.features(x),
                                                  want.boxes)[1]
                    got_l = gpu._keypoint_logits(gpu.features(x.to(dev)),
                                                 want.boxes.to(dev))[1].cpu()
                top = float(want_l[v].abs().max())
                clear = peak_margins(torch, want_l[v]) > 10 * 1e-4 * top
                gk = got_x.keypoints.cpu()[v][clear]
                wk = want_x.keypoints[v][clear]
                rec.update(
                    keypoint_shape=list(got_x.keypoints.shape),
                    logit_max_abs_err_over_max=float(
                        (got_l[v] - want_l[v]).abs().max()) / top,
                    keypoints_held=int(clear.sum()),
                    keypoints=int(clear.numel()),
                    keypoint_xy_max_abs_err=float(
                        (gk[:, :2] - wk[:, :2]).abs().max()) if len(gk)
                    else None,
                    keypoint_score_max_rel_err=float(
                        ((gk[:, 2] - wk[:, 2]).abs() / wk[:, 2]).max())
                    if len(gk) else None)
                ok = (rec["logit_max_abs_err_over_max"] <= 1e-4
                      and 0 < rec["keypoints_held"] * 2 >= rec["keypoints"]
                      and rec["keypoint_xy_max_abs_err"] <= 1e-2
                      and rec["keypoint_score_max_rel_err"] <= 1e-3)
            emit(rec)
            if not (ok and rec["same_valid"] and rec["same_labels"]
                    and rec["box_max_abs_err"] <= 1e-3
                    and rec["score_max_abs_err"] <= 1e-4
                    and (rec["detections"] > 0 or head is None)):
                raise AssertionError("GPU detections disagree with the CPU "
                                     "reference")
            return
        raise AssertionError("no seed without near-tied scores")
    finally:
        torch.backends.cudnn.allow_tf32 = True


# -- phase 5: the serving slice ----------------------------------------------

def stage_breakdown(torch, model, images):
    """Milliseconds of each stage of one eval forward on the card (CUDA
    events, median), each stage fed the previous stage's outputs, and the
    whole forward."""
    from podtpu_torch.models import roi_heads as rh
    from podtpu_torch.models import rpn as rpn_lib

    cfg = model.cfg
    x = torch.from_numpy(np.stack(images)).cuda()
    with torch.inference_mode():
        pyramid = model.features(x)
        logits, deltas = model.rpn.head(pyramid)
        props = rpn_lib.select_proposals(logits, deltas, model.rpn.anchors(),
                                         cfg)
        pooled = model.pool_boxes(pyramid, props.boxes)
        b, p = pooled.shape[:2]
        flat = pooled.reshape(b * p, *pooled.shape[2:])
        cls, reg = model.roi_heads(flat)
        stages = {
            "backbone_fpn": lambda: model.features(x),
            "rpn_head": lambda: model.rpn.head(pyramid),
            "select_proposals": lambda: rpn_lib.select_proposals(
                logits, deltas, model.rpn.anchors(), cfg),
            "roi_align": lambda: model.pool_boxes(pyramid, props.boxes),
            "box_head": lambda: model.roi_heads(flat),
            "postprocess": lambda: rh.postprocess_detections(
                cls.reshape(b, p, -1), reg.reshape(b, p, -1), props.boxes,
                props.valid, cfg),
            "forward": lambda: model(x),
        }
        return {name: time_ms(fn, reps=10) for name, fn in stages.items()}


def one_stage_breakdown(torch, model, images):
    """Milliseconds of each stage of a one-stage model's eval forward on
    the card (CUDA events, median), each fed the previous stage's outputs:
    backbone and FPN, the head, the scores with the per-level top-k,
    decode and the pool's re-top, the class-offset NMS (K1), the output's
    top-k; and the whole forward."""
    from podtpu_torch.models import retinanet as one_stage

    cfg = model.cfg
    x = torch.from_numpy(np.stack(images)).cuda()
    with torch.inference_mode():
        pyramid = model.features(x)
        head_out = model.head(pyramid)

        def pool():
            return one_stage.candidate_pool(
                *model.level_scores(*head_out), model.anchors(), cfg,
                model.decode)

        boxes, scores, labels, valid = pool()
        keep = one_stage.batched_nms_keep(boxes, scores, labels,
                                          cfg.nms_thresh, valid,
                                          presorted=True)
        stages = {
            "backbone_fpn": lambda: model.features(x),
            "head": lambda: model.head(pyramid),
            "topk_decode": pool,
            "nms": lambda: one_stage.batched_nms_keep(
                boxes, scores, labels, cfg.nms_thresh, valid,
                presorted=True),
            "output": lambda: one_stage.select_detections(
                boxes, scores, labels, keep, cfg),
            "forward": lambda: model(x),
        }
        return {name: time_ms(fn, reps=10) for name, fn in stages.items()}


def device_profile(torch, run, reps=3, unit="forward"):
    """Device busy share over ``reps`` calls of ``run`` (the union of the
    device activities that ``torch.profiler`` records, over the host wall
    time of the window), the device time of the busiest kernels, and the
    self device time of the busiest operators with their calls per
    ``unit``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # A record_function range also shows on the device's timeline, under
    # the name of its host event; it is not device work.
    host = {e.name for e in prof.events() if e.device_type == DeviceType.CPU}
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.name not in host)
    busy, end = 0.0, float("-inf")
    by_name = {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    ours = {}       # the port's own kernels, by function name
    calls = {}      # and the times the device ran each
    for start, stop, name in spans:
        found = re.search(r"\b(roi_\w+|nms_\w+)", name)
        if found:
            key = found.group(1)
            ours[key] = ours.get(key, 0.0) + (stop - start) / 1e3 / reps
            calls[key] = calls.get(key, 0) + 1
    ops = sorted(((e.key, e.self_device_time_total, e.count)
                  for e in prof.key_averages()
                  if e.self_device_time_total > 0), key=lambda t: -t[1])[:12]
    return {f"{unit}s": reps, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us if spans else None,
            "device_activities": len(spans),
            f"port_kernels_ms_per_{unit}": ours,
            f"port_kernel_runs_per_{unit}": {
                k: v / reps for k, v in calls.items()},
            f"top_kernels_ms_per_{unit}": [
                [name[:160], ms / 1e3 / reps] for name, ms in top],
            f"top_ops_self_device_ms_per_{unit}": [
                [key, us / 1e3 / reps, count // reps]
                for key, us, count in ops]}


def serve_slice(torch, card, dev, cfg, captured, model="faster"):
    """``cfg``'s model (``model``, one of ``MODELS``: "faster", or
    "faster_v2" for the ``v2_serve`` phase, or a one-stage family) with
    seeded random weights (a one-stage model's scores lifted,
    ``lift_scores``), saved as a model directory and served by
    ``DetectionServer(batch_size=4)`` behind HTTP to 8 client threads;
    each batch must launch K1 twice and K2 once (a one-stage model: K1
    once, its one segment an image at least 90 % valid boxes, and no K2).
    Then its breakdown line.  Returns the launches."""
    from podtpu_torch.infer.server import DetectionServer, make_handler
    from podtpu_torch.models.detector import init_parameters, make_detector
    from podtpu_torch.ops import _build, nms
    from podtpu_torch.train.checkpoints import save_labels, save_model

    labels = ["radiolarian", "foraminifera", "diatom"]
    rng = np.random.default_rng(SEED)
    h, w = cfg.image_size
    threads, per_thread = 8, 8
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for _ in range(threads * per_thread)]
    with tempfile.TemporaryDirectory() as model_dir:
        net = make_detector(cfg)
        init_parameters(net, torch.Generator().manual_seed(SEED))
        if model in ONE_STAGE:
            lift_scores(torch, net)
        save_model(model_dir, net, cfg, labels)
        save_labels(model_dir, labels)
        del net
        t0 = time.perf_counter()
        server = DetectionServer(model_dir, batch_size=4, device=dev)
        load_s = time.perf_counter() - t0
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
        http_thread = threading.Thread(target=httpd.serve_forever,
                                       daemon=True)
        http_thread.start()
        try:
            port = httpd.server_address[1]
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                        timeout=60) as resp:
                health = json.loads(resp.read())
            assert health["status"] == "ok" and health["labels"] == labels

            def run_clients(batch, n_threads):
                results = [None] * len(batch)
                errors = []

                def client(t):
                    try:
                        for i in range(t, len(batch), n_threads):
                            results[i] = server.detect_array(batch[i], 0.05)
                    except Exception as exc:  # reported below
                        errors.append(repr(exc))

                ts = [threading.Thread(target=client, args=(t,))
                      for t in range(n_threads)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(timeout=600)
                assert not any(t.is_alive() for t in ts), "client hung"
                assert not errors, errors
                return results

            t0 = time.perf_counter()
            run_clients(images[:4], 4)        # warm-up batch
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            served0 = server.batches_served
            server.batch_seconds.clear()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            t0 = time.perf_counter()
            results = run_clients(images, threads)
            wall = time.perf_counter() - t0
            launches = dict(_build.launches)
            batches = server.batches_served - served0
            lat = sorted(server.batch_seconds)
            stages = (one_stage_breakdown if model in ONE_STAGE
                      else stage_breakdown)(torch, server.model, images[:4])
            x = torch.from_numpy(np.stack(images[:4])).to(dev)

            def forward():
                with torch.inference_mode():
                    server.model(x)

            prof = device_profile(torch, forward)
            calls = capture_nms(nms, forward)
            captured.append((phase_name(model, "serve"), calls))
        finally:
            httpd.shutdown()
            http_thread.join(timeout=30)
            server.close()
    n_det = 0
    for r in results:
        assert isinstance(r, dict) and isinstance(r["detections"], list)
        assert r["width"] == w and r["height"] == h
        for d in r["detections"]:
            x1, y1, x2, y2 = d["box"]
            assert all(np.isfinite(v) for v in d["box"]), d
            assert 0 <= x1 <= x2 <= w and 0 <= y1 <= y2 <= h, d
            assert np.isfinite(d["score"]) and d["label"] in labels, d
        n_det += len(r["detections"])
    rec = {"phase": "slice" if model == "faster"
           else phase_name(model, "serve"), "model": model_title(model),
           "image_size": list(cfg.image_size),
           "compute_dtype": cfg.compute_dtype, "batch_size": 4,
           "requests": len(images), "client_threads": threads,
           "batches_served": batches, "detections": n_det,
           "load_s": load_s, "warmup_s": warm_s, "wall_s": wall,
           "images_per_s": len(images) / wall,
           "batch_latency_p50_ms": statistics.median(lat) * 1e3,
           "batch_latency_max_ms": lat[-1] * 1e3,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches,
           "launches_per_batch": {k: v / batches
                                  for k, v in launches.items()},
           "k1_segments": [{"shape": list(c[0].shape[:2]),
                            "valid_per_segment": c[1].sum(-1).tolist()}
                           for c in calls],
           "card": card}
    emit(rec)
    emit({"phase": phase_name(model, "breakdown"), "batch_size": 4,
          "stages_ms": stages, "profile": prof, "card": card})
    per_batch = {"nms": 2, "roi_align_fwd": 1}
    if model in ONE_STAGE:
        per_batch = {"nms": 1, "roi_align_fwd": 0}
        boxes, valid = calls[0][:2]
        share = float(valid.sum(-1).min()) / valid.shape[1]
        if len(calls) != 1 or boxes.shape[0] != 4 or share < 0.9:
            raise AssertionError(
                f"{model} serve: {len(calls)} K1 calls a batch of shape "
                f"{tuple(boxes.shape)}, least valid share {share}; expected "
                "one call of 4 segments, each at least 90 % valid")
    for name, per in per_batch.items():
        if launches.get(name, 0) != per * batches:
            raise AssertionError(f"kernel {name} launched {launches.get(name)}"
                                 f" times in {batches} batches, expected "
                                 f"{per} a batch")
    return launches


# -- phases 6 and 7: training -------------------------------------------------

def synthetic_batch(rng, b, size, max_gt, n_gt=(1, 30), side=(16, 256),
                    classes=3):
    """uint8 canvases with 1..30 gt boxes of 16..256 px each, padded to
    ``max_gt`` slots."""
    h, w = size
    boxes = np.zeros((b, max_gt, 4), np.float32)
    labels = np.zeros((b, max_gt), np.int32)
    valid = np.zeros((b, max_gt), bool)
    for i in range(b):
        n = int(rng.integers(n_gt[0], n_gt[1] + 1))
        wh = rng.uniform(side[0], side[1], (n, 2))
        xy = rng.uniform(0, 1, (n, 2)) * (np.array([w, h]) - wh)
        boxes[i, :n] = np.concatenate([xy, xy + wh], 1)
        labels[i, :n] = rng.integers(1, classes + 1, n)
        valid[i, :n] = True
    return {"image": rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
            "boxes": boxes, "labels": labels, "valid": valid}


def move(x, dev):
    """A tensor, or a nest of NamedTuples of tensors, moved to ``dev``."""
    if isinstance(x, tuple):
        return type(x)(*(move(v, dev) for v in x))
    return None if x is None else x.to(dev)


# The train step with K3 against the same step with K3's plain version, on
# the card: about five times the largest readings over the six seeds of an
# earlier run (PERF.md; losses equal, gradients within 9.4e-7 of their norm
# and 1.34e-6 of their largest entry, parameters within 1.5e-8).
LIMITS_K3_VS_PLAIN = dict(loss=1e-6, grad_l2=5e-6, grad_max=1e-5, param=1e-7)


def relu_signs(torch):
    """A dispatch mode that keeps the sign of every ReLU input, in call
    order, on the host."""
    from torch.utils._python_dispatch import TorchDispatchMode

    relus = (torch.ops.aten.relu.default, torch.ops.aten.relu_.default)

    class ReluSigns(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.signs = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in relus:
                self.signs.append((args[0] > 0).cpu())
            return func(*args, **(kwargs or {}))

    return ReluSigns()


@contextlib.contextmanager
def plain_k3(torch, mcfg):
    """K3 replaced by its plain version (autograd of the plain forward) on
    the same device, inside the model's RoIAlign autograd function."""
    from podtpu_torch.ops import roi_align

    kernel = roi_align._backward_kernel

    def plain(grad_out, shapes, dtype, boxes, level, strides, out, ratio,
              channels_first):
        feats = [torch.empty(sh, dtype=dtype, device=boxes.device)
                 for sh in shapes]
        return roi_align.batched_roi_align_backward_plain(
            grad_out, feats, boxes, strides, out, ratio,
            canonical_scale=mcfg.roi_canonical_scale,
            canonical_level=mcfg.roi_canonical_level,
            channels_first=channels_first)

    roi_align._backward_kernel = plain
    try:
        yield
    finally:
        roi_align._backward_kernel = kernel


# Parameters whose exact gradient is 0: a constant added to a keypoint
# heatmap leaves its softmax as it was (the upsample's weights sum to 1), so
# the predictor's bias gets only the rounding of a sum whose terms cancel.
# Each run's is held under 1e-6 instead of against the other's.
ZERO_GRADIENTS = ("roi_heads.keypoint_predictor.kps_score_lowres.bias",)


def check_train_reference(torch, dev, seeds=range(SEED, SEED + 6),
                          model="faster"):
    """One train step of a small float32 model (``model`` one of
    ``MODELS``; a mask model's gt hold ellipse mask targets, a keypoint
    model's 17 keypoints each, and K3 also carries the extra head's 14x14
    gradient, so a step launches it twice) on the CPU (plain versions) and
    twice on the card, with K3 and with K3 swapped for its plain version;
    same weights, batch and draws per seed, TF32 off.  Each line
    counts the ReLU inputs whose sign differs between two runs: float32
    sums taken in another order move values near zero across it, and a
    gradient then passes in one run and not in the other.  At 128x128 a
    deep layer has few positions, so one such input can move a weight
    gradient by percent; the limits against the CPU are five times the
    largest readings over these seeds in an earlier run (PERF.md): losses
    within rtol 1e-4, each gradient within 3e-2 of its norm (relative L2)
    and 1.5e-1 of its largest entry, updated parameters within 2.5e-5.
    The two card runs share their forward, so K3 against its plain
    version is held to LIMITS_K3_VS_PLAIN.  The mask and keypoint models
    are held to the same limits.  A one-stage model (``ONE_STAGE``, its
    weights as initialised) launches no kernel in a step: its card run
    must launch none, and it has no plain-K3 run."""
    from podtpu_torch.core.config import Config, DataConfig
    from podtpu_torch.models.detector import init_parameters, make_detector
    from podtpu_torch.ops import _build
    from podtpu_torch.train.optim import make_optimizer
    from podtpu_torch.train.step import draw_train, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mcfg = model_config(model, image_size=(128, 128),
                        rpn_pre_nms_topk_train=128,
                        rpn_post_nms_topk_train=128, box_batch_per_image=32,
                        max_gt_boxes=8, compute_dtype="float32",
                        num_classes=4)
    one_stage = model in ONE_STAGE
    cfg = Config(model=mcfg, data=DataConfig(
        aug_policy=MODEL_POLICY.get(model, "miso")))

    def run(seed, batch, draws, device, swap):
        model = make_detector(mcfg)
        init_parameters(model, torch.Generator().manual_seed(seed))
        model = model.to(memory_format=torch.channels_last)
        step = make_train_step(model, make_optimizer(cfg.train, model), cfg,
                               device=device)
        signs = relu_signs(torch)
        _build.reset_launches()
        with (plain_k3(torch, mcfg) if swap else contextlib.nullcontext()):
            with signs:
                metrics = step(batch, 0.005, draws=move(draws, device))
        return ({k: float(v) for k, v in metrics.items()},
                {n: (p.detach().cpu(), p.grad.cpu())
                 for n, p in model.named_parameters() if p.grad is not None},
                signs.signs, sum(_build.launches.values()) if one_stage
                else _build.launches["roi_align_bwd"])

    def compare(ref, got):
        (lc, pc, sc, _), (lg, pg, sg, k3) = ref, got
        assert len(sc) == len(sg), "ReLU calls differ in number"
        zero = {n: pg[n][1] for n in ZERO_GRADIENTS if n in pc}
        pc = {n: v for n, v in pc.items() if n not in zero}
        return {
            "zero_gradient_max_abs": max(
                [float(g.abs().max()) for g in zero.values()], default=0.0),
            "loss_max_rel_err": max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12)
                                    for k in lc),
            "grad_max_err_over_tensor_max": max(
                (float((pg[n][1] - g).abs().max() / g.abs().max()), n)
                for n, (_, g) in pc.items()),
            "grad_max_rel_l2_err": max(
                (float((pg[n][1] - g).norm() / g.norm()), n)
                for n, (_, g) in pc.items()),
            "param_max_abs_err": max(float((pg[n][0] - p).abs().max())
                                     for n, (p, _) in pc.items()),
            "relu_sign_flips": sum(int((a != b).sum())
                                   for a, b in zip(sc, sg)),
            "k3_launches": k3, "finite": all(np.isfinite(v)
                                             for v in lg.values())}

    def within(r, limits):
        return (r["zero_gradient_max_abs"] <= 1e-6
                and r["loss_max_rel_err"] <= limits["loss"]
                and r["grad_max_rel_l2_err"][0] <= limits["grad_l2"]
                and r["grad_max_err_over_tensor_max"][0] <= limits["grad_max"]
                and r["param_max_abs_err"] <= limits["param"] and r["finite"])

    vs_cpu = dict(loss=1e-4, grad_l2=3e-2, grad_max=1.5e-1, param=2.5e-5)
    bad = []
    for seed in seeds:
        batch = {k: torch.from_numpy(v) for k, v in model_batch(
            model, np.random.default_rng(seed), 2, (128, 128), 8,
            n_gt=(1, 8), side=(8, 48)).items()}
        draws = draw_train(torch.Generator().manual_seed(seed), cfg, batch)
        cpu = run(seed, batch, draws, "cpu", False)
        rec = {"phase": phase_name(model, "train_reference"),
               "seed": seed,
               "losses_cpu": cpu[0], "trained_tensors": len(cpu[1]),
               "relu_inputs": sum(x.numel() for x in cpu[2])}
        k3 = run(seed, batch, draws, dev, False)
        rec["k3"] = compare(cpu, k3)
        if one_stage:
            # The card's step: the key keeps the records' shape; a
            # one-stage step launches no kernel (counted in k3_launches).
            if not (within(rec["k3"], vs_cpu) and k3[3] == 0):
                bad.append(seed)
            emit(rec)
            continue
        plain = run(seed, batch, draws, dev, True)
        rec["plain_k3"] = compare(cpu, plain)
        rec["k3_vs_plain_k3"] = compare(plain, k3)
        if not (within(rec["k3"], vs_cpu) and within(rec["plain_k3"], vs_cpu)
                and within(rec["k3_vs_plain_k3"], LIMITS_K3_VS_PLAIN)
                and k3[3] == (1 if head_of(model) is None else 2)
                and plain[3] == 0):
            bad.append(seed)
        emit(rec)
    torch.backends.cudnn.allow_tf32 = True
    if bad:
        raise AssertionError(f"train_reference out of its limits on seeds "
                             f"{bad}")


def train_breakdown(torch, model, optimizer, cfg, batch, gen, reps=5):
    """Median CUDA-event milliseconds of each part of the train step
    (draws and augmentation, forward and losses, backward, optimiser),
    between events recorded where ``make_train_step``'s ``mark`` hook says
    each part begins."""
    from podtpu_torch.train.step import make_train_step

    events = []

    def mark(part):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((part, ev))

    step = make_train_step(model, optimizer, cfg,
                           device=next(model.parameters()).device, mark=mark)
    times = {}
    for _ in range(reps):
        events.clear()
        step(batch, cfg.train.lr, generator=gen)
        events[-1][1].synchronize()
        for (part, start), (_, end) in zip(events, events[1:]):
            times.setdefault(part, []).append(start.elapsed_time(end))
    return {p: statistics.median(v) for p, v in times.items()}


KERNELS = ("nms", "roi_align_fwd", "roi_align_bwd")


def per_step_launches(model):
    """Our kernels' launches in one training step of ``model``: K1 once,
    K2 and K3 once (twice with a mask or keypoint head: the box head at
    7, the other at 14); none in a one-stage step."""
    if model in ONE_STAGE:
        return dict.fromkeys(KERNELS, 0)
    extra = head_of(model) is not None
    return {"nms": 1, "roi_align_fwd": 1 + extra, "roi_align_bwd": 1 + extra}


def train_slice(torch, card, dev, model="faster", warmup=3, timed=20,
                extra_steps=3):
    """Training at the ``TrainConfig`` defaults (batch 2, SGD, miso; the v2
    models under ``MODEL_POLICY``) on four seeded synthetic batches of 1-30
    gt boxes; for ``model`` "mask" (or "mask_v2"),
    Mask R-CNN, each gt holding an ellipse mask target at 1/8 of the
    canvas; for "keypoint", Keypoint R-CNN at the ``ModelConfig`` defaults
    (17 keypoints, a 512-channel head, 2 classes, the COCO flip
    permutation), each gt of the same batches holding 17 keypoints.
    ``warmup`` and ``timed`` steps: every loss finite, and per step K1
    once, K2 and K3 once (twice with a mask or keypoint head: the box head
    at 7, the other at 14; no kernel at all for a one-stage model).  The box model's trained weights go through a
    model directory and serve one batch; the mask model then takes
    ``extra_steps`` under ``DataConfig.copy_paste``, the keypoint model
    ``extra_steps`` with ``keypoint_roi_expand`` 1.3, launches held as
    before.  Then the step's parts (``mark`` hook; the extra head's branch
    too) and a profiler window.  Returns the launches, the images/s and
    ``replay``, which runs one more step on the first batch (for the
    keypoint model also ``replay_expand``, the same at 1.3)."""
    from podtpu_torch.core.config import Config, DataConfig
    from podtpu_torch.infer.inference import load_inference_model
    from podtpu_torch.models.detector import init_parameters, make_detector
    from podtpu_torch.ops import _build
    from podtpu_torch.train.checkpoints import save_labels, save_model
    from podtpu_torch.train.optim import make_optimizer
    from podtpu_torch.train.step import images_to_float, make_train_step

    head = head_of(model)
    kps = head == "keypoint"
    cfg = Config(model=model_config(model, **({} if kps
                                              else dict(num_classes=4))),
                 data=DataConfig(aug_policy=MODEL_POLICY.get(model, "miso")))
    mcfg = cfg.model
    prefix = phase_name(model, "")
    loss_name = {"mask": "loss_mask", "keypoint": "loss_keypoint"}.get(head)
    labels = ["radiolarian", "foraminifera", "diatom"]
    net = make_detector(mcfg)
    init_parameters(net, torch.Generator().manual_seed(SEED))
    net = net.to(memory_format=torch.channels_last)
    optimizer = make_optimizer(cfg.train, net)
    step = make_train_step(net, optimizer, cfg, device=dev)
    rng = np.random.default_rng(SEED)
    batches = [synthetic_batch(rng, cfg.train.batch_size, mcfg.image_size,
                               mcfg.max_gt_boxes) for _ in range(4)]
    if head == "mask":
        batches = [dict(b, masks=ellipse_masks(b["boxes"], b["valid"],
                                               mcfg.image_size))
                   for b in batches]
    elif kps:  # one foreground class; keypoints from a stream of their own
        kp_rng = np.random.default_rng(SEED + 15)
        batches = [with_keypoints(dict(b, labels=b["valid"].astype(
            np.int32)), kp_rng, mcfg.num_keypoints) for b in batches]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lr = cfg.train.lr
    t0 = time.perf_counter()
    for i in range(warmup):
        m = step(batches[i % len(batches)], lr, generator=gen)
        assert all(np.isfinite(float(v)) for v in m.values()), m
    warm_s = time.perf_counter() - t0
    per_step = per_step_launches(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    step_s, losses = [], []

    def held_step(run, i):
        """One step: its losses, all finite, and its launches, as
        ``per_step`` says."""
        before = {k: _build.launches[k] for k in per_step}
        vals = {k: float(v) for k, v in run(batches[i % len(batches)], lr,
                                            generator=gen).items()}
        if not all(np.isfinite(v) for v in vals.values()) or (
                loss_name and loss_name not in vals):
            raise AssertionError(f"{prefix}train step {i}: losses {vals}")
        got = {k: _build.launches[k] - before[k] for k in per_step}
        if got != per_step:
            raise AssertionError(f"{prefix}train step {i}: launches {got}, "
                                 f"expected {per_step}")
        return vals

    t_all = time.perf_counter()
    for i in range(timed):
        t0 = time.perf_counter()
        losses.append(held_step(step, i))  # waits for the step
        step_s.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_all
    launches = {k: _build.launches[k] for k in per_step}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    lat = sorted(step_s)
    rec = {"phase": prefix + "train", "model": model_title(model),
           "image_size": list(mcfg.image_size),
           "compute_dtype": mcfg.compute_dtype,
           "batch_size": cfg.train.batch_size,
           "optimiser": cfg.train.optimiser, "lr": lr,
           "aug_policy": cfg.data.aug_policy,
           "gt_boxes": [int(b["valid"].sum()) for b in batches],
           "warmup_steps": warmup, "warmup_s": warm_s, "steps": timed,
           "wall_s": wall,
           "images_per_s": timed * cfg.train.batch_size / wall,
           "step_ms_p50": statistics.median(lat) * 1e3,
           "step_ms_max": lat[-1] * 1e3,
           "loss_first": losses[0], "loss_last": losses[-1],
           "peak_memory_gib": peak, "launches": launches,
           "launches_per_step": {k: v / timed for k, v in launches.items()},
           "card": card}

    out = {}
    if head == "mask":
        cp_cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, copy_paste=True))
        cp_step = make_train_step(net, optimizer, cp_cfg, device=dev)
        rec.update(mask_pool_size=mcfg.mask_pool_size,
                   mask_resolution=mcfg.mask_resolution,
                   mask_targets=list(batches[0]["masks"].shape[2:]),
                   copy_paste_steps=extra_steps,
                   copy_paste_losses=[held_step(cp_step, i)
                                      for i in range(extra_steps)])
    elif kps:
        # The same model with its keypoint RoIs expanded by 1.3.
        ex_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            mcfg, keypoint_roi_expand=1.3))
        net.cfg = ex_cfg.model
        ex_step = make_train_step(net, optimizer, ex_cfg, device=dev)
        rec.update(num_keypoints=mcfg.num_keypoints,
                   keypoint_head_channels=mcfg.keypoint_head_channels,
                   keypoint_pool_size=mcfg.keypoint_pool_size,
                   keypoint_resolution=mcfg.keypoint_resolution,
                   keypoint_hflip_inds=list(mcfg.keypoint_hflip_inds),
                   visible_keypoints=[int((b["keypoints"][..., 2] > 0).sum())
                                      for b in batches],
                   expand_steps=extra_steps,
                   expand_losses=[held_step(ex_step, i)
                                  for i in range(extra_steps)])
        net.cfg = mcfg

        def replay_expand():
            net.cfg = ex_cfg.model
            try:
                return ex_step(batches[0], lr, generator=gen)
            finally:
                net.cfg = mcfg

        out["replay_expand"] = replay_expand
    else:
        # The trained weights as a model directory, served one batch.
        with tempfile.TemporaryDirectory() as model_dir:
            save_model(model_dir, net, mcfg, labels)
            save_labels(model_dir, labels)
            forward, served, _, got_labels = load_inference_model(
                model_dir, device=dev)
            det = forward(batches[0]["image"])
            torch.cuda.synchronize()
        assert got_labels == labels
        assert det.boxes.shape == (cfg.train.batch_size,
                                   mcfg.detections_per_image, 4)
        assert bool(torch.isfinite(det.boxes).all()) and \
            bool(torch.isfinite(det.scores).all())
        same = all(torch.equal(a, b) for a, b in zip(
            served.state_dict().values(), net.state_dict().values()))
        if not same:
            raise AssertionError("the served model's weights differ from "
                                 "the trained ones")
        rec["served_detections"] = int(det.valid.sum())
        del served, forward, det
    emit(rec)

    parts = train_breakdown(torch, net, optimizer, cfg, batches[0], gen)
    if head:
        dev_batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in batches[0].items()}
        parts.update(branch_ms(torch, net, model,
                               images_to_float(dev_batch["image"]),
                               dev_batch, cfg))

    def replay():
        return step(batches[0], lr, generator=gen)

    prof = device_profile(torch, replay, reps=3, unit="step")
    emit({"phase": prefix + "train_breakdown",
          "batch_size": cfg.train.batch_size, "parts_ms": parts,
          "profile": prof, "card": card})
    return dict(out, launches=launches, images_per_s=rec["images_per_s"],
                replay=replay)


# -- phases 8 and 9: the training driver and batch inference -----------------

DRIVER_LABELS = ["radiolarian", "foraminifera", "diatom"]


def in_memory_images(rng, n, size, with_boxes=True):
    """``n`` seeded canvases, path -> uint8 image, and their boxes: dark
    noise with 1-30 filled boxes of 16-256 px, a brightness per label."""
    from podtpu_torch.data import ImageMetadata, RectangleAnnotation

    batch = synthetic_batch(rng, n, size, 30, classes=len(DRIVER_LABELS))
    images, metas = {}, []
    for i in range(n):
        img = (batch["image"][i] // 3).copy()
        meta = ImageMetadata(f"{'driver' if with_boxes else 'infer'}_{i:03d}"
                             ".png", "/in-memory", dataset_id=1, frame_id=i)
        valid = batch["valid"][i]
        for (x1, y1, x2, y2), lab in zip(batch["boxes"][i][valid],
                                         batch["labels"][i][valid]):
            img[int(y1):int(y2), int(x1):int(x2)] = 120 + 40 * int(lab)
            if with_boxes:
                meta.add_annotation(RectangleAnnotation(
                    x1, y1, x2 - x1, y2 - y1, DRIVER_LABELS[lab - 1]))
        images[meta.full_path] = img
        metas.append(meta)
    return images, metas


@contextlib.contextmanager
def driver_hooks(torch, driver, rec):
    """Record, without extra device syncs, what one ``train()`` call does:
    each epoch's start and loader (the train loader's ``set_epoch``,
    whichever loader the run takes), its steps and their loss tensors, its eval (stats,
    batches, start and end), its scheduler loss and its checkpoint's end.
    Steps are counted where ``train()`` dispatches them: a streamed step, a
    cached single step, or a group of K (a graph replay on the card, which
    calls no Python step).  Where ``rec`` holds a ``batches`` list, each
    cached step's dataset indices and image weights go there (one read of
    the arrays' ``index`` field per arrays); where it holds ``states``,
    the model's state at each checkpoint.  ``rec["multi"]`` is the run's
    K-step runner, if it made one."""
    names = ("Loader", "DeviceLoader", "WindowedStreamLoader",
             "make_train_step", "make_cached_train_step",
             "make_cached_multi_step", "evaluate", "make_scheduler")
    saved = {k: getattr(driver, k) for k in names}
    save_ckpt = driver.ckpt.save_train_checkpoint
    inside = [0]   # > 0 while a cached step or group runs the step
    index_of = {}  # id(arrays) -> their index field on the host

    def recorded(cls):
        class Recorded(cls):
            def set_epoch(self, epoch):
                rec["epochs"].append({"epoch": epoch,
                                      "start": time.perf_counter(),
                                      "steps": 0, "loader": cls.__name__})
                super().set_epoch(epoch)

        return Recorded

    def count(metrics, arrays=None, idx=None, weights=None):
        losses = metrics["loss"].reshape(-1)
        rec["epochs"][-1]["steps"] += losses.numel()
        rec["step_losses"].extend(losses.unbind())
        if arrays is not None and rec.get("batches") is not None:
            key = id(arrays)
            if key not in index_of:
                index_of.clear()
                index_of[key] = arrays["index"].cpu().numpy()
            ids = index_of[key][np.asarray(idx).reshape(losses.numel(), -1)]
            rec["batches"].extend(zip(ids, np.asarray(weights).reshape(
                losses.numel(), -1)))

    def make_train_step(*args, **kwargs):
        step = saved["make_train_step"](*args, **kwargs)

        def counted(batch, lr, **kw):
            metrics = step(batch, lr, **kw)
            if not inside[0]:  # a streamed step
                count(metrics)
            return metrics

        return counted

    def dispatched(make):
        def wrapped(*args, **kwargs):
            run = make(*args, **kwargs)
            if hasattr(run, "captures"):
                rec["multi"] = run

            def counted(arrays, idx, image_weight, *rest, **kw):
                inside[0] += 1
                try:
                    metrics = run(arrays, idx, image_weight, *rest, **kw)
                finally:
                    inside[0] -= 1
                count(metrics, arrays, idx, image_weight)
                return metrics

            return counted

        return wrapped

    def evaluate(forward, loader, *args, **kwargs):
        t0 = time.perf_counter()
        ev, stats = saved["evaluate"](forward, loader, *args, **kwargs)
        last = rec["epochs"][-1] if rec["epochs"] else {}
        last.update(eval_start=t0, eval_end=time.perf_counter(),
                    eval_batches=len(loader),
                    eval_images=len(loader.indices), stats=list(stats),
                    segm_stats=getattr(ev, "segm_stats", None),
                    keypoints_stats=getattr(ev, "keypoints_stats", None))
        return ev, stats

    def make_scheduler(*args, **kwargs):
        sched = saved["make_scheduler"](*args, **kwargs)
        step = sched.step

        def logged(epoch, loss):
            rec["epochs"][-1]["loss"] = loss
            return step(epoch, loss)

        sched.step = logged
        return sched

    def save_train_checkpoint(*args, **kwargs):
        save_ckpt(*args, **kwargs)
        if rec.get("states") is not None:
            rec["states"].append({k: v.detach().cpu().clone() for k, v
                                  in args[1].state_dict().items()})
        rec["epochs"][-1]["end"] = time.perf_counter()

    for k, v in (("Loader", recorded(saved["Loader"])),
                 ("DeviceLoader", recorded(saved["DeviceLoader"])),
                 ("WindowedStreamLoader",
                  recorded(saved["WindowedStreamLoader"])),
                 ("make_train_step", make_train_step),
                 ("make_cached_train_step",
                  dispatched(saved["make_cached_train_step"])),
                 ("make_cached_multi_step",
                  dispatched(saved["make_cached_multi_step"])),
                 ("evaluate", evaluate), ("make_scheduler", make_scheduler)):
        setattr(driver, k, v)
    driver.ckpt.save_train_checkpoint = save_train_checkpoint
    try:
        yield rec
    finally:
        for k, v in saved.items():
            setattr(driver, k, v)
        driver.ckpt.save_train_checkpoint = save_ckpt


def driven(torch, driver, fn, *args, keep=(), **kwargs):
    """``fn(*args, **kwargs)`` with the launch counts set to 0 just before
    and read just after, its printout sent to stderr, and the driver's
    hooks recording (``keep``: "batches", "states", as ``driver_hooks``
    says); returns (result, launches, record, seconds)."""
    from podtpu_torch.ops import _build

    rec = {"epochs": [], "step_losses": [], **{k: [] for k in keep}}
    with driver_hooks(torch, driver, rec), \
            contextlib.redirect_stdout(sys.stderr):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: _build.launches[k]
                    for k in ("nms", "roi_align_fwd", "roi_align_bwd")}
    return out, launches, rec, seconds


def check_driver_launches(name, launches, steps, eval_batches):
    """K3 once per train step; K1 and K2 at least once per step and eval
    batch (K1 runs twice per eval batch: RPN and postprocess)."""
    want = {"roi_align_bwd": steps,
            "nms": steps + eval_batches, "roi_align_fwd": steps + eval_batches}
    if launches["roi_align_bwd"] != steps or any(
            launches[k] < v for k, v in want.items()):
        raise AssertionError(f"{name}: launches {launches}, expected K3 = "
                             f"{steps} and K1, K2 >= {steps + eval_batches}")


# The drivers' epoch losses in PR 11's run (streamed batches, one step at a
# time, torch's SGD), the same on every run of that PR.
PR11_EPOCH_LOSSES = {
    "driver": [1.633754348754883, 0.9547824859619141, 0.9167163848876954],
    "fcos_driver": [3.3219535827636717, 2.284153366088867],
    "retinanet_v2_driver": [1.9449041366577149, 1.2939629554748535]}


def dispatch_record(phase, losses, *recs):
    """A driver phase's epoch losses (beside PR 11's, where it had them)
    and what each ``train()`` call's K-step runner did."""
    out = {"epoch_losses": losses, "graph": [
        None if r.get("multi") is None else {
            "captures": r["multi"].captures, "replays": r["multi"].replays,
            "capture_s": r["multi"].capture_s,
            "launches_per_replay": r["multi"].launches_per_replay}
        for r in recs]}
    if phase in PR11_EPOCH_LOSSES:
        want = PR11_EPOCH_LOSSES[phase]
        out.update(epoch_losses_pr11=want,
                   epoch_losses_equal_to_pr11=losses == want,
                   epoch_loss_gaps_to_pr11=[abs(a - b) / abs(b)
                                            for a, b in zip(losses, want)])
    return out


def epoch_lines(rec, batch_size):
    out = []
    for e in rec["epochs"]:
        train_s = e["eval_start"] - e["start"]
        eval_s = e["eval_end"] - e["eval_start"]
        out.append({"epoch": e["epoch"], "steps": e["steps"],
                    "wall_s": e["end"] - e["start"], "train_s": train_s,
                    "eval_s": eval_s,
                    "train_images_per_s": e["steps"] * batch_size / train_s,
                    "eval_images_per_s": e["eval_images"] / eval_s,
                    "eval_share": eval_s / (e["end"] - e["start"]),
                    "loss": e["loss"], "stats": e["stats"]})
    return out


def check_loader_place(torch, project, dev, size):
    """The train ``Loader``'s batches copied to ``dev`` (on its side
    stream, from pinned memory) equal its host batches, for one shuffled
    epoch."""
    from podtpu_torch.data.dataset import DetectionDataset
    from podtpu_torch.data.loader import Loader

    ds = DetectionDataset(project, image_size=size, max_gt=100,
                          label_names=DRIVER_LABELS, cache=False)
    kw = dict(batch_size=2, shuffle=True, seed=0, num_workers=2)
    same = True
    for (host, hv), (placed, pv) in zip(Loader(ds, **kw),
                                        Loader(ds, place=dev, **kw)):
        same &= bool((hv == pv).all()) and set(host) == set(placed)
        same &= all(placed[k].device.type == torch.device(dev).type
                    and torch.equal(placed[k].cpu(),
                                    torch.from_numpy(host[k]))
                    for k in host)
    return same


def driver_phase(torch, card, dev, step_loop_images_per_s, config=None,
                 size=(1024, 1024), n_images=24):
    """``train()`` on a seeded in-memory project (2 epochs on the device
    cache with graphs, then resumed for a third streamed through the
    ``Loader``, ``device_data_cache=False``), ``evaluate_model`` on its 4
    test images, and checks.
    Returns the model directory's parent (a temporary directory), the
    model directory, the launches by path and the K1 and K2 inputs of one
    ``evaluate_model`` batch."""
    from podtpu_torch.core.config import Config
    from podtpu_torch.data import Project, imageio
    from podtpu_torch.data.dataset import train_test_split
    from podtpu_torch.infer.inference import load_inference_model
    from podtpu_torch.ops import nms
    from podtpu_torch.train import train as driver
    from podtpu_torch.train.checkpoints import load_train_checkpoint

    images, metas = in_memory_images(np.random.default_rng(SEED + 8),
                                     n_images, size)
    project = Project()
    for m in metas:
        project.add_image(m)
    tmp = tempfile.mkdtemp(prefix="podtpu_driver_")
    kw = dict(output_dir=tmp, name="driver", batch_size=2, seed=0,
              config=config, device=dev)
    # The dataset first tries the native decoder on each batch; it cannot
    # open the /in-memory paths, returns None, and the dataset decodes per
    # sample through read_rgb, which finds the arrays here.
    read_rgb = imageio.read_rgb
    imageio.read_rgb = images.__getitem__
    try:
        torch.cuda.reset_peak_memory_stats()
        model_dir, first, rec1, s1 = driven(torch, driver, driver.train,
                                            project, max_epochs=2,
                                            keep=("batches", "states"), **kw)
        after_first = load_train_checkpoint(model_dir)["epoch"]
        # The resumed epoch streams from the host: the Loader's path.
        base = config or Config()
        streamed = dataclasses.replace(base, data=dataclasses.replace(
            base.data, device_data_cache=False))
        _, resumed, rec2, s2 = driven(torch, driver, driver.train, project,
                                      max_epochs=3, resume=True,
                                      **dict(kw, config=streamed))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        _, test_idx = train_test_split(len(metas), 0.2, 1)
        test_project = Project()
        for i in test_idx:
            test_project.add_image(metas[int(i)])
        stats, evaluated, rec3, s3 = driven(
            torch, driver, driver.evaluate_model, test_project, model_dir,
            batch_size=2, device=dev)
        with contextlib.redirect_stdout(sys.stderr):
            _, loaded, _, labels = load_inference_model(model_dir, device=dev)
            loaded_on = next(loaded.parameters()).device.type
            del loaded
            # One batch of evaluate_model (its first two test images), its
            # K1 and K2 inputs captured for the checks against the plain
            # versions, outside the counted run.
            one_batch = Project()
            for i in test_idx[:2]:
                one_batch.add_image(metas[int(i)])
            nms_calls = []

            def eval_one_batch():
                nms_calls.extend(capture_nms(
                    nms, lambda: driver.evaluate_model(
                        one_batch, model_dir, batch_size=2, device=dev)))

            roi_calls = capture_roi_align(eval_one_batch)
        placed = check_loader_place(torch, project, dev, size)
    finally:
        imageio.read_rgb = read_rgb
    epochs = epoch_lines(rec1, 2) + epoch_lines(rec2, 2)
    steps1 = sum(e["steps"] for e in rec1["epochs"])
    steps2 = sum(e["steps"] for e in rec2["epochs"])
    losses = [float(v) for v in rec1["step_losses"] + rec2["step_losses"]]
    last = rec2["epochs"][-1]
    artifacts = {name: os.path.exists(os.path.join(model_dir, name))
                 for name in ("model.msgpack", "config.json", "labels.txt",
                              "results.txt", "results_per_class.txt",
                              "checkpoint.pt")}
    stats_gap = max(abs(a - b) for a, b in zip(stats, last["stats"]))
    train_s = sum(e["train_s"] for e in epochs[1:])
    train_images = sum(e["steps"] * 2 for e in epochs[1:])
    rec = {"phase": "driver", "model": "faster_rcnn_resnet50_fpn",
           "image_size": list(size), "images": n_images,
           "train_images": n_images - len(test_idx),
           "test_images": len(test_idx), "batch_size": 2,
           "decode": "podtpu_torch.data.imageio.read_rgb replaced by a "
                     "seeded in-memory reader keyed by path (no image "
                     "files, no image library needed)",
           "epochs": epochs, "steps": steps1 + steps2,
           "train_call_s": [s1, s2], "evaluate_model_s": s3,
           "resumed_from_epoch": after_first,
           "resumed_first_epoch": rec2["epochs"][0]["epoch"],
           "loaders": [e["loader"] for e in rec1["epochs"] + rec2["epochs"]],
           "train_images_per_s_steady": train_images / train_s,
           "step_loop_images_per_s": step_loop_images_per_s,
           "driver_over_step_loop": step_loop_images_per_s
           / (train_images / train_s),
           "eval_images_per_s": [e["eval_images_per_s"] for e in epochs],
           **dispatch_record("driver", [e["loss"] for e in epochs], rec1,
                             rec2),
           "stats": last["stats"], "evaluate_model_stats": stats,
           "evaluate_model_max_gap": stats_gap, "labels": labels,
           "artifacts": artifacts, "loaded_on": loaded_on,
           "launches": {"train": first, "train_resumed": resumed,
                        "evaluate_model": evaluated},
           "peak_memory_gib": peak, "loader_place_equal": placed,
           "card": card}
    emit(rec)
    bad = []
    if not all(np.isfinite(v) for v in losses) or len(losses) != (
            steps1 + steps2):
        bad.append("a logged loss is not finite")
    if after_first != 1 or rec["resumed_first_epoch"] != 2:
        bad.append("the resumed run did not start at epoch 2")
    if rec["loaders"] != ["DeviceLoader", "DeviceLoader", "Loader"] \
            or rec1.get("multi") is None or rec2.get("multi") is not None:
        bad.append(f"loaders {rec['loaders']}: expected two cached epochs "
                   f"with a K-step runner, then one through the Loader")
    if not all(artifacts.values()) or loaded_on != torch.device(dev).type \
            or sorted(labels) != sorted(DRIVER_LABELS):
        bad.append(f"artifacts {artifacts}, loaded on {loaded_on}")
    if len(stats) != 12 or not all(np.isfinite(v) and -1 <= v <= 1
                                   for v in stats + last["stats"]):
        bad.append("stats not finite or outside [-1, 1]")
    if stats_gap > 0.01:
        bad.append(f"evaluate_model differs from the last epoch's eval by "
                   f"{stats_gap}")
    if not placed:
        bad.append("the Loader's batches placed on the card differ from "
                   "its host batches")
    if len(nms_calls) != 2 or len(roi_calls) != 1:
        bad.append(f"one evaluate_model batch made {len(nms_calls)} K1 and "
                   f"{len(roi_calls)} K2 calls, expected 2 and 1")
    for name, launches, recd in (("train", first, rec1),
                                 ("train_resumed", resumed, rec2)):
        check_driver_launches(
            name, launches, sum(e["steps"] for e in recd["epochs"]),
            sum(e["eval_batches"] for e in recd["epochs"]))
    check_driver_launches("evaluate_model", evaluated, 0,
                          -(-len(test_idx) // 2))
    if bad:
        raise AssertionError(f"driver: {bad}")
    steps0 = rec1["epochs"][0]["steps"]
    first_epoch = {"batches": rec1["batches"][:steps0],
                   "loss": rec1["epochs"][0]["loss"],
                   "state": rec1["states"][0],
                   "train_images_per_s": epochs[0]["train_images_per_s"]}
    return tmp, model_dir, {"driver": {k: first[k] + resumed[k]
                                       for k in first},
                            "evaluate_model": evaluated}, (
        nms_calls, roi_calls), first_epoch


def kept_boxes(result, metas):
    """Per image, the annotations ``infer`` kept, as ``[x, y, w, h,
    score]`` rows."""
    return [np.array([[b.x, b.y, b.width, b.height, b.score]
                      for b in result.image_dict[m.id].boxes], np.float64)
            .reshape(-1, 5) if m.id in result.image_dict
            else np.zeros((0, 5)) for m in metas]


def infer_phase(torch, card, dev, model_dir, size=(1024, 1024), n=8):
    """``infer()`` over ``n`` unlabelled in-memory images at batch 4 with
    the trained model directory: at threshold 0.5 (the counted run), at 0
    (every detection's score) and at the median of those scores, where
    boxes must be kept.  Every kept box is finite, scores lie above the
    threshold and at most 1, and boxes lie inside the canvas divided by
    the image's scale.  Returns the launches of the counted run and the K1
    and K2 inputs of the median run's first batch."""
    from podtpu_torch.data import Project, imageio
    from podtpu_torch.infer import inference
    from podtpu_torch.ops import nms
    from podtpu_torch.train import train as driver

    images, metas = in_memory_images(np.random.default_rng(SEED + 9), n,
                                     size, with_boxes=False)
    project = Project()
    for m in metas:
        project.add_image(m)
    load = inference.load_inference_model
    load_s = []

    def timed_load(*args, **kwargs):
        t0 = time.perf_counter()
        out = load(*args, **kwargs)
        torch.cuda.synchronize()
        load_s.append(time.perf_counter() - t0)
        return out

    def run(threshold):
        return inference.infer(project, model_dir, threshold=threshold,
                               batch_size=4, device=dev)

    # As in driver_phase: the native decoder fails on the /in-memory paths
    # and each batch falls back to read_rgb, which finds the arrays here.
    read_rgb = imageio.read_rgb
    imageio.read_rgb = images.__getitem__
    inference.load_inference_model = timed_load
    try:
        result, launches, _, seconds = driven(torch, driver, run, 0.5)
        with contextlib.redirect_stdout(sys.stderr):
            every = kept_boxes(run(0.0), metas)
            scores = np.concatenate([k[:, 4] for k in every])
            median = float(np.median(scores)) if len(scores) else 1.0
            nms_calls = []

            def median_run():
                nms_calls.extend(capture_nms(
                    nms, lambda: median_result.append(run(median)), limit=2))

            median_result = []
            roi_calls = capture_roi_align(median_run, limit=1)
    finally:
        imageio.read_rgb = read_rgb
        inference.load_inference_model = load
    passes = {0.5: kept_boxes(result, metas), 0.0: every,
              median: kept_boxes(median_result[0], metas)}
    bad = []
    for threshold, kept in passes.items():
        for m, k in zip(metas, kept):
            # The canvas is ``size``; an image's scale is fit_resize's.
            h, w = images[m.full_path].shape[:2]
            scale = min(size[0] / h, size[1] / w)
            x, y, bw, bh, sc = k.T
            if not (np.isfinite(k).all() and (sc > threshold).all()
                    and (sc <= 1).all() and (bw >= 0).all()
                    and (bh >= 0).all() and (x >= 0).all()
                    and (y >= 0).all()
                    and (x + bw <= size[1] / scale + 1e-3).all()
                    and (y + bh <= size[0] / scale + 1e-3).all()):
                bad.append(f"threshold {threshold}: a box of {m.id} is not "
                           "finite, above the threshold or inside the "
                           "canvas")
    kept_median = [len(k) for k in passes[median]]
    if not sum(kept_median):
        bad.append(f"no box kept at the median score {median}")
    rec = {"phase": "infer", "images": n, "batch_size": 4,
           "threshold": 0.5, "wall_s": seconds, "model_load_s": load_s[0],
           "images_per_s": n / seconds,
           "images_per_s_after_load": n / (seconds - load_s[0]),
           "annotations_per_image": [len(k) for k in passes[0.5]],
           "detections_per_image": [len(k) for k in every],
           "median_score": median,
           "annotations_per_image_at_median": kept_median,
           "launches": launches, "card": card}
    emit(rec)
    batches = -(-n // 4)
    if launches["nms"] < 2 * batches or launches["roi_align_fwd"] < batches \
            or launches["roi_align_bwd"]:
        bad.append(f"launches {launches}")
    if len(nms_calls) != 2 or len(roi_calls) != 1:
        bad.append(f"captured {len(nms_calls)} K1 and {len(roi_calls)} K2 "
                   "calls of one batch, expected 2 and 1")
    if bad:
        raise AssertionError(f"infer: {bad}")
    return launches, (nms_calls, roi_calls)


CLI_LABEL_IDS = {name: 10 + i for i, name in enumerate(DRIVER_LABELS)}


def png_bytes(img) -> bytes:
    """An 8-bit RGB PNG of ``img`` ``[H, W, 3]`` uint8, written with the
    standard library (no image library needed)."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def native_build_line():
    """Build the native host library (decode, COCO matcher) before any
    timed path, and say whether it built; on failure, the compiler's last
    lines."""
    from podtpu_torch.core import native

    t0 = time.perf_counter()
    try:
        native.build()
        error = None
    except RuntimeError as exc:
        error = str(exc).strip().splitlines()[-12:]
    built = error is None and native.available()
    rec = {"phase": "native_build", "built": built,
           "seconds": time.perf_counter() - t0,
           "library": str(native.LIB_PATH), "compiler_tail": error}
    emit(rec)
    return built


def cli_phase(torch, card, dev, native_built, size=1024, n=16):
    """The port's commands through ``podtpu_torch.cli.main`` against the
    repository's fake CVAT server (``tests/fake_cvat.py``): task 5 holds
    ``n`` seeded PNG frames at ``size``^2 with 1-30 filled boxes of 16-256
    px in three labels, task 6 the same frames unlabelled, both under
    ``<root>/7/raw``.  ``train-object-detector`` for 2 epochs at batch 2 and
    the default 1024 canvas, then ``infer-object-detector`` on task 6 at
    threshold 0.05 and at 0, whose upload must carry shapes, each with 4
    integer points and a known label id.  Where Pillow imports,
    ``crop-objects`` (crops sorted by class) and
    ``infer-object-detector-directory`` (at threshold 0, crops written) run
    too.  The frames decode through the native library when it built, else
    through Pillow (the per-sample fallback), else through a lookup of the
    seeded arrays (``imageio.read_rgb`` replaced; no device path or kernel
    is).  One line per command; returns the launches by command and the K1
    and K2 inputs of one ``evaluate_model`` batch of the trained model."""
    from podtpu_torch import cli
    from podtpu_torch.data import imageio
    from podtpu_torch.data.cvat.client import CvatTask
    from podtpu_torch.infer import inference
    from podtpu_torch.ops import nms
    from podtpu_torch.train import train as driver
    from tests.fake_cvat import FakeCvatServer, FakeCvatState

    images, metas = in_memory_images(np.random.default_rng(SEED + 10), n,
                                     (size, size))
    tmp = tempfile.mkdtemp(prefix="podtpu_cli_")
    raw = os.path.join(tmp, "cvat", "7", "raw")
    os.makedirs(raw)
    frames, shapes, lookup = [], [], {}
    for i, m in enumerate(metas):
        name = f"frame_{i:03d}.png"
        with open(os.path.join(raw, name), "wb") as fp:
            fp.write(png_bytes(images[m.full_path]))
        lookup[os.path.join(raw, name)] = images[m.full_path]
        frames.append(name)
        for b in m.boxes:
            x1, y1, x2, y2 = b.coords
            shapes.append({"id": len(shapes) + 1, "type": "rectangle",
                           "frame": i, "label_id": CLI_LABEL_IDS[b.label],
                           "points": [x1, y1, x2, y2], "outside": False})
    labels = [{"id": v, "name": k, "color": "#ffffff"}
              for k, v in CLI_LABEL_IDS.items()]
    state = FakeCvatState()
    state.add_task(5, "cli_labelled", labels, frames, shapes=shapes)
    state.add_task(6, "cli_unlabelled", labels, frames)
    pillow = importlib.util.find_spec("PIL") is not None
    if native_built:
        decode = ("native: podtpu_torch.core.native.decode_resize_batch on "
                  "the PNG files")
    elif pillow:
        decode = ("pillow: the native library did not build, so each batch "
                  "falls back to podtpu_torch.data.imageio.read_rgb (Pillow) "
                  "and fit_resize per sample, as the JAX package does")
    else:
        decode = ("lookup: neither the native library nor Pillow is "
                  "available, so podtpu_torch.data.imageio.read_rgb is "
                  "replaced by a lookup of the seeded arrays by path")
    load = inference.load_inference_model
    load_s = []

    def timed_load(*args, **kwargs):
        t0 = time.perf_counter()
        out = load(*args, **kwargs)
        torch.cuda.synchronize()
        load_s.append(time.perf_counter() - t0)
        return out

    read_rgb = imageio.read_rgb
    if not (native_built or pillow):
        imageio.read_rgb = lookup.__getitem__
    inference.load_inference_model = timed_load
    out_dir = os.path.join(tmp, "models")
    lines, bad = {}, []
    batches = -(-n // 2)

    def check_infer_launches(name, launches):
        if launches["nms"] < 2 * batches or launches[
                "roi_align_fwd"] < batches or launches["roi_align_bwd"]:
            bad.append(f"{name}: launches {launches}")

    try:
        with FakeCvatServer(state) as srv:
            common = ["--server", srv.url, "--image-root",
                      os.path.join(tmp, "cvat")]
            argv = ["train-object-detector", "--tasks", "5", *common,
                    "--max-epochs", "2", "--alrs-epochs", "2", "-o", out_dir,
                    "-m", "cli_model",
                    *([] if size == 1024 else ["--image-size", str(size)])]
            _, launches, rec, seconds = driven(
                torch, driver, cli.main, argv, device=dev)
            steps = sum(e["steps"] for e in rec["epochs"])
            eval_batches = sum(e["eval_batches"] for e in rec["epochs"])
            check_driver_launches("cli train-object-detector", launches,
                                  steps, eval_batches)
            lines["train"] = {
                "phase": "cli", "command": "train-object-detector",
                "argv": argv[:3] + argv[7:11], "image_size": size,
                "batch_size": 2, "epochs": len(rec["epochs"]),
                "steps": steps, "eval_batches": eval_batches,
                "wall_s": seconds, "images_per_s": steps * 2 / seconds,
                "model_load_s": None,
                "epoch_losses": [e["loss"] for e in rec["epochs"]],
                "stats": rec["epochs"][-1]["stats"], "launches": launches,
                "decode": decode, "shapes_uploaded": None, "card": card}
            emit(lines["train"])
            if not all(np.isfinite(float(v)) for v in rec["step_losses"]):
                bad.append("a train loss is not finite")
            model_dir = os.path.join(out_dir, "cli_model")
            for threshold in ("0.05", "0"):
                before = len(state.patches)
                del load_s[:]
                argv = ["infer-object-detector", "--tasks", "6", *common,
                        "--model-dir", out_dir, "--model", "cli_model",
                        "--threshold", threshold]
                _, launches, _, seconds = driven(torch, driver, cli.main,
                                                 argv, device=dev)
                uploads = [p for p in state.patches[before:]
                           if "annotations?action=create" in p["path"]]
                sent = [s for p in uploads for s in p["body"]["shapes"]]
                check_infer_launches(f"infer {threshold}", launches)
                if len(uploads) != 1 or not all(
                        s["type"] == "rectangle" and len(s["points"]) == 4
                        and all(isinstance(v, int) for v in s["points"])
                        and s["label_id"] in CLI_LABEL_IDS.values()
                        for s in sent):
                    bad.append(f"infer {threshold}: uploads {len(uploads)}, "
                               "a shape without 4 integer points or a "
                               "known label")
                if threshold == "0" and not sent:
                    bad.append("infer at threshold 0 uploaded no shape")
                lines[f"infer_{threshold}"] = {
                    "phase": "cli", "command": "infer-object-detector",
                    "argv": argv[:3] + argv[7:], "images": n,
                    "batch_size": 2, "wall_s": seconds,
                    "images_per_s": n / seconds, "model_load_s": load_s[0],
                    "images_per_s_after_load": n / (seconds - load_s[0]),
                    "launches": launches, "decode": decode,
                    "shapes_uploaded": len(sent), "card": card}
                emit(lines[f"infer_{threshold}"])
            if pillow:
                crops = os.path.join(tmp, "crops")
                argv = ["crop-objects", "--tasks", "5", *common, "-o", crops]
                _, launches, _, seconds = driven(torch, driver, cli.main,
                                                 argv, device=dev)
                # Each crop at <time>_5/5 - cli_labelled/<label>/<crop>.
                written = [os.path.relpath(os.path.join(d, f),
                                           crops).split(os.sep)
                           for d, _, fs in os.walk(crops) for f in fs]
                want = sum(len(m.boxes) for m in metas)
                if len(written) != want or any(
                        len(w) != 4 or w[1] != "5 - cli_labelled"
                        or w[2] not in CLI_LABEL_IDS for w in written) \
                        or any(launches.values()):
                    bad.append(f"crop-objects wrote {len(written)} crops "
                               f"(expected {want} sorted by class), "
                               f"launches {launches}")
                lines["crop"] = {
                    "phase": "cli", "command": "crop-objects",
                    "wall_s": seconds, "crops": len(written),
                    "launches": launches, "card": card}
                emit(lines["crop"])
                del load_s[:]
                found = os.path.join(tmp, "directory")
                argv = ["infer-object-detector-directory", "-i", raw, "-o",
                        found, "--model-dir", out_dir, "--model",
                        "cli_model", "--threshold", "0"]
                _, launches, _, seconds = driven(torch, driver, cli.main,
                                                 argv, device=dev)
                written = [os.path.join(d, f) for d, _, fs in os.walk(found)
                           for f in fs]
                check_infer_launches("infer-object-detector-directory",
                                     launches)
                # Detections of one label whose integer boxes coincide share
                # a crop's file name, so there may be fewer crops.
                if not 0 < len(written) <= lines["infer_0"][
                        "shapes_uploaded"]:
                    bad.append("infer-object-detector-directory wrote "
                               f"{len(written)} crops, infer-object-detector"
                               " uploaded "
                               f"{lines['infer_0']['shapes_uploaded']} shapes")
                lines["directory"] = {
                    "phase": "cli",
                    "command": "infer-object-detector-directory",
                    "images": n, "batch_size": 2, "threshold": 0,
                    "wall_s": seconds, "images_per_s": n / seconds,
                    "model_load_s": load_s[0],
                    "images_per_s_after_load": n / (seconds - load_s[0]),
                    "crops": len(written), "launches": launches,
                    "decode": decode, "card": card}
                emit(lines["directory"])
            else:
                emit({"phase": "cli", "command": "crop-objects, "
                      "infer-object-detector-directory", "ran": False,
                      "why": "both write JPEG crops through Pillow, which "
                             "does not import here; the CPU tests "
                             "(tests/test_torch_cli.py) run them",
                      "card": card})
            # One evaluate_model batch of the trained model, its K1 and K2
            # inputs captured for the checks against the plain versions.
            with contextlib.redirect_stdout(sys.stderr):
                task = CvatTask(srv.url, 5, image_root=os.path.join(
                    tmp, "cvat"), debug=False).load()
                one_batch = type(task.project)()
                for im in list(task.project.image_dict.values())[:2]:
                    one_batch.add_image(im)
                nms_calls = []

                def eval_one_batch():
                    nms_calls.extend(capture_nms(
                        nms, lambda: driver.evaluate_model(
                            one_batch, model_dir, batch_size=2, device=dev)))

                roi_calls = capture_roi_align(eval_one_batch)
    finally:
        imageio.read_rgb = read_rgb
        inference.load_inference_model = load
        shutil.rmtree(tmp, ignore_errors=True)
    if len(nms_calls) != 2 or len(roi_calls) != 1:
        bad.append(f"one evaluate_model batch made {len(nms_calls)} K1 and "
                   f"{len(roi_calls)} K2 calls, expected 2 and 1")
    if bad:
        raise AssertionError(f"cli: {bad}")
    infer_lines = [lines[k] for k in ("infer_0.05", "infer_0", "directory")
                   if k in lines]
    return ({"cli_train": lines["train"]["launches"],
             "cli_infer": {k: sum(ln["launches"][k] for ln in infer_lines)
                           for k in lines["train"]["launches"]}},
            (nms_calls, roi_calls))


# -- phase 11: Mask R-CNN -----------------------------------------------------

def ellipse_masks(boxes, valid, size, stride=8):
    """Float32 ``[B, G, H/stride, W/stride]`` planes: a filled ellipse in
    each valid box, the dataset's mask targets of an ellipse polygon."""
    hm, wm = size[0] // stride, size[1] // stride
    yy, xx = np.mgrid[0:hm, 0:wm] + 0.5
    out = np.zeros(boxes.shape[:2] + (hm, wm), np.float32)
    for i, j in zip(*np.nonzero(valid)):
        x1, y1, x2, y2 = boxes[i, j] / stride
        rx, ry = max((x2 - x1) / 2, 0.5), max((y2 - y1) / 2, 0.5)
        out[i, j] = (((xx - (x1 + x2) / 2) / rx) ** 2
                     + ((yy - (y1 + y2) / 2) / ry) ** 2) <= 1
    return out


def synthetic_mask_batch(rng, b, size, max_gt, stride=8, **kw):
    """``synthetic_batch`` with each gt's ellipse as its mask target."""
    batch = synthetic_batch(rng, b, size, max_gt, **kw)
    batch["masks"] = ellipse_masks(batch["boxes"], batch["valid"], size,
                                   stride)
    return batch


def with_keypoints(batch, rng, k=17):
    """``batch`` with ``keypoints [B, G, k, 3]`` float32: points drawn
    uniformly inside each valid gt box, a fifth of them invisible (v 0),
    the rest visible (v 2)."""
    boxes, valid = batch["boxes"], batch["valid"]
    u = rng.uniform(0, 1, boxes.shape[:2] + (k, 2))
    xy = boxes[..., None, :2] + u * (boxes[..., None, 2:]
                                     - boxes[..., None, :2])
    vis = np.where(rng.uniform(size=u.shape[:3]) < 0.2, 0.0, 2.0)
    kps = np.concatenate([xy, vis[..., None]], -1).astype(np.float32)
    kps[~valid] = 0.0
    return dict(batch, keypoints=kps)


def model_batch(model, rng, b, size, max_gt, **kw):
    """``synthetic_batch`` with the targets of ``model``'s extra head: an
    ellipse mask per gt, or 17 keypoints (drawn after the batch, so the
    boxes are those of the same ``rng`` without them)."""
    if head_of(model) == "mask":
        return synthetic_mask_batch(rng, b, size, max_gt, **kw)
    batch = synthetic_batch(rng, b, size, max_gt, **kw)
    return with_keypoints(batch, rng) if head_of(model) == "keypoint" \
        else batch


def capture_roi_align_bwd(run, output_size, limit=1):
    """The inputs of the first ``limit`` K3 calls at ``output_size`` that
    ``run()`` makes (the backward of the RoIAlign autograd function), as
    ``(grad_out, level shapes, dtype, boxes, strides, output_size, ratio,
    channels_first)``, cloned."""
    from podtpu_torch.ops import roi_align

    calls = []
    launch = roi_align._backward_kernel

    def recording(grad_out, shapes, dtype, boxes, level, strides, out,
                  ratio, channels_first):
        if out == output_size and len(calls) < limit:
            calls.append((grad_out.detach().clone(), shapes, dtype,
                          boxes.clone(), strides, out, ratio,
                          channels_first))
        return launch(grad_out, shapes, dtype, boxes, level, strides, out,
                      ratio, channels_first)

    roi_align._backward_kernel = recording
    try:
        run()
    finally:
        roi_align._backward_kernel = launch
    return calls


def check_roi_align_bwd_main_path(torch, roi_align, captured):
    """K3 on the upstream gradients the main paths gave it, as the path
    calls it, against the float32 plain backward on the same inputs, twice
    for equal bits, with times and the bound of this data.  A path's
    gradient can be tiny (the mask loss's entries are of order 1e-6), and
    an absolute tolerance then holds nothing: the comparison runs on the
    gradient scaled to unit RMS (K3 is linear in it) at the tolerance of
    ``check_roi_align_bwd`` (atol 2e-2, rtol 1e-2 in bf16), and the call
    on the path's own gradient must agree within 1e-2 of the largest
    wanted value.  Two controls show that the check can fail: zeros, and
    the kernel's level gradients shifted by one row, must both fall
    outside the tolerance.  Returns each call's record."""
    tol = dict(atol=2e-2, rtol=1e-2)
    recs = []
    for path, calls in captured:
        for k, (g, shapes, dtype, boxes, strides, out, ratio,
                cf) in enumerate(calls):
            levels = [torch.empty(s, dtype=dtype, device=boxes.device)
                      for s in shapes]
            levels32 = [torch.empty(s, dtype=torch.float32,
                                    device=boxes.device) for s in shapes]

            def kernel(grad):
                return roi_align.batched_roi_align_backward(
                    grad, levels, boxes, strides, out, ratio,
                    channels_first=cf)

            def plain(grad):
                return roi_align.batched_roi_align_backward_plain(
                    grad.float(), levels32, boxes, strides, out, ratio,
                    channels_first=cf)

            def close(xs, ws):
                return all(x.dtype == dtype and bool(torch.allclose(
                    x.float(), w, **tol)) for x, w in zip(xs, ws))

            def max_err(xs, ws):
                return max(float((x.float() - w).abs().max())
                           for x, w in zip(xs, ws))

            rms = float(g.float().pow(2).mean().sqrt())
            unit = (g.float() / rms).to(g.dtype)
            got, again, want = kernel(unit), kernel(unit), plain(unit)
            got_path, want_path = kernel(g), plain(g)
            torch.cuda.synchronize()
            want_max = max(float(w.abs().max()) for w in want_path)
            shifted = [x.roll(1, dims=1) for x in got]
            zeros = [torch.zeros_like(x) for x in got]
            rec = {"phase": "kernels", "kernel": "roi_align_bwd",
                   "case": f"{path}_call{k}_out{out}_b{boxes.shape[0]}"
                           f"_k{boxes.shape[1]}_{str(dtype)[6:]}",
                   "grad_shape": list(g.shape), "channels_first": cf,
                   "rois_crossing_canvas": crossing_share(boxes, (
                       shapes[0][1] * strides[0], shapes[0][2] * strides[0])),
                   "grad_rms": rms, "tolerance": tol,
                   "max_abs_err": max_err(got, want),
                   "within_tolerance": close(got, want),
                   "path_grad_max_err_over_max": max_err(
                       got_path, want_path) / want_max,
                   "equal_bits_twice": all(
                       torch.equal(x, y) for x, y in zip(got, again)),
                   "control_zeros_max_abs_err": max_err(zeros, want),
                   "control_zeros_within": close(zeros, want),
                   "control_shifted_max_abs_err": max_err(shifted, want),
                   "control_shifted_within": close(shifted, want)}
            del got, again, want, got_path, want_path, shifted, zeros
            rec["kernel_ms"] = time_ms(lambda: kernel(g))
            rec["plain_ms"] = time_ms(lambda: plain(g), reps=10)
            nbytes, ops, _ = roi_bwd_bound(torch, roi_align, levels, boxes,
                                           strides, g, out, ratio)
            t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / F32_OPS_PER_S
            rec.update(bound_ms=max(t_bytes, t_ops) * 1e3, bytes=nbytes,
                       ops=ops, bound_by="bytes" if t_bytes >= t_ops
                       else "operations")
            emit(rec)
            if not (rec["within_tolerance"] and rec["equal_bits_twice"]
                    and rec["path_grad_max_err_over_max"] <= 1e-2):
                raise AssertionError(f"roi_align_bwd {path} call {k}: {rec}")
            if rec["control_zeros_within"] or rec["control_shifted_within"]:
                raise AssertionError(f"roi_align_bwd {path} call {k}: a "
                                     f"wrong result passes the check: {rec}")
            recs.append(rec)
    return recs


def branch_ms(torch, net, model, images, batch, cfg):
    """CUDA-event milliseconds (median of 10) of the extra head's branch of
    a train step (``model`` "mask" or "keypoint"), each part fed the
    previous part's outputs: RoIAlign at the head's pool size over the
    sampled RoIs (K2; a keypoint model's expanded), the head, the loss
    (mask: target crop and BCE; keypoint: heatmap cross-entropy) and the
    branch's backward (the head's and K3's)."""
    from podtpu_torch.models import rpn as rpn_lib
    from podtpu_torch.models import roi_heads as rh
    from podtpu_torch.models.detector import draw_model

    mcfg = cfg.model
    gen = torch.Generator(device=images.device).manual_seed(SEED)
    with torch.no_grad():
        pyramid = net.features(images)
        logits, deltas = net.rpn.head(pyramid)
        props = rpn_lib.select_proposals(logits, deltas, net.rpn.anchors(),
                                         mcfg, train=True)
        draws = draw_model(gen, mcfg, images.shape[0],
                           batch["boxes"].shape[1])
        sampled = rh.sample_rois(props.boxes, props.valid, batch["boxes"],
                                 batch["labels"], batch["valid"], mcfg,
                                 draws.roi_pos, draws.roi_neg)
    pyramid = [f.detach().requires_grad_() for f in pyramid]
    if head_of(model) == "mask":
        rois, size, run_head = (sampled.boxes, mcfg.mask_pool_size,
                                net.roi_heads.mask_logits)

        def loss_of(head_out):
            return rh.mask_loss(head_out, sampled, batch["masks"], mcfg)
    else:
        rois = rh.expand_rois(sampled.boxes, mcfg.keypoint_roi_expand)
        size, run_head = (mcfg.keypoint_pool_size,
                          net.roi_heads.keypoint_logits)

        def loss_of(head_out):
            return rh.keypoint_loss(head_out, rois, sampled,
                                    batch["keypoints"])

    def pool():
        return rh.pool_rois_batched(pyramid, rois, mcfg, pool_size=size,
                                    channels_last=True)

    def head(pooled):
        b, k = pooled.shape[:2]
        out = run_head(pooled.reshape(b * k, *pooled.shape[2:]))
        return out.reshape(b, k, *out.shape[1:])

    with torch.no_grad():
        pooled = pool()
        head_out = head(pooled)

    def branch():
        loss_of(head(pool())).backward()

    with torch.no_grad():
        parts = {f"{model}_roi_align": time_ms(pool, reps=10),
                 f"{model}_head": time_ms(lambda: head(pooled), reps=10),
                 f"{model}_loss": time_ms(lambda: loss_of(head_out),
                                          reps=10)}
    whole = time_ms(branch, reps=10)
    parts[f"{model}_backward"] = whole - sum(parts.values())
    parts[f"{model}_branch_forward_backward"] = whole
    net.zero_grad(set_to_none=True)
    return parts


def capture_step(run, pool_size, captured, path):
    """The inputs of the K2 and K3 calls at ``pool_size`` that one training
    step (``run()``) of a mask or keypoint model makes, appended to
    ``captured`` under ``path``; exactly one of each."""
    k3_calls = []
    k2_calls = capture_roi_align(lambda: k3_calls.extend(
        capture_roi_align_bwd(run, pool_size)))
    k2_calls = [c for c in k2_calls if c[3].get("output_size") == pool_size]
    if len(k2_calls) != 1 or len(k3_calls) != 1:
        raise AssertionError(f"one {path} step made {len(k2_calls)} K2 and "
                             f"{len(k3_calls)} K3 calls at {pool_size}, "
                             "expected 1 and 1")
    captured["k2"].append((path, k2_calls))
    captured["k3"].append((path, k3_calls))


def head_eval_slice(torch, card, dev, captured, model="mask", config=None,
                    b=4):
    """The eval forward of a mask or keypoint model (``model``) with seeded
    random weights (as the serving slice's: every one of the
    ``detections_per_image`` slots holds a detection) at batch ``b``: each
    stage timed with CUDA events (median of 10), the extra head's stages
    among them (a keypoint model's decode too), a profiler window, the
    launches of one forward (K1 twice, K2 twice), and the inputs of its K2
    call at the head's pool size."""
    from podtpu_torch.core.config import ModelConfig
    from podtpu_torch.models import roi_heads as rh
    from podtpu_torch.models.detector import init_parameters, make_detector
    from podtpu_torch.ops import _build

    kps = model == "keypoint"
    cfg = config or ModelConfig(**({} if kps else dict(num_classes=4)),
                                **model_kwargs(model))
    size = cfg.keypoint_pool_size if kps else cfg.mask_pool_size
    net = make_detector(cfg)
    init_parameters(net, torch.Generator().manual_seed(SEED))
    net = net.to(dev, memory_format=torch.channels_last).eval()
    rng = np.random.default_rng(SEED + 12)
    images = [rng.integers(0, 256, (*cfg.image_size, 3), dtype=np.uint8)
              for _ in range(b)]
    x = torch.from_numpy(np.stack(images)).to(dev)

    def forward():
        with torch.inference_mode():
            return net(x)

    forward()
    torch.cuda.synchronize()
    _build.reset_launches()
    det, extra = forward()
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    stages = stage_breakdown(torch, net, images)
    rois = rh.expand_rois(det.boxes, cfg.keypoint_roi_expand) if kps \
        else det.boxes
    run_head = net.roi_heads.keypoint_logits if kps \
        else net.roi_heads.mask_logits
    with torch.inference_mode():
        pyramid = net.features(x)
        pooled = rh.pool_rois_batched(pyramid, rois, cfg, pool_size=size,
                                      channels_last=True)
        flat = pooled.reshape(-1, *pooled.shape[2:])
        stages[f"{model}_roi_align"] = time_ms(lambda: rh.pool_rois_batched(
            pyramid, rois, cfg, pool_size=size, channels_last=True), reps=10)
        stages[f"{model}_head"] = time_ms(lambda: run_head(flat), reps=10)
        if kps:
            logits = run_head(flat)
            stages["keypoint_decode"] = time_ms(
                lambda: rh.heatmaps_to_keypoints(logits, rois.reshape(-1, 4)),
                reps=10)
            del logits
    prof = device_profile(torch, forward)
    calls = [c for c in capture_roi_align(forward)
             if c[3].get("output_size") == size]
    valid = det.valid
    out = extra.keypoints if kps else extra
    rec = {"phase": f"{model}_eval", "model": f"{model}_rcnn_resnet50_fpn",
           "batch_size": b, "image_size": list(cfg.image_size),
           "detections": int(valid.sum()), "output_shape": list(out.shape),
           "output_finite": bool(torch.isfinite(out).all()),
           "stages_ms": stages, "launches": launches, "profile": prof,
           "card": card}
    if kps:
        want = (b, cfg.detections_per_image, cfg.num_keypoints, 3)
        rec["keypoint_score_median"] = float(out[..., 2][valid].median()) \
            if valid.any() else None
    else:
        want = (b, cfg.detections_per_image, cfg.mask_resolution,
                cfg.mask_resolution)
        rec["mask_pixels_over_half"] = float((out[valid] > 0.5).float()
                                             .mean()) if valid.any() else None
    emit(rec)
    if not rec["output_finite"] or tuple(out.shape) != want:
        raise AssertionError(f"{model} eval: output {tuple(out.shape)}, "
                             f"finite {rec['output_finite']}")
    if launches.get("roi_align_fwd", 0) != 2 or launches.get("nms", 0) != 2 \
            or len(calls) != 1:
        raise AssertionError(f"{model} eval: launches {launches}, "
                             f"{len(calls)} K2 calls at {size}")
    if kps and rec["detections"] != b * cfg.detections_per_image:
        raise AssertionError(f"keypoint eval: {rec['detections']} "
                             "detections, expected every slot")
    captured["k2"].append((f"{model}_eval", calls))
    return launches


def shape_images(rng, n, size, with_gt=True, kind="polygons"):
    """``n`` seeded canvases, path -> uint8 image, and their metadata: dark
    noise with 1-30 filled ellipses of 16-256 px, a brightness per label;
    each annotated (``with_gt``) by its ellipse as a 24-point polygon
    (``kind`` "polygons"), by its box ("rectangles"), or by its box with
    five keypoints, the centre and the four axis extremes one pixel inside
    the box, as ``tests/synthetic.py`` draws them ("keypoints")."""
    from podtpu_torch.data import ImageMetadata, RectangleAnnotation
    from podtpu_torch.data.annotation import PolygonAnnotation

    batch = synthetic_batch(rng, n, size, 30, classes=len(DRIVER_LABELS))
    fill = ellipse_masks(batch["boxes"], batch["valid"], size, stride=1)
    images, metas = {}, []
    a = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    for i in range(n):
        img = (batch["image"][i] // 3).copy()
        meta = ImageMetadata(f"{kind}_{'gt' if with_gt else 'infer'}_"
                             f"{i:03d}.png", "/in-memory", dataset_id=1,
                             frame_id=i)
        valid = batch["valid"][i]
        for j in np.flatnonzero(valid):
            x1, y1, x2, y2 = (float(v) for v in batch["boxes"][i, j])
            lab = int(batch["labels"][i, j])
            img[fill[i, j] > 0] = 120 + 40 * lab
            if not with_gt:
                continue
            cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
            if kind == "polygons":
                meta.add_annotation(PolygonAnnotation(
                    list(cx + (x2 - x1) / 2 * np.cos(a)),
                    list(cy + (y2 - y1) / 2 * np.sin(a)),
                    DRIVER_LABELS[lab - 1]))
            else:
                kps = [(cx, cy, 2.0), (x1 + 1, cy, 2.0), (x2 - 1, cy, 2.0),
                       (cx, y1 + 1, 2.0), (cx, y2 - 1, 2.0)] \
                    if kind == "keypoints" else None
                meta.add_annotation(RectangleAnnotation(
                    x1, y1, x2 - x1, y2 - y1, DRIVER_LABELS[lab - 1],
                    keypoints=kps))
        images[meta.full_path] = img
        metas.append(meta)
    return images, metas


def head_driver_phase(torch, card, dev, model="mask", config=None,
                      size=(1024, 1024), n_images=24, n_infer=8, after=None):
    """The training driver of a mask or keypoint model (``model``) at the
    ``Config()`` defaults on a seeded in-memory project for 2 epochs:
    ``train(with_mask=True)`` on ellipse polygons (rectangles where Pillow,
    which rasterizes them, does not import), or ``train(with_keypoints=
    True, num_keypoints=5)`` with ``keypoint_roi_expand`` 1.3 on boxes
    carrying their centre and four axis extremes.  Then ``evaluate_model``
    on its 4 test images with bbox and segm or keypoints stats; ``infer``
    on ``n_infer`` unlabelled images at threshold 0.5, then at the median
    of the images' best scores, which keeps a detection in at least half
    of them (the host traces each kept mask: about 0.2 s a detection at
    1024^2; a keypoint model attaches each detection's keypoints); and one
    batch of the ``DetectionServer`` at that score, of the four images with
    the best scores (polygons for a mask model, boxes alone for a keypoint
    model).  ``after(model_dir)``, when given, runs on the trained model
    directory before it is removed.  Returns the launches by path."""
    from podtpu_torch.core.config import Config
    from podtpu_torch.data import Project, imageio
    from podtpu_torch.data.annotation import PolygonAnnotation
    from podtpu_torch.data.dataset import train_test_split
    from podtpu_torch.infer import inference
    from podtpu_torch.infer.server import DetectionServer
    from podtpu_torch.train import train as driver

    kps = model == "keypoint"
    pillow = importlib.util.find_spec("PIL") is not None
    kind = "keypoints" if kps else "polygons" if pillow else "rectangles"
    images, metas = shape_images(np.random.default_rng(SEED + 13),
                                 n_images, size, kind=kind)
    unlabelled, infer_metas = shape_images(
        np.random.default_rng(SEED + 14), n_infer, size, with_gt=False,
        kind=kind)
    images.update(unlabelled)
    project, infer_project = Project(), Project()
    for m in metas:
        project.add_image(m)
    for m in infer_metas:
        infer_project.add_image(m)
    if kps:
        config = config or Config()
        config = dataclasses.replace(config, model=dataclasses.replace(
            config.model, keypoint_roi_expand=1.3))
        head_kw = dict(with_keypoints=True, num_keypoints=5)
    else:
        head_kw = dict(with_mask=True)
    tmp = tempfile.mkdtemp(prefix=f"podtpu_{model}_")
    read_rgb = imageio.read_rgb
    imageio.read_rgb = images.__getitem__
    try:
        torch.cuda.reset_peak_memory_stats()
        model_dir, launches, rec, seconds = driven(
            torch, driver, driver.train, project, output_dir=tmp,
            name=model, batch_size=2, seed=0, config=config, device=dev,
            max_epochs=2, **head_kw)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        _, test_idx = train_test_split(len(metas), 0.2, 1)
        test_project = Project()
        for i in test_idx:
            test_project.add_image(metas[int(i)])
        eval_dir = os.path.join(tmp, "eval")
        stats, evaluated, _, eval_s = driven(
            torch, driver, driver.evaluate_model, test_project, model_dir,
            batch_size=2, output_dir=eval_dir, device=dev)
        head_file = "results_keypoints.txt" if kps else "results_segm.txt"
        with open(os.path.join(eval_dir, head_file)) as fp:
            head_stats = [float(ln.rsplit("=", 1)[1]) for ln in fp]

        def infer(threshold):
            return driven(torch, driver, inference.infer, infer_project,
                          model_dir, threshold=threshold, batch_size=4,
                          device=dev)

        def kinds(result):
            """(polygons or annotations carrying keypoints, annotations)."""
            shapes = [b for im in result.image_dict.values()
                      for b in im.boxes]
            if kps:
                return (sum(b.keypoints is not None
                            and len(b.keypoints) == 5 for b in shapes),
                        len(shapes))
            return (sum(isinstance(b, PolygonAnnotation) for b in shapes),
                    len(shapes))

        result, infer_launches, _, infer_s = infer(0.5)
        with contextlib.redirect_stdout(sys.stderr):
            forward = inference.load_inference_model(model_dir, dev)[0]
            x = np.stack([images[m.full_path] for m in infer_metas])
            det, _ = forward(x)
            best = torch.where(det.valid, det.scores, torch.zeros_like(
                det.scores)).amax(1).cpu()
            order = [infer_metas[int(i)] for i in best.argsort(
                descending=True)]
            best = best[best > 0]
            threshold = float(best.median()) - 1e-6 if len(best) else 0.0
        best_result, _, _, best_s = infer(threshold)
        server = DetectionServer(model_dir, batch_size=4, device=dev)
        try:
            served = [server.detect_array(images[m.full_path], threshold)
                      for m in order[:4]]
        finally:
            server.close()
        if after is not None:
            after(model_dir)
    finally:
        imageio.read_rgb = read_rgb
        shutil.rmtree(tmp, ignore_errors=True)
    steps = sum(e["steps"] for e in rec["epochs"])
    eval_batches = sum(e["eval_batches"] for e in rec["epochs"])
    extras, shapes = kinds(result)
    best_extras, best_shapes = kinds(best_result)
    served_dets = [d for r in served for d in r["detections"]]
    served_polygons = sum("polygon" in d for d in served_dets)
    extra = "keypoints" if kps else "polygons"
    line = {"phase": f"{model}_driver", "model": f"{model}_rcnn_resnet50_fpn",
            "image_size": list(size), "images": n_images,
            "gt_shapes": {"keypoints": "boxes with 5 keypoints (centre, "
                          "axis extremes)",
                          "polygons": "ellipse polygons (24 points)",
                          "rectangles": "rectangles (Pillow, which "
                          "rasterizes polygons, does not import)"}[kind],
            "batch_size": 2, "epochs": epoch_lines(rec, 2), "steps": steps,
            "train_call_s": seconds,
            **dispatch_record(f"{model}_driver",
                              [e["loss"] for e in rec["epochs"]], rec),
            f"eval_{'keypoints' if kps else 'segm'}_stats": [
                e["keypoints_stats" if kps else "segm_stats"]
                for e in rec["epochs"]],
            "evaluate_model_s": eval_s, "evaluate_model_bbox": stats,
            f"evaluate_model_{'keypoints' if kps else 'segm'}": head_stats,
            "infer_threshold": 0.5, "infer_s": infer_s,
            f"infer_{extra}": extras, "infer_annotations": shapes,
            "best_threshold": threshold, "best_infer_s": best_s,
            f"best_{extra}": best_extras, "best_annotations": best_shapes,
            "served_detections": len(served_dets),
            "served_polygons": served_polygons,
            "launches": {"train": launches, "evaluate_model": evaluated,
                         "infer": infer_launches},
            "peak_memory_gib": peak, "card": card}
    if kps:
        line["keypoint_roi_expand"] = config.model.keypoint_roi_expand
        line["served_with_keypoints"] = sum("keypoints" in d
                                            for d in served_dets)
    emit(line)
    bad = []
    if not all(np.isfinite(float(v)) for v in rec["step_losses"]):
        bad.append("a train loss is not finite")
    if len(head_stats) != 12 or not all(-1 <= v <= 1
                                        for v in head_stats + stats):
        bad.append(f"stats {stats}, {head_file} {head_stats}")
    key = "keypoints_stats" if kps else "segm_stats"
    if any(e[key] is None for e in rec["epochs"]):
        bad.append(f"an epoch's eval ran no {key[:-6]} evaluation")
    if launches["roi_align_bwd"] != 2 * steps or launches["nms"] < (
            steps + eval_batches) or launches["roi_align_fwd"] < 2 * (
            steps + eval_batches):
        bad.append(f"train launches {launches}: expected K3 = 2 x {steps} "
                   f"steps, K1 >= {steps + eval_batches}, K2 >= twice that")
    if not best_extras or (kps and best_extras != best_shapes):
        bad.append(f"{best_extras} of {best_shapes} annotations from infer "
                   f"with {extra} at the median best score")
    if not served_dets or (not kps and not served_polygons) or (
            kps and line["served_with_keypoints"]):
        bad.append(f"the server's {len(served_dets)} detections, "
                   f"{served_polygons} polygons")
    if bad:
        raise AssertionError(f"{model} driver: {bad}")
    return {f"{model}_driver": launches, f"{model}_evaluate_model": evaluated,
            f"{model}_infer": infer_launches}


def driver_inputs(size, n_images, n_infer):
    """The inputs of the v2 and one-stage driver phases: the driver
    phase's seeded in-memory images (path -> array) with ``n_infer``
    unlabelled ones, the labelled project, its 20 % test split (as a
    project and as indices) and the unlabelled project with its images'
    metadata."""
    from podtpu_torch.data import Project
    from podtpu_torch.data.dataset import train_test_split

    images, metas = in_memory_images(np.random.default_rng(SEED + 8),
                                     n_images, size)
    unlabelled, infer_metas = in_memory_images(
        np.random.default_rng(SEED + 9), n_infer, size, with_boxes=False)
    images.update(unlabelled)
    project, infer_project, test_project = Project(), Project(), Project()
    for m in metas:
        project.add_image(m)
    for m in infer_metas:
        infer_project.add_image(m)
    _, test_idx = train_test_split(len(metas), 0.2, 1)
    for i in test_idx:
        test_project.add_image(metas[int(i)])
    return images, project, test_project, test_idx, infer_project, \
        infer_metas


def infer_and_serve(torch, driver, dev, model_dir, images, infer_project,
                    infer_metas):
    """``infer`` of the model in ``model_dir`` over ``infer_project`` at
    batch 4 and the median of its images' best scores (read from one
    forward of them all), its K1 calls captured, then 4
    ``DetectionServer`` requests of the images with the best scores at
    that threshold.  Returns the stored config, the threshold, ``infer``'s
    result, launches, seconds and K1 calls, and the server's results."""
    from podtpu_torch.infer import inference
    from podtpu_torch.infer.server import DetectionServer
    from podtpu_torch.ops import nms

    with contextlib.redirect_stdout(sys.stderr):
        forward, _, stored, _ = inference.load_inference_model(model_dir,
                                                               dev)
        det = forward(np.stack([images[m.full_path] for m in infer_metas]))
        best = torch.where(det.valid, det.scores, torch.zeros_like(
            det.scores)).amax(1).cpu()
        order = [infer_metas[int(i)] for i in best.argsort(descending=True)]
        best = best[best > 0]
        threshold = float(best.median()) - 1e-6 if len(best) else 0.0
        del forward, det
    (result, calls), launches, _, seconds = driven(
        torch, driver, capture_nms_out, nms, inference.infer, infer_project,
        model_dir, threshold=threshold, batch_size=4, device=dev)
    server = DetectionServer(model_dir, batch_size=4, device=dev)
    try:
        served = [server.detect_array(images[m.full_path], threshold)
                  for m in order[:4]]
    finally:
        server.close()
    return dict(stored=stored, threshold=threshold, result=result,
                launches=launches, seconds=seconds, calls=calls,
                served=served)


def v2_driver_phase(torch, card, dev, config=None, size=(1024, 1024),
                    n_images=24, n_infer=8):
    """``train(family="faster_rcnn_v2")`` under ``lsj`` at the ``Config()``
    defaults on the driver phase's 24 in-memory images for 2 epochs; the
    model directory keeps the family ``faster_rcnn`` with the v2 fields.
    Then ``evaluate_model`` on its 4 test images, ``infer`` on ``n_infer``
    unlabelled images at the median of their best scores, which must keep
    boxes, and one ``DetectionServer`` batch of the four images with the
    best scores.  Per-epoch seconds and images/s; K3 once per step, K1 and
    K2 at least once per step and eval batch.  Returns the launches by
    path."""
    from podtpu_torch.core.config import Config
    from podtpu_torch.data import imageio
    from podtpu_torch.train import train as driver

    images, project, test_project, test_idx, infer_project, infer_metas = \
        driver_inputs(size, n_images, n_infer)
    config = config or Config()
    config = dataclasses.replace(config, data=dataclasses.replace(
        config.data, aug_policy="lsj"))
    tmp = tempfile.mkdtemp(prefix="podtpu_v2_")
    read_rgb = imageio.read_rgb
    imageio.read_rgb = images.__getitem__
    try:
        torch.cuda.reset_peak_memory_stats()
        model_dir, launches, rec, seconds = driven(
            torch, driver, driver.train, project, output_dir=tmp, name="v2",
            batch_size=2, seed=0, config=config, device=dev, max_epochs=2,
            family="faster_rcnn_v2")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        stats, evaluated, _, eval_s = driven(
            torch, driver, driver.evaluate_model, test_project, model_dir,
            batch_size=2, device=dev)
        inf = infer_and_serve(torch, driver, dev, model_dir, images,
                              infer_project, infer_metas)
    finally:
        imageio.read_rgb = read_rgb
        shutil.rmtree(tmp, ignore_errors=True)
    steps = sum(e["steps"] for e in rec["epochs"])
    eval_batches = sum(e["eval_batches"] for e in rec["epochs"])
    kept = sum(len(b) for b in kept_boxes(inf["result"], infer_metas))
    served_dets = sum(len(r["detections"]) for r in inf["served"])
    stored, threshold = inf["stored"], inf["threshold"]
    infer_launches, infer_s = inf["launches"], inf["seconds"]
    v2_fields = {k: getattr(stored, k) for k in (
        "family", "rpn_conv_depth", "box_head_type", "fpn_norm",
        "mask_head_norm")}
    emit({"phase": "v2_driver", "model": model_title("faster_v2"),
          "image_size": list(size), "images": n_images,
          "aug_policy": config.data.aug_policy, "stored_config": v2_fields,
          "batch_size": 2, "epochs": epoch_lines(rec, 2), "steps": steps,
          "train_call_s": seconds,
          **dispatch_record("v2_driver",
                            [e["loss"] for e in rec["epochs"]], rec),
          "evaluate_model_s": eval_s, "evaluate_model_stats": stats,
          "best_threshold": threshold, "infer_s": infer_s,
          "infer_kept_boxes": kept, "served_detections": served_dets,
          "launches": {"train": launches, "evaluate_model": evaluated,
                       "infer": infer_launches},
          "peak_memory_gib": peak, "card": card})
    bad = []
    if not all(np.isfinite(float(v)) for v in rec["step_losses"]):
        bad.append("a train loss is not finite")
    if len(stats) != 12 or not all(-1 <= v <= 1 for v in stats):
        bad.append(f"stats {stats}")
    if v2_fields != dict(family="faster_rcnn", rpn_conv_depth=2,
                         box_head_type="convfc", fpn_norm=True,
                         mask_head_norm=True):
        bad.append(f"stored config {v2_fields}")
    if not kept or not served_dets:
        bad.append(f"infer kept {kept} boxes, the server returned "
                   f"{served_dets} at the median best score")
    if bad:
        raise AssertionError(f"v2 driver: {bad}")
    check_driver_launches("v2_driver", launches, steps, eval_batches)
    check_driver_launches("v2_evaluate_model", evaluated, 0,
                          -(-len(test_idx) // 2))
    return {"v2_driver": launches, "v2_evaluate_model": evaluated,
            "v2_infer": infer_launches}


def capture_nms_out(nms, fn, *args, **kwargs):
    """``(fn(*args, **kwargs), the inputs of every K1 call it made)``; the
    calls still launch and count."""
    out = []
    calls = capture_nms(nms, lambda: out.append(fn(*args, **kwargs)))
    return out[0], calls


def one_stage_driver_phase(torch, card, dev, model, config=None,
                           size=(1024, 1024), n_images=24, n_infer=8,
                           after=None):
    """``train(family=model)`` (a one-stage family) at the ``Config()``
    defaults on the driver phase's 24 in-memory images for 2 epochs, from
    a model directory of seeded weights whose class prior is 0.1 (0.2 for
    FCOS, whose score is ``sqrt(class * centre-ness)``), over the score
    thresholds (``lift_scores``), passed as ``pretrained``: from the 0.01
    prior, 20 steps leave every score under the thresholds and the K1
    segments hold no valid box.  Then ``evaluate_model`` on its 4 test images, ``infer`` on
    ``n_infer`` unlabelled images at the median of their best scores,
    which must keep boxes, and 4 ``DetectionServer`` requests.  The model
    directory keeps the family's fields; every loss is finite; training
    launches K1 once per eval batch of its epochs and no other kernel,
    ``evaluate_model`` and ``infer`` K1 once a batch, each segment's valid
    boxes counted.  ``after(model_dir)``, when given, runs on the trained
    model directory before it is removed.  Returns the launches by path
    and the K1 inputs of ``evaluate_model`` and ``infer``, as the counted
    runs made them."""
    from podtpu_torch.core.config import Config
    from podtpu_torch.data import imageio
    from podtpu_torch.models.detector import init_parameters, make_detector
    from podtpu_torch.ops import nms
    from podtpu_torch.train import train as driver
    from podtpu_torch.train.checkpoints import save_labels, save_model

    config = config or Config()
    images, project, test_project, test_idx, infer_project, infer_metas = \
        driver_inputs(size, n_images, n_infer)
    tmp = tempfile.mkdtemp(prefix=f"podtpu_{model}_")
    start_cfg = model_config(model, **dict(
        dataclasses.asdict(config.model),
        num_classes=len(DRIVER_LABELS) + 1))
    start = make_detector(start_cfg)
    init_parameters(start, torch.Generator().manual_seed(SEED))
    lift_scores(torch, start, prior=0.2 if model == "fcos" else 0.1)
    save_model(os.path.join(tmp, "start"), start, start_cfg, DRIVER_LABELS)
    save_labels(os.path.join(tmp, "start"), DRIVER_LABELS)
    del start
    read_rgb = imageio.read_rgb
    imageio.read_rgb = images.__getitem__
    try:
        torch.cuda.reset_peak_memory_stats()
        model_dir, launches, rec, seconds = driven(
            torch, driver, driver.train, project, output_dir=tmp, name=model,
            batch_size=2, seed=0, config=config, device=dev, max_epochs=2,
            family=model, pretrained=os.path.join(tmp, "start"))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        (stats, eval_calls), evaluated, _, eval_s = driven(
            torch, driver, capture_nms_out, nms, driver.evaluate_model,
            test_project, model_dir, batch_size=4, device=dev)
        inf = infer_and_serve(torch, driver, dev, model_dir, images,
                              infer_project, infer_metas)
        if after is not None:
            after(model_dir)
    finally:
        imageio.read_rgb = read_rgb
        shutil.rmtree(tmp, ignore_errors=True)
    steps = sum(e["steps"] for e in rec["epochs"])
    eval_batches = sum(e["eval_batches"] for e in rec["epochs"])
    kept = sum(len(b) for b in kept_boxes(inf["result"], infer_metas))
    served_dets = sum(len(r["detections"]) for r in inf["served"])
    threshold, infer_calls = inf["threshold"], inf["calls"]
    infer_launches, infer_s = inf["launches"], inf["seconds"]
    fields = {k: getattr(inf["stored"], k) for k in (
        "family", "retinanet_head_norm", "retinanet_box_loss",
        "retinanet_p6_on_c5", "score_thresh", "nms_thresh",
        "detections_per_image", "strides")}
    want_fields = {k: getattr(start_cfg, k) for k in fields}
    segments = {path: [c[1].sum(-1).tolist() for c in calls]
                for path, calls in (("evaluate_model", eval_calls),
                                    ("infer", infer_calls))}
    emit({"phase": f"{model}_driver", "model": model_title(model),
          "image_size": list(size), "images": n_images,
          "aug_policy": config.data.aug_policy, "stored_config": fields,
          "batch_size": 2, "epochs": epoch_lines(rec, 2), "steps": steps,
          "train_call_s": seconds,
          **dispatch_record(f"{model}_driver",
                            [e["loss"] for e in rec["epochs"]], rec),
          "evaluate_model_s": eval_s, "evaluate_model_stats": stats,
          "best_threshold": threshold, "infer_s": infer_s,
          "infer_kept_boxes": kept, "served_detections": served_dets,
          "k1_valid_per_segment": segments,
          "launches": {"train": launches, "evaluate_model": evaluated,
                       "infer": infer_launches},
          "peak_memory_gib": peak, "card": card})
    bad = []
    if not all(np.isfinite(float(v)) for v in rec["step_losses"]):
        bad.append("a train loss is not finite")
    if len(stats) != 12 or not all(-1 <= v <= 1 for v in stats):
        bad.append(f"stats {stats}")
    if fields != want_fields:
        bad.append(f"stored config {fields}, expected {want_fields}")
    if not kept or not served_dets:
        bad.append(f"infer kept {kept} boxes, the server returned "
                   f"{served_dets} at the median best score")
    want = {"train": (launches, eval_batches),
            "evaluate_model": (evaluated, -(-len(test_idx) // 4)),
            "infer": (infer_launches, -(-n_infer // 4))}
    for path, (got, batches) in want.items():
        if got != {"nms": batches, "roi_align_fwd": 0, "roi_align_bwd": 0}:
            bad.append(f"{path}: launches {got}, expected K1 {batches} "
                       "and no other kernel")
    if len(eval_calls) != want["evaluate_model"][1] \
            or len(infer_calls) != want["infer"][1]:
        bad.append("captured K1 calls differ from the launches")
    if bad:
        raise AssertionError(f"{model} driver: {bad}")
    return ({f"{model}_driver": launches,
             f"{model}_evaluate_model": evaluated,
             f"{model}_infer": infer_launches},
            [(f"{model}_evaluate_model", eval_calls),
             (f"{model}_infer", infer_calls)])


# -- phase 15: tiled scan inference and the crop classifier ------------------

SCAN_HW = (3000, 4000)     # a scan that is not a multiple of the stride
TILED_PER_BATCH = {"faster": (2, 1), "mask": (2, 2), "retinanet_v2": (1, 0)}


def synthetic_scan(rng, hw=SCAN_HW, n=400):
    """A grey uint8 scan (R = G = B) drawn like the driver's images: dark
    noise with ``n`` filled boxes of 16-256 px, a brightness per label."""
    h, w = hw
    img = rng.integers(0, 256, (h, w), dtype=np.uint8) // 3
    wh = rng.uniform(16, 256, (n, 2))
    xy = rng.uniform(0, 1, (n, 2)) * (np.array([w, h]) - wh)
    labels = rng.integers(1, len(DRIVER_LABELS) + 1, n)
    for (x, y), (bw, bh), lab in zip(xy, wh, labels):
        img[int(y):int(y + bh), int(x):int(x + bw)] = 120 + 40 * int(lab)
    return np.repeat(img[..., None], 3, axis=2)


@contextlib.contextmanager
def tiled_hooks(torch, tiled, rec, trace=True):
    """Record, around ``infer_tiled``, the model load's seconds (reading
    the directory and building the model on the card), the merge's
    milliseconds with its detections before and after, and the host
    seconds of tracing polygons; with ``trace`` False no polygon is
    traced."""
    saved = {k: getattr(tiled, k) for k in (
        "load_model", "build_inference_model", "cross_tile_nms",
        "mask_to_annotation")}

    def timed(name, key, sync=False):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = saved[name](*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            rec[key] = rec.get(key, 0.0) + time.perf_counter() - t0
            return out
        return call

    def merge(dets, thr):
        t0 = time.perf_counter()
        out = saved["cross_tile_nms"](dets, thr)
        rec["merge_ms"] = (time.perf_counter() - t0) * 1e3
        rec["before_merge"], rec["after_merge"] = len(dets), len(out)
        return out

    tiled.load_model = timed("load_model", "load_s")
    tiled.build_inference_model = timed("build_inference_model", "load_s",
                                        sync=True)
    tiled.cross_tile_nms = merge
    tiled.mask_to_annotation = timed("mask_to_annotation", "polygon_s") \
        if trace else (lambda *a, **k: None)
    try:
        yield rec
    finally:
        for k, v in saved.items():
            setattr(tiled, k, v)


def same_detections(got, want):
    """Detection lists equal as sets: one match each with the same label,
    box within 1e-3 px and score within 1e-4; returns the largest box and
    score differences."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} detections against {len(want)}")
    used, box_err, score_err = set(), 0.0, 0.0
    for w in want:
        hits = [i for i, g in enumerate(got) if i not in used
                and g.label == w.label
                and np.abs(np.subtract(g.box, w.box)).max() <= 1e-3
                and abs(g.score - w.score) <= 1e-4]
        if not hits:
            raise AssertionError(f"no match for {w}")
        used.add(hits[0])
        g = got[hits[0]]
        box_err = max(box_err, float(np.abs(np.subtract(g.box, w.box)).max()))
        score_err = max(score_err, abs(g.score - w.score))
    return box_err, score_err


def tiled_run(torch, card, dev, model_dir, scan, name, model="faster",
              tile_size=None, batch_size=8, per_tile=2):
    """``infer_tiled`` of ``scan`` with the model in ``model_dir``: first
    uncounted at threshold 0 without polygons (the threshold: 0.5, or the
    score of the ``per_tile`` x tiles-th best merged detection when that
    is lower, so that every tile keeps a few), with the first batch's K1
    and K2 inputs captured; then the counted run: K1 and K2 exactly
    ``TILED_PER_BATCH[model]`` a batch, tiles/s with the model load apart,
    the merge's ms, detections before and after it, polygons and their
    host seconds, peak memory.  Every detection lies in the scan, above
    the threshold, sorted by score.  Returns the line, the detections and
    the captured calls."""
    from podtpu_torch.infer import tiled
    from podtpu_torch.ops import nms
    from podtpu_torch.train import train as driver
    from podtpu_torch.train.checkpoints import load_model

    cfg = load_model(model_dir)[2]
    tile = tile_size or cfg.image_size[0]
    h, w = scan.shape[:2]
    stride = max(1, int(round(tile * 0.75)))
    tiles = len(tiled.tile_origins(h, tile, stride)) * len(
        tiled.tile_origins(w, tile, stride))
    batches = -(-tiles // batch_size)
    k1, k2 = TILED_PER_BATCH[model]
    kw = dict(batch_size=batch_size, tile_size=tile_size, device=dev)
    with tiled_hooks(torch, tiled, {}, trace=False), \
            contextlib.redirect_stdout(sys.stderr):
        out = []
        roi_calls = capture_roi_align(lambda: out.append(capture_nms(
            nms, lambda: out.append(tiled.infer_tiled(scan, model_dir,
                                                      threshold=0.0, **kw)),
            limit=k1)), limit=k2)
        nms_calls, every = out[1], out[0]
    scores = sorted((d.score for d in every), reverse=True)
    rank = min(per_tile * tiles, len(scores)) - 1
    threshold = min(0.5, scores[rank] - 1e-6) if scores else 0.5
    rec = {}
    with tiled_hooks(torch, tiled, rec, trace=model == "mask"):
        torch.cuda.reset_peak_memory_stats()
        dets, launches, _, seconds = driven(
            torch, driver, tiled.infer_tiled, scan, model_dir,
            threshold=threshold, **kw)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    scan_s = seconds - rec["load_s"]
    line = {"phase": name, "model": model_title(model),
            "scan_hw": [h, w], "dtype": str(scan.dtype), "tile": tile,
            "overlap": 0.25, "stride": stride, "tiles": tiles,
            "batch_size": batch_size, "batches": batches,
            "padded_tiles": batches * batch_size - tiles,
            "threshold": threshold, "wall_s": seconds,
            "model_load_s": rec["load_s"], "scan_s": scan_s,
            "tiles_per_s": tiles / scan_s,
            "batch_ms": scan_s / batches * 1e3,
            "merge_ms": rec["merge_ms"],
            "detections_before_merge": rec["before_merge"],
            "detections_after_merge": rec["after_merge"],
            "detections_at_threshold_0": len(every),
            "polygons": sum(d.polygon is not None for d in dets),
            "polygon_host_s": rec.get("polygon_s"),
            "launches": launches, "peak_memory_gib": peak, "card": card}
    emit(line)
    bad = []
    want = {"nms": k1 * batches, "roi_align_fwd": k2 * batches,
            "roi_align_bwd": 0}
    if launches != want:
        bad.append(f"launches {launches}, expected {want}")
    if len(nms_calls) != k1 or len(roi_calls) != k2:
        bad.append(f"captured {len(nms_calls)} K1 and {len(roi_calls)} K2 "
                   f"calls of the first batch, expected {k1} and {k2}")
    boxes = np.asarray([d.box for d in dets]).reshape(-1, 4)
    sc = [d.score for d in dets]
    cx, cy = (boxes[:, 0] + boxes[:, 2]) / 2, (boxes[:, 1] + boxes[:, 3]) / 2
    if not dets or not np.isfinite(boxes).all() or not (
            (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)).all() \
            or min(sc) <= threshold or sc != sorted(sc, reverse=True) \
            or not all(1 <= d.label < cfg.num_classes for d in dets):
        bad.append("no detection, or one outside the scan, under the "
                   "threshold, out of order or of an unknown label")
    if not 0 < rec["after_merge"] <= rec["before_merge"]:
        bad.append("the merge kept no detection or made some")
    if model == "mask" and not line["polygons"]:
        bad.append("no polygon")
    if bad:
        raise AssertionError(f"{name}: {bad}")
    return line, dets, (nms_calls, roi_calls)


def tiled_phases(torch, card, dev, model_dir, scan_hw=SCAN_HW,
                 big_tile=2048):
    """Phase 15a on the driver phase's trained Faster R-CNN: ``tiled`` at
    the model's 1024^2 canvas (20 tiles, 3 batches of 8) and at
    ``tile_size=2048`` (6 tiles, 1 batch); ``tiled_tiff``: the same scan as
    a 16-bit grey TIFF read from its path (decoded to the uint8 scan) gives
    the uint8 run's detections; ``tiled_cli``: ``infer-object-detector-
    tiled`` on the scan's PNG through ``podtpu_torch.cli.main``, whose JSON
    holds the library call's detections.  The TIFF and CLI parts need
    Pillow.  Returns the launches by path and the captured K1 and K2
    calls by path."""
    from podtpu_torch import cli
    from podtpu_torch.infer import tiled
    from podtpu_torch.train import train as driver
    from podtpu_torch.train.checkpoints import read_labels

    scan = synthetic_scan(np.random.default_rng(SEED + 20), scan_hw)
    launches, nms_calls, roi_calls = {}, [], []
    runs = {}
    for name, tile_size in (("tiled", None), (f"tiled_{big_tile}",
                                              big_tile)):
        line, dets, (k1, k2) = tiled_run(torch, card, dev, model_dir, scan,
                                         name, tile_size=tile_size)
        runs[name] = (line, dets)
        launches[name] = line["launches"]
        nms_calls.append((name, k1))
        roi_calls.append((name, k2))
    if importlib.util.find_spec("PIL") is None:
        emit({"phase": "tiled_tiff, tiled_cli", "ran": False,
              "why": "Pillow, which reads image files for infer_tiled, does "
                     "not import here; the CPU tests "
                     "(tests/test_torch_tiled.py) run both", "card": card})
        return launches, nms_calls, roi_calls
    from PIL import Image

    line, dets = runs["tiled"]
    tmp = tempfile.mkdtemp(prefix="podtpu_tiled_")
    try:
        tif = os.path.join(tmp, "scan16.tif")
        Image.fromarray(scan[..., 0].astype(np.uint16) * 257).save(tif)
        with contextlib.redirect_stdout(sys.stderr):
            t0 = time.perf_counter()
            from_tif = tiled.infer_tiled(tif, model_dir,
                                         threshold=line["threshold"],
                                         device=dev)
            tif_s = time.perf_counter() - t0
        box_err, score_err = same_detections(from_tif, dets)
        emit({"phase": "tiled_tiff", "path": "16-bit grey TIFF",
              "wall_s": tif_s, "detections": len(from_tif),
              "box_max_abs_err": box_err, "score_max_abs_err": score_err,
              "card": card})
        png = os.path.join(tmp, "scan.png")
        with open(png, "wb") as fp:
            fp.write(png_bytes(scan))
        out_json = os.path.join(tmp, "dets.json")
        parent, name = os.path.split(model_dir)
        argv = ["infer-object-detector-tiled", "-i", png, "--model-dir",
                parent, "--model", name, "--threshold",
                repr(line["threshold"]), "-o", out_json]
        _, cli_launches, _, seconds = driven(torch, driver, cli.main, argv,
                                             device=dev)
        with open(out_json) as fp:
            rows = json.load(fp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    labels = read_labels(os.path.join(model_dir, "labels.txt"))
    from_cli = [tiled.TiledDetection(tuple(r["box"]), r["score"],
                                     labels.index(r["label"]) + 1)
                for r in rows]
    box_err, score_err = same_detections(from_cli, dets)
    launches["tiled_cli"] = cli_launches
    emit({"phase": "tiled_cli", "argv": argv[:1] + argv[5:8],
          "wall_s": seconds, "detections": len(rows),
          "box_max_abs_err": box_err, "score_max_abs_err": score_err,
          "launches": cli_launches, "card": card})
    if cli_launches != line["launches"]:
        raise AssertionError(f"tiled_cli: launches {cli_launches}, the "
                             f"library call's {line['launches']}")
    return launches, nms_calls, roi_calls


def tiled_head_phase(torch, card, dev, model_dir, model, out,
                     scan_hw=SCAN_HW, mask_side=2048):
    """Phase 15b: ``infer_tiled`` at batch 8 on a trained mask
    (``tiled_mask``: a 2048^2 scan, 9 tiles, polygons traced on the host)
    or one-stage model (``tiled_one_stage``: the full scan, K1 on 8
    segments an image a launch); adds the launches and the first batch's
    captured calls to ``out``."""
    name = "tiled_mask" if model == "mask" else "tiled_one_stage"
    scan = synthetic_scan(np.random.default_rng(SEED + 21), scan_hw)
    if model == "mask":
        scan = np.ascontiguousarray(scan[:mask_side, :mask_side])
    line, _, (k1, k2) = tiled_run(torch, card, dev, model_dir, scan, name,
                                  model=model)
    out["launches"][name] = line["launches"]
    out["nms"].append((name, k1))
    if k2:
        out["roi"].append((name, k2))


CLASSIFIER_CLASSES = ("coccolith", "diatom", "foraminifera", "radiolarian")


def crop_tree(root, rng, per_class=64):
    """``per_class`` seeded PNG crops of 24-200 px for each of
    ``CLASSIFIER_CLASSES`` under ``root/<class>/``: dark noise with a
    filled centre whose channel and brightness tell the class."""
    for c, label in enumerate(CLASSIFIER_CLASSES):
        os.makedirs(os.path.join(root, label))
        for i in range(per_class):
            h, w = (int(v) for v in rng.integers(24, 200, 2))
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8) // 3
            img[h // 4: 3 * h // 4, w // 4: 3 * w // 4, c % 3] = \
                140 + 60 * (c // 3)
            with open(os.path.join(root, label, f"crop_{i:03d}.png"),
                      "wb") as fp:
                fp.write(png_bytes(img))


def adam_apart(torch, got, want, v_hat, lr):
    """Largest differences of parameters after an AdamW step: where
    ``sqrt(v_hat)`` is at least 1e-5, and elsewhere; the share of entries
    more than 1e-6 apart."""
    strict = loose = 0.0
    apart = total = 0
    for k in want:
        floor = v_hat[k].sqrt() < 1e-5
        diff = (got[k] - want[k]).abs()
        strict = max(strict, float(diff[~floor].max()) if (~floor).any()
                     else 0.0)
        loose = max(loose, float(diff[floor].max()) if floor.any() else 0.0)
        apart += int((diff > 1e-6).sum())
        total += diff.numel()
    return strict, loose, apart / total


def check_classifier_reference(torch, dev, size=128, b=8):
    """A float32 ``CropClassifier`` on the card against the same weights on
    the CPU, TF32 off: logits within 1e-4; one AdamW step (lr 1e-3, weight
    decay 1e-4, as ``train_classifier``'s first): loss within 1e-5
    relative, gradients within 2e-3 of each tensor's largest, parameters
    within 1e-6 where Adam's denominator ``sqrt(v_hat)`` is at least 1e-5
    and within twice the learning rate elsewhere (a first AdamW update
    moves an entry by at most the learning rate, weight decay aside: Adam's
    eps 1e-8 turns float32 rounding of a gradient near 0 into any update
    up to that).  A seed whose ReLU inputs flip
    sign between the devices is passed over (a flip sends a gradient down
    another path); the flips are counted."""
    import torch.nn.functional as F
    from podtpu_torch.models.classifier import CropClassifier, init_classifier
    from podtpu_torch.train.classify import WEIGHT_DECAY
    from podtpu_torch.train.optim import apply_optimizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    lr = 1e-3
    flips = []
    try:
        for seed in range(SEED, SEED + 5):
            cpu = CropClassifier(len(CLASSIFIER_CLASSES),
                                 dtype=torch.float32)
            init_classifier(cpu, torch.Generator().manual_seed(seed))
            cpu = cpu.to(memory_format=torch.channels_last)
            gpu = copy.deepcopy(cpu).to(dev)
            rng = np.random.default_rng(seed)
            x = torch.from_numpy(rng.uniform(0, 1, (b, size, size, 3))
                                 .astype(np.float32))
            y = torch.from_numpy(rng.integers(0, len(CLASSIFIER_CLASSES), b))
            out = {}
            for name, net, d in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
                opt = torch.optim.AdamW(net.parameters(), lr=lr,
                                        betas=(0.9, 0.999), eps=1e-8,
                                        weight_decay=WEIGHT_DECAY)
                signs = relu_signs(torch)
                with signs:
                    logits = net(x.to(d))
                loss = -F.log_softmax(logits, -1).gather(
                    1, y.to(d)[:, None])[:, 0].mean()
                loss.backward()
                grads = {k: p.grad.detach().cpu().clone()
                         for k, p in net.named_parameters()}
                apply_optimizer(opt, lr)
                v_hat = {k: opt.state[p]["exp_avg_sq"].cpu() / (1 - 0.999)
                         for k, p in net.named_parameters()}
                out[name] = dict(
                    logits=logits.detach().cpu(), loss=float(loss.detach()),
                    grads=grads, signs=signs.signs, v_hat=v_hat,
                    params={k: p.detach().cpu().clone()
                            for k, p in net.named_parameters()})
            flipped = sum(int((a != b_).sum()) for a, b_ in zip(
                out["cpu"]["signs"], out["gpu"]["signs"]))
            flips.append(flipped)
            if flipped:
                continue
            want, got = out["cpu"], out["gpu"]
            grad_err = max(
                float((got["grads"][k] - g).abs().max())
                / max(float(g.abs().max()), 1e-30)
                for k, g in want["grads"].items())
            strict, loose, apart = adam_apart(torch, got["params"],
                                              want["params"],
                                              want["v_hat"], lr)
            rec = {"phase": "classifier_reference", "seed": seed,
                   "image_size": size, "batch_size": b,
                   "relu_flips_by_seed": flips,
                   "logit_max_abs_err": float(
                       (got["logits"] - want["logits"]).abs().max()),
                   "loss_rel_err": abs(got["loss"] - want["loss"])
                   / abs(want["loss"]),
                   "grad_max_err_over_largest": grad_err,
                   "param_max_abs_err_adam_above_floor": strict,
                   "param_max_abs_err_adam_below_floor": loose,
                   "param_share_apart_over_1e-6": apart}
            emit(rec)
            if not (rec["logit_max_abs_err"] <= 1e-4
                    and rec["loss_rel_err"] <= 1e-5 and grad_err <= 2e-3
                    and strict <= 1e-6 and loose <= 2 * lr):
                raise AssertionError("the classifier on the card disagrees "
                                     "with the CPU reference")
            return rec
        raise AssertionError(f"ReLU inputs flip sign on every seed: {flips}")
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True


def classifier_phase(torch, card, dev, epochs=3, size=128, per_class=64):
    """Phase 15c: ``train_classifier`` on a class-sorted tree of 4 x 64
    PNG crops (image size 128, batch 32, ``epochs`` epochs: 205 training
    crops, 7 steps an epoch, 51 held out), then ``classify_crops`` on the
    tree; training images/s and each epoch's seconds (its steps, crop
    loading included), held-out accuracy, classification images/s, peak
    memory; then ``train-crop-classifier`` (one epoch) and
    ``classify-crops`` through ``podtpu_torch.cli.main``.  No kernel of
    ours runs.  Needs Pillow, which reads the crops."""
    if importlib.util.find_spec("PIL") is None:
        emit({"phase": "classifier", "ran": False,
              "why": "Pillow, which load_crop reads crops with, does not "
                     "import here; the CPU tests "
                     "(tests/test_torch_classifier.py) run the classifier",
              "card": card})
        return {}
    from podtpu_torch import cli
    from podtpu_torch.train import classify
    from podtpu_torch.train import train as driver

    tmp = tempfile.mkdtemp(prefix="podtpu_classifier_")
    crops = os.path.join(tmp, "crops")
    crop_tree(crops, np.random.default_rng(SEED + 22), per_class)
    n = per_class * len(CLASSIFIER_CLASSES)
    epochs_rec = []
    logger_cls = classify.MetricLogger

    class Logger(logger_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            epochs_rec.append({"start": time.perf_counter(), "steps": 0})

        def update(self, **kwargs):
            super().update(**kwargs)
            epochs_rec[-1]["steps"] += 1
            epochs_rec[-1]["end"] = time.perf_counter()
            epochs_rec[-1]["loss"] = self.meters["loss"].global_avg

    classify.MetricLogger = Logger
    try:
        torch.cuda.reset_peak_memory_stats()
        model_dir, launches, _, train_s = driven(
            torch, driver, classify.train_classifier, crops,
            os.path.join(tmp, "models"), "chip", batch_size=32,
            image_size=size, max_epochs=epochs, device=dev)
        classify.MetricLogger = logger_cls
        labels, classify_launches, _, classify_s = driven(
            torch, driver, classify.classify_crops, crops, model_dir,
            batch_size=32, device=dev)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(os.path.join(model_dir, "classifier.json")) as fp:
            meta = json.load(fp)
        out_dir = os.path.join(tmp, "cli")
        argv = ["train-crop-classifier", "-i", crops, "-o", out_dir, "-m",
                "cli", "--max-epochs", "1", "--image-size", str(size)]
        _, _, _, cli_train_s = driven(torch, driver, cli.main, argv,
                                      device=dev)
        out_json = os.path.join(tmp, "labels.json")
        argv2 = ["classify-crops", "-i", crops, "--model-dir", out_dir,
                 "--model", "cli", "-o", out_json]
        _, _, _, cli_classify_s = driven(torch, driver, cli.main, argv2,
                                         device=dev)
        with open(out_json) as fp:
            cli_labels = json.load(fp)
    finally:
        classify.MetricLogger = logger_cls
        shutil.rmtree(tmp, ignore_errors=True)
    steps = sum(e["steps"] for e in epochs_rec)
    epoch_s = [e["end"] - e["start"] for e in epochs_rec]
    truth = {p: os.path.basename(os.path.dirname(p)) for p in labels}
    line = {"phase": "classifier", "model": "CropClassifier (ResNet-18-like,"
            " GroupNorm(32), bf16)", "crops": n,
            "classes": len(CLASSIFIER_CLASSES), "image_size": size,
            "batch_size": 32, "epochs": len(epochs_rec), "steps": steps,
            "epoch_s": epoch_s,
            "epoch_losses": [e["loss"] for e in epochs_rec],
            "train_images_per_s": steps * 32 / sum(epoch_s),
            "train_images_per_s_after_first_epoch":
                sum(e["steps"] for e in epochs_rec[1:]) * 32
                / sum(epoch_s[1:]),
            "train_call_s": train_s, "test_accuracy": meta["test_accuracy"],
            "classify_s": classify_s, "classify_images_per_s": n / classify_s,
            "classify_accuracy_on_the_tree": sum(
                labels[p] == truth[p] for p in labels) / len(labels),
            "cli_train_s": cli_train_s, "cli_classify_s": cli_classify_s,
            "launches": {"train": launches, "classify": classify_launches},
            "peak_memory_gib": peak, "card": card}
    emit(line)
    bad = []
    if len(epochs_rec) != epochs or not all(
            np.isfinite(e["loss"]) for e in epochs_rec):
        bad.append("an epoch is missing or its loss is not finite")
    if len(labels) != n or set(labels.values()) - set(CLASSIFIER_CLASSES):
        bad.append("classify_crops labelled another set of crops or with "
                   "an unknown label")
    if len(cli_labels) != n or set(cli_labels.values()) - set(
            CLASSIFIER_CLASSES):
        bad.append("classify-crops labelled another set of crops")
    if not 0 <= meta["test_accuracy"] <= 1 or meta["labels"] != list(
            CLASSIFIER_CLASSES) or meta["image_size"] != size:
        bad.append(f"classifier.json {meta}")
    if any(launches.values()) or any(classify_launches.values()):
        bad.append("a kernel of ours launched")
    if bad:
        raise AssertionError(f"classifier: {bad}")
    return line


# -- phase 16: device-resident data, K steps per dispatch as CUDA graphs -----

CACHED_N = 32      # images in the cached_train cells' device cache
# A graph replay against the same steps run eagerly from the same state:
# the largest difference relative to each tensor's largest value.  The
# replay runs the eager steps' own kernels on the same inputs, so the bits
# are expected to agree.
HELD_LIMIT = 1e-6
# The profiler's name of the one kernel each wrapper call runs once.
KERNEL_FUNCTIONS = {"nms": "nms_scan_kernel",
                    "roi_align_fwd": "roi_align_fwd_kernel",
                    "roi_align_bwd": "roi_align_bwd_kernel"}


class SyntheticSet:
    """``n`` seeded canvases with ``synthetic_batch``'s gt boxes and the
    targets of ``model``'s extra head (an ellipse mask a gt, or 17
    keypoints on one class), as a dataset that ``DeviceDataCache`` reads."""

    def __init__(self, model, mcfg, n, seed):
        rng = np.random.default_rng(seed)
        size = mcfg.image_size
        batch = model_batch(model, rng, n, size, mcfg.max_gt_boxes,
                            n_gt=(1, min(30, mcfg.max_gt_boxes)),
                            side=(16, min(256, min(size) // 2)))
        if head_of(model) == "keypoint":
            batch["labels"] = batch["valid"].astype(np.int32)
        self.batch = batch
        self.image_size = tuple(mcfg.image_size)
        self.max_gt = mcfg.max_gt_boxes
        self.with_masks = "masks" in batch
        self.mask_stride = mcfg.mask_gt_stride
        self.with_keypoints = "keypoints" in batch
        self.num_keypoints = mcfg.num_keypoints

    def __len__(self):
        return len(self.batch["image"])

    def load_batch(self, indices):
        from podtpu_torch.data.dataset import Sample

        b = self.batch
        return [Sample(image=b["image"][i], boxes=b["boxes"][i],
                       labels=b["labels"][i], valid=b["valid"][i],
                       scale=1.0, original_size=self.image_size, index=i,
                       masks=b["masks"][i] if self.with_masks else None,
                       keypoints=b["keypoints"][i] if self.with_keypoints
                       else None) for i in indices]


def snapshot(torch, net, optimizer):
    """Copies of the model's state and the optimiser's (for the held
    checks; a training run never takes one)."""
    return ({k: v.detach().clone() for k, v in net.state_dict().items()},
            [{k: v.clone() for k, v in optimizer.state[p].items()
              if torch.is_tensor(v)}
             for g in optimizer.param_groups for p in g["params"]])


def restore(torch, net, optimizer, snap):
    """``snap`` written back into the same tensors (a captured graph keeps
    reading them)."""
    sd, states = snap
    params = [p for g in optimizer.param_groups for p in g["params"]]
    with torch.no_grad():
        for k, v in net.state_dict().items():
            v.copy_(sd[k])
        for p, st in zip(params, states):
            for k, v in st.items():
                optimizer.state[p][k].copy_(v)


def relative_gap(torch, got, want) -> float:
    """max |got - want| over max |want| (over 1 where ``want`` is 0)."""
    got, want = got.double(), want.double()
    scale = float(want.abs().max()) if want.numel() else 0.0
    gap = float((got - want).abs().max()) if want.numel() else 0.0
    return gap / scale if scale > 0 else gap


def state_gaps(torch, got, want):
    """The largest relative gap over the parameters (and buffers) and over
    the optimiser's state tensors of two snapshots."""
    (gs, go), (ws, wo) = got, want
    params = max(relative_gap(torch, gs[k], ws[k]) for k in ws)
    moments = max((relative_gap(torch, g[k], w[k])
                   for g, w in zip(go, wo) for k in w), default=0.0)
    return params, moments


def held_group(torch, net, optimizer, multi, single, arrays, inputs):
    """One call of the K-step runner ``multi`` (a replay) against K eager
    calls of the cached single step ``single`` from the same state, with
    the same indices, weights, learning rates and draws: the relative gaps
    of the losses, parameters and optimiser state.  The model is left in
    the eager steps' state."""
    idx, w, lrs, draws = inputs
    start = snapshot(torch, net, optimizer)
    replays = multi.replays
    got = multi(arrays, idx, w, lrs, draws)["loss"]
    if multi.replays != replays + 1:
        raise AssertionError("the held group was not a graph replay")
    after_graph = snapshot(torch, net, optimizer)
    restore(torch, net, optimizer, start)
    eager = torch.stack([single(arrays, idx[j], w[j], float(lrs[j]),
                                draws=draws[j])["loss"]
                         for j in range(len(draws))])
    params, moments = state_gaps(torch, after_graph,
                                 snapshot(torch, net, optimizer))
    out = {"loss": relative_gap(torch, got, eager), "parameters": params,
           "optimizer_state": moments}
    out["bitwise"] = not any(out.values())
    out["within_limit"] = max(out["loss"], params, moments) <= HELD_LIMIT
    out["limit"] = HELD_LIMIT
    return out


def group_inputs(torch, cfg, gen, lrs):
    """``make(group) -> (idx [K, B], weights [K, B], lrs [K], draws)``:
    each step's draws from ``gen`` in step order, as ``train()`` makes
    them."""
    from podtpu_torch.train.step import draw_train

    shape = {"boxes": torch.empty((cfg.train.batch_size,
                                   cfg.model.max_gt_boxes, 4),
                                  device="meta")}

    def make(group):
        return (np.stack([i for i, _ in group]),
                np.stack([v.astype(np.float32) for _, v in group]),
                np.asarray(lrs, np.float32),
                [draw_train(gen, cfg, shape) for _ in group])

    return make


def endless_groups(loader, k):
    """Full groups of ``k`` of ``loader``'s raw batches, epoch after
    epoch."""
    epoch = 0
    while True:
        loader.set_epoch(epoch)
        items = list(loader)
        for g in range(len(items) // k):
            yield items[g * k:(g + 1) * k]
        epoch += 1


def cached_setup(torch, dev, model, cfg, n, seed):
    """The model of ``cfg`` (seeded), its optimiser and step, the K-step
    runner and the cached single step, and a device cache of ``n``
    synthetic images with its raw loader."""
    from podtpu_torch.data.device_cache import (DeviceDataCache,
                                                DeviceLoader,
                                                make_cached_multi_step,
                                                make_cached_train_step)
    from podtpu_torch.models.detector import init_parameters, make_detector
    from podtpu_torch.train.optim import make_optimizer
    from podtpu_torch.train.step import make_train_step

    net = make_detector(cfg.model)
    init_parameters(net, torch.Generator().manual_seed(SEED))
    net = net.to(memory_format=torch.channels_last)
    optimizer = make_optimizer(cfg.train, net)
    step = make_train_step(net, optimizer, cfg, device=dev)
    t0 = time.perf_counter()
    cache = DeviceDataCache(SyntheticSet(model, cfg.model, n, seed),
                            device=dev)
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    gather = cfg.train.cache_gather
    return dict(net=net, optimizer=optimizer, cache=cache, cache_s=cache_s,
                multi=make_cached_multi_step(step, cfg.train.
                                             steps_per_dispatch, gather),
                single=make_cached_train_step(step, gather),
                loader=DeviceLoader(cache, cfg.train.batch_size,
                                    shuffle=True, seed=SEED, raw=True))


def release(torch):
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def cached_reference(torch, card, dev, model="faster", optimiser="sgd"):
    """A small float32 model (128^2, as ``check_train_reference``) on the
    card, TF32 off and cuDNN deterministic: two groups of 3 (the eager
    warm-up, then the capture and its replay), then one more group as a
    replay against 3 eager cached steps from the same state with the same
    draws.  Losses, parameters and the optimiser's state must agree within
    ``HELD_LIMIT`` of each tensor's largest value (bitwise is expected)."""
    from podtpu_torch.core.config import Config, DataConfig, TrainConfig

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mcfg = model_config(model, image_size=(128, 128),
                            rpn_pre_nms_topk_train=128,
                            rpn_post_nms_topk_train=128,
                            box_batch_per_image=32, max_gt_boxes=8,
                            compute_dtype="float32", num_classes=4)
        if head_of(model) == "keypoint":
            mcfg = dataclasses.replace(mcfg, num_classes=2)
        cfg = Config(model=mcfg, data=DataConfig(
            aug_policy=MODEL_POLICY.get(model, "miso")),
            train=TrainConfig(steps_per_dispatch=3, optimiser=optimiser))
        s = cached_setup(torch, dev, model, cfg, 12, SEED + 20)
        lr = cfg.train.adam_lr if optimiser != "sgd" else cfg.train.lr
        make = group_inputs(torch, cfg, torch.Generator(
            device=dev).manual_seed(SEED), [lr * 0.5, lr, lr * 0.75])
        groups = endless_groups(s["loader"], 3)
        for _ in range(2):  # the eager warm-up, then the capture
            s["multi"](s["cache"].arrays, *make(next(groups)))
        held = held_group(torch, s["net"], s["optimizer"], s["multi"],
                          s["single"], s["cache"].arrays,
                          make(next(groups)))
        rec = {"phase": phase_name(model, "cached_reference")
               + ("" if optimiser == "sgd" else f"_{optimiser}"),
               "model": model_title(model), "image_size": [128, 128],
               "compute_dtype": "float32", "optimiser": optimiser,
               "steps_per_dispatch": 3, "captures": s["multi"].captures,
               "replays": s["multi"].replays,
               "launches_per_replay": s["multi"].launches_per_replay,
               "held": held, "card": card}
        emit(rec)
        if s["multi"].captures != 1 or not held["within_limit"]:
            raise AssertionError(f"{rec['phase']}: {held}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        release(torch)
    return rec


# Capturable Adam against the CPU's: the card's update reads 1 - beta2^t
# in float32, where 0.999 is 0.99900001287, 1.29e-5 of 1 - beta2 away; the
# square root halves it, so every update moves by about 6.4e-6 of itself.
# A parameter's change is also read through its float32 rounding, one unit
# in the last place of its largest value a step, which is added to this.
ADAM_UPDATE_LIMIT = 1e-5


def adam_capturable_reference(torch, card, dev, steps=3):
    """Adam and AdamW as the cached path runs them on the card (made
    capturable by ``make_train_step``: step counters on the device, the
    rate a 0-d tensor) against the same optimisers on the CPU, which read
    the rate and the bias corrections on the host, the update that
    ``tests/test_torch_cached_step.py`` holds against optax.  Parameters
    of a detector's sizes (a 3x3 conv, an FC layer, biases, a GroupNorm in
    the norm group; one gradient 1e-6 small, near Adam's eps) take the same
    gradients for ``steps`` updates at ``steps`` learning rates.  Each
    parameter within ``HELD_LIMIT`` of its largest value, each parameter's
    total change within ``ADAM_UPDATE_LIMIT`` of its largest plus the
    parameter's rounding (``steps`` float32 epsilons of its largest value),
    the moments within ``HELD_LIMIT`` of theirs."""
    from podtpu_torch.core.config import ModelConfig, TrainConfig
    from podtpu_torch.train.optim import (apply_optimizer, make_capturable,
                                          make_optimizer)

    class Params(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.cfg = ModelConfig()
            self.conv = torch.nn.Conv2d(256, 256, 3)
            self.fc = torch.nn.Linear(12544, 1024)
            self.gn = torch.nn.GroupNorm(32, 256)

    g = torch.Generator().manual_seed(SEED + 30)
    cpu = Params()
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    grads = [[torch.randn(p.shape, generator=g) * (1e-6 if n == "fc.bias"
                                                   else 1.0)
              for n, p in cpu.named_parameters()] for _ in range(steps)]
    out = []
    for optimiser, norm_wd in (("adam", None), ("adamw", 0.0)):
        tcfg = TrainConfig(optimiser=optimiser, norm_weight_decay=norm_wd)
        host = copy.deepcopy(cpu)
        card_net = copy.deepcopy(cpu).to(dev)
        want, got = (make_optimizer(tcfg, host),
                     make_optimizer(tcfg, card_net))
        make_capturable(got)
        start = {n: p.detach().clone() for n, p in host.named_parameters()}
        for s, gs in enumerate(grads):
            lr = tcfg.adam_lr * (0.5, 1.0, 0.75)[s % 3]
            for p, q, gr in zip(host.parameters(), card_net.parameters(), gs):
                p.grad, q.grad = gr.clone(), gr.to(dev)
            apply_optimizer(want, lr)
            apply_optimizer(got, torch.full((), lr, dtype=torch.float32,
                                            device=dev))
        gaps = {"param": 0.0, "update": 0.0, "moments": 0.0}
        update_over_limit = 0.0  # the largest update gap over its limit
        eps = torch.finfo(torch.float32).eps
        for (n, p), q in zip(host.named_parameters(), card_net.parameters()):
            a, b = p.detach(), q.detach().cpu()
            gaps["param"] = max(gaps["param"], float(
                (a - b).abs().max() / a.abs().max()))
            da = a - start[n]
            gap = float((da - (b - start[n])).abs().max() / da.abs().max())
            limit = ADAM_UPDATE_LIMIT + float(
                steps * eps * a.abs().max() / da.abs().max())
            gaps["update"] = max(gaps["update"], gap)
            update_over_limit = max(update_over_limit, gap / limit)
            for key in ("exp_avg", "exp_avg_sq"):
                x, y = want.state[p][key], got.state[q][key].cpu()
                gaps["moments"] = max(gaps["moments"], float(
                    (x - y).abs().max() / x.abs().max()))
        steps_ok = all(int(got.state[q]["step"]) == steps
                       and got.state[q]["step"].device.type == "cuda"
                       for q in card_net.parameters())
        rec = {"phase": f"{optimiser}_capturable_reference",
               "optimiser": optimiser, "groups": len(got.param_groups),
               "capturable": [gr["capturable"] for gr in got.param_groups],
               "steps": steps, "gaps": gaps,
               "update_gap_over_its_limit": update_over_limit,
               "step_counters_ok": steps_ok,
               "limits": {"param": HELD_LIMIT, "update": ADAM_UPDATE_LIMIT,
                          "moments": HELD_LIMIT}, "card": card}
        emit(rec)
        if not all(rec["capturable"]) or not steps_ok \
                or gaps["param"] > HELD_LIMIT \
                or update_over_limit > 1 \
                or gaps["moments"] > HELD_LIMIT:
            raise AssertionError(f"{rec['phase']}: {rec}")
        out.append(rec)
    return out


def cached_train_slice(torch, card, dev, model="faster", timed=5,
                       streamed_images_per_s=None):
    """Training at the ``TrainConfig`` defaults (batch 2, SGD, K = 8 steps
    per dispatch, ``cache_gather`` "slice"; the v2 models under
    ``MODEL_POLICY``) from a device cache of ``CACHED_N`` seeded synthetic
    canvases (the cache's MiB against ``dataset_device_bytes``): one eager
    group, the capture (its seconds) and its replay, one group held
    against 8 eager cached steps from the same state (``held_group``),
    then ``timed`` replays: images/s (wall, draws and input copies
    included), step ms (CUDA-event replay ms / 8), the phase's peak
    memory (allocated, which counts the capture's tensors, and reserved)
    and what the capture added to the reserved memory (the graph's pool),
    our kernels' launches per replay from the launch counts
    (exactly 8 steps' worth) and from ``torch.profiler`` over one more
    replay (equal), with the device's idle share there; the streamed
    ``train`` phase's images/s of the same model beside it."""
    from podtpu_torch.core.config import Config, DataConfig
    from podtpu_torch.data.device_cache import dataset_device_bytes
    from podtpu_torch.ops import _build

    head = head_of(model)
    cfg = Config(model=model_config(model, **({} if head == "keypoint"
                                              else dict(num_classes=4))),
                 data=DataConfig(aug_policy=MODEL_POLICY.get(model, "miso")))
    mcfg, k, bs = cfg.model, cfg.train.steps_per_dispatch, \
        cfg.train.batch_size
    prefix = phase_name(model, "")
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    s = cached_setup(torch, dev, model, cfg, CACHED_N, SEED + 21)
    cache, multi, arrays = s["cache"], s["multi"], s["cache"].arrays
    cache_mib = sum(v.numel() * v.element_size()
                    for v in arrays.values()) / 2 ** 20
    want_mib = dataset_device_bytes(
        CACHED_N, mcfg.image_size, mcfg.max_gt_boxes, head == "mask",
        mcfg.mask_gt_stride, head == "keypoint", mcfg.num_keypoints) / 2 ** 20
    make = group_inputs(torch, cfg, torch.Generator(device=dev).manual_seed(
        SEED), [cfg.train.lr] * k)
    groups = endless_groups(s["loader"], k)
    losses = []
    t0 = time.perf_counter()
    losses.append(multi(arrays, *make(next(groups)))["loss"])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    release(torch)  # what the capture adds to the reserved memory
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    losses.append(multi(arrays, *make(next(groups)))["loss"])
    torch.cuda.synchronize()
    first_replay_s = time.perf_counter() - t0
    graph_pool = (torch.cuda.memory_reserved() - reserved) / 2 ** 30
    held = held_group(torch, s["net"], s["optimizer"], multi, s["single"],
                      arrays, make(next(groups)))
    torch.cuda.synchronize()
    _build.reset_launches()
    events = []
    t_all = time.perf_counter()
    for _ in range(timed):
        ins = make(next(groups))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(multi(arrays, *ins)["loss"])
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    replay_ms = sorted(a.elapsed_time(b) for a, b in events)
    launches_timed = {n: _build.launches[n] for n in KERNELS}
    launches = {n: v / timed for n, v in launches_timed.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    peak_reserved = torch.cuda.max_memory_reserved() / 2 ** 30
    counted = []

    def one_group():
        before = {n: _build.launches[n] for n in KERNELS}
        multi(arrays, *make(next(groups)))
        counted.append({n: _build.launches[n] - before[n] for n in KERNELS})

    prof = device_profile(torch, one_group, reps=1, unit="replay")
    runs = prof["port_kernel_runs_per_replay"]
    profiled = {n: runs.get(f, 0) for n, f in KERNEL_FUNCTIONS.items()}
    want = {n: k * v for n, v in per_step_launches(model).items()}
    loss_values = [float(v) for t in losses for v in t]
    median = statistics.median(replay_ms)
    rec = {"phase": prefix + "cached_train", "model": model_title(model),
           "image_size": list(mcfg.image_size),
           "compute_dtype": mcfg.compute_dtype, "batch_size": bs,
           "steps_per_dispatch": k, "cache_gather": cfg.train.cache_gather,
           "aug_policy": cfg.data.aug_policy, "images": CACHED_N,
           "cache_mib": cache_mib, "dataset_device_mib": want_mib,
           "cache_s": s["cache_s"], "warm_group_s": warm_s,
           "capture_s": multi.capture_s,
           "first_replay_s": first_replay_s - multi.capture_s,
           "held": held, "replays": timed, "wall_s": wall,
           "images_per_s": timed * k * bs / wall,
           "replay_ms_p50": median, "replay_ms_max": replay_ms[-1],
           "step_ms_p50": median / k,
           "device_idle_share": prof["device_idle_share"],
           "device_busy_ms_per_replay": prof["device_busy_ms"],
           "peak_memory_gib": peak, "peak_reserved_gib": peak_reserved,
           "graph_pool_gib": graph_pool,
           "launches_per_replay": launches, "launches": launches_timed,
           "profiled_launches_per_replay": profiled,
           "counted_launches_profiled_replay": counted[-1],
           "streamed_images_per_s": streamed_images_per_s,
           "loss_first": loss_values[0], "loss_last": loss_values[-1],
           "profile": prof, "card": card}
    emit(rec)
    bad = []
    if not all(np.isfinite(v) for v in loss_values):
        bad.append("a loss is not finite")
    if multi.captures != 1:
        bad.append(f"{multi.captures} captures")
    if not held["within_limit"]:
        bad.append(f"held group {held}")
    if launches != want or counted[-1] != want or profiled != want:
        bad.append(f"launches per replay {launches}, profiled replay "
                   f"counted {counted[-1]} and ran {profiled}, expected "
                   f"{want}")
    if abs(cache_mib - want_mib) > 0.05 * want_mib:
        bad.append(f"cache {cache_mib} MiB against {want_mib}")
    del s, cache, multi, arrays, losses
    release(torch)
    if bad:
        raise AssertionError(f"{prefix}cached_train: {bad}")
    return rec


def windowed_driver_phase(torch, card, dev, driver_first, config=None,
                          size=(1024, 1024), n_images=24):
    """``train()`` for one epoch on the driver phase's images with
    ``PODTPU_DEVICE_CACHE_BYTES`` set so that a window holds 8 samples
    (a multiple of the batch, so the batches are the full cache's), held
    against the driver phase's first epoch (the full cache, from the same
    start): every step's dataset indices and image weights equal, the
    epoch loss and the parameters within ``HELD_LIMIT``."""
    from podtpu_torch.core.config import Config
    from podtpu_torch.data import Project, imageio
    from podtpu_torch.data.device_cache import dataset_device_bytes
    from podtpu_torch.train import train as driver

    mcfg = (config or Config()).model
    per = dataset_device_bytes(1, size, mcfg.max_gt_boxes)
    images, metas = in_memory_images(np.random.default_rng(SEED + 8),
                                     n_images, size)
    project = Project()
    for m in metas:
        project.add_image(m)
    tmp = tempfile.mkdtemp(prefix="podtpu_windowed_")
    read_rgb = imageio.read_rgb
    imageio.read_rgb = images.__getitem__
    budget = os.environ.get("PODTPU_DEVICE_CACHE_BYTES")
    os.environ["PODTPU_DEVICE_CACHE_BYTES"] = str(2 * 8 * per + 1)
    try:
        _, launches, rec, seconds = driven(
            torch, driver, driver.train, project, output_dir=tmp,
            name="windowed", batch_size=2, seed=0, config=config,
            device=dev, max_epochs=1, keep=("batches", "states"))
    finally:
        imageio.read_rgb = read_rgb
        if budget is None:
            del os.environ["PODTPU_DEVICE_CACHE_BYTES"]
        else:
            os.environ["PODTPU_DEVICE_CACHE_BYTES"] = budget
        shutil.rmtree(tmp, ignore_errors=True)
    want = driver_first
    got_batches, want_batches = rec["batches"], want["batches"]
    same_batches = len(got_batches) == len(want_batches) and all(
        np.array_equal(gi, wi) and np.array_equal(gw, ww)
        for (gi, gw), (wi, ww) in zip(got_batches, want_batches))
    epoch = rec["epochs"][0]
    loss_gap = abs(epoch["loss"] - want["loss"]) / abs(want["loss"])
    state = rec["states"][0]
    param_gap = max(relative_gap(torch, state[k], v)
                    for k, v in want["state"].items())
    line = {"phase": "windowed_driver", "images": n_images,
            "window": 8, "budget_bytes": 2 * 8 * per + 1,
            "steps": epoch["steps"], "seconds": seconds,
            "train_s": epoch["eval_start"] - epoch["start"],
            "train_images_per_s": epoch["steps"] * 2
            / (epoch["eval_start"] - epoch["start"]),
            "full_cache_train_images_per_s": want["train_images_per_s"],
            "same_batches": same_batches, "epoch_loss": epoch["loss"],
            "full_cache_epoch_loss": want["loss"],
            "epoch_loss_gap": loss_gap, "parameter_gap": param_gap,
            "bitwise": loss_gap == 0 and param_gap == 0,
            "limit": HELD_LIMIT, "launches": launches, "card": card}
    emit(line)
    check_driver_launches("windowed_driver", launches, epoch["steps"],
                          epoch["eval_batches"])
    if not same_batches or max(loss_gap, param_gap) > HELD_LIMIT:
        raise AssertionError(f"windowed_driver: batches equal "
                             f"{same_batches}, loss gap {loss_gap}, "
                             f"parameter gap {param_gap}")
    return line


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from podtpu_torch.ops import _build, nms, roi_align

    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.library()
    log = (_build.BUILD_DIR / "nvcc.log").read_text()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "entry function" in ln]})

    native_built = native_build_line()

    from podtpu_torch.core.config import ModelConfig, fasterrcnn_v2_config

    nms_rec = check_nms(torch, nms, "cuda")
    roi_rec = check_roi_align(torch, roi_align, "cuda")
    check_roi_align(torch, roi_align, "cuda", b=TRAIN_B, k=TRAIN_K,
                    seed=SEED + 3, case="train_b2_k512_c256_bf16")
    bwd_rec = check_roi_align_bwd(torch, roi_align, "cuda")
    check_roi_align_cases(torch, roi_align, "cuda")
    for model in MODELS:
        check_reference(torch, "cuda", model=model)
    captured = []
    serve = serve_slice(torch, card, "cuda", ModelConfig(num_classes=4),
                        captured)
    serve_v2 = serve_slice(torch, card, "cuda", fasterrcnn_v2_config(
        ModelConfig(num_classes=4)), captured, model="faster_v2")
    for model in ("faster", "mask", "keypoint"):
        check_train_reference(torch, "cuda", model=model)
    check_train_reference(torch, "cuda", model="faster_v2",
                          seeds=range(SEED, SEED + 2))
    train = train_slice(torch, card, "cuda")
    captured.append(("train", capture_nms(nms, train.pop("replay"))))
    # Phase 16: the device-resident data and K steps per dispatch.
    for model, optimiser in (("faster", "sgd"), ("faster", "adamw"),
                             ("retinanet", "sgd")):
        cached_reference(torch, card, "cuda", model, optimiser)
    adam_capturable_reference(torch, card, "cuda")
    cached = {"faster": cached_train_slice(
        torch, card, "cuda", streamed_images_per_s=train["images_per_s"])}
    tmp, model_dir, driver, (eval_nms, eval_roi), first_epoch = \
        driver_phase(torch, card, "cuda", train["images_per_s"])
    windowed_driver_phase(torch, card, "cuda", first_epoch)
    del first_epoch
    try:
        infer, (infer_nms, infer_roi) = infer_phase(torch, card, "cuda",
                                                    model_dir)
        # Phase 15a: tiled scan inference on the trained model.
        tiled_launches, tiled_nms, tiled_roi = tiled_phases(
            torch, card, "cuda", model_dir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tiled_out = {"launches": tiled_launches, "nms": tiled_nms,
                 "roi": tiled_roi}
    cli, (cli_nms, cli_roi) = cli_phase(torch, card, "cuda", native_built)
    head_captured = {"k2": [], "k3": []}
    mask_train = train_slice(torch, card, "cuda", model="mask", timed=10)
    capture_step(mask_train.pop("replay"), ModelConfig().mask_pool_size,
                 head_captured, "mask_train")
    cached["mask"] = cached_train_slice(
        torch, card, "cuda", "mask", timed=3,
        streamed_images_per_s=mask_train["images_per_s"])
    mask_eval = head_eval_slice(torch, card, "cuda", head_captured, "mask")
    mask_driver = head_driver_phase(
        torch, card, "cuda", "mask", after=lambda d: tiled_head_phase(
            torch, card, "cuda", d, "mask", tiled_out))
    kp_train = train_slice(torch, card, "cuda", model="keypoint", timed=10)
    kp_size = ModelConfig().keypoint_pool_size
    capture_step(kp_train.pop("replay"), kp_size, head_captured,
                 "keypoint_train")
    capture_step(kp_train.pop("replay_expand"), kp_size, head_captured,
                 "keypoint_train_expand")
    cached["keypoint"] = cached_train_slice(
        torch, card, "cuda", "keypoint", timed=3,
        streamed_images_per_s=kp_train["images_per_s"])
    kp_eval = head_eval_slice(torch, card, "cuda", head_captured, "keypoint")
    kp_driver = head_driver_phase(torch, card, "cuda", "keypoint")
    v2_captured = {"k2": [], "k3": []}
    v2_train = train_slice(torch, card, "cuda", model="faster_v2", timed=10)
    capture_step(v2_train["replay"], ModelConfig().roi_pool_size,
                 v2_captured, "v2_train")
    captured.append(("v2_train", capture_nms(nms, v2_train.pop("replay"))))
    cached["faster_v2"] = cached_train_slice(
        torch, card, "cuda", "faster_v2", timed=3,
        streamed_images_per_s=v2_train["images_per_s"])
    mask_v2_train = train_slice(torch, card, "cuda", model="mask_v2",
                                timed=5, extra_steps=0)
    capture_step(mask_v2_train.pop("replay"), ModelConfig().mask_pool_size,
                 head_captured, "mask_v2_train")
    cached["mask_v2"] = cached_train_slice(
        torch, card, "cuda", "mask_v2", timed=3,
        streamed_images_per_s=mask_v2_train["images_per_s"])
    v2_driver = v2_driver_phase(torch, card, "cuda")
    # Phase 14: the one-stage families.
    for model in ONE_STAGE:
        check_train_reference(torch, "cuda", model=model,
                              seeds=range(SEED, SEED + 2))
    one_stage = {}
    for model in ("retinanet", "fcos"):
        one_stage[f"{model}_serve"] = serve_slice(
            torch, card, "cuda", model_config(model, num_classes=4),
            captured, model=model)
    for model in ONE_STAGE:
        streamed = train_slice(torch, card, "cuda", model=model, timed=10)
        one_stage[f"{model}_train"] = streamed["launches"]
        cached[model] = cached_train_slice(
            torch, card, "cuda", model, timed=3,
            streamed_images_per_s=streamed["images_per_s"])
        del streamed
    for model in ("fcos", "retinanet_v2"):
        after = None if model == "fcos" else (
            lambda d: tiled_head_phase(torch, card, "cuda", d,
                                       "retinanet_v2", tiled_out))
        paths, calls = one_stage_driver_phase(torch, card, "cuda", model,
                                              after=after)
        one_stage.update(paths)
        captured += calls
    # Phase 15c: the crop classifier.
    check_classifier_reference(torch, "cuda")
    classifier_phase(torch, card, "cuda")
    captured += [("evaluate_model", eval_nms), ("infer", infer_nms),
                 ("cli_evaluate_model", cli_nms)] + tiled_out["nms"]
    k1 = check_nms_main_path(torch, nms, captured)
    k2_tiled = check_roi_align_main_path(torch, roi_align, [
        ("evaluate_model", eval_roi), ("infer", infer_roi),
        ("cli_evaluate_model", cli_roi)] + tiled_out["roi"])
    k2_14 = check_roi_align_main_path(torch, roi_align, head_captured["k2"])
    k3_14 = check_roi_align_bwd_main_path(torch, roi_align,
                                          head_captured["k3"])
    k2_14 = dict(zip((p for p, _ in head_captured["k2"]), k2_14))
    k3_14 = dict(zip((p for p, _ in head_captured["k3"]), k3_14))
    k2_7 = dict(zip((p for p, _ in v2_captured["k2"]),
                    check_roi_align_main_path(torch, roi_align,
                                              v2_captured["k2"])))
    k3_7 = dict(zip((p for p, _ in v2_captured["k3"]),
                    check_roi_align_bwd_main_path(torch, roi_align,
                                                  v2_captured["k3"])))
    if not k2_14["keypoint_train_expand"]["rois_crossing_canvas"] > 0:
        raise AssertionError("no RoI of the keypoint step at "
                             "keypoint_roi_expand 1.3 crosses the canvas")

    def launches(name):
        by_path = {"serve": serve.get(name, 0),
                   "train": train["launches"].get(name, 0),
                   "driver": driver["driver"][name],
                   "evaluate_model": driver["evaluate_model"][name],
                   "infer": infer[name], "cli_train": cli["cli_train"][name],
                   "cli_infer": cli["cli_infer"][name],
                   "mask_train": mask_train["launches"].get(name, 0),
                   "mask_eval": mask_eval.get(name, 0),
                   **{k: v[name] for k, v in mask_driver.items()},
                   "keypoint_train": kp_train["launches"].get(name, 0),
                   "keypoint_eval": kp_eval.get(name, 0),
                   **{k: v[name] for k, v in kp_driver.items()},
                   "v2_serve": serve_v2.get(name, 0),
                   "v2_train": v2_train["launches"].get(name, 0),
                   "mask_v2_train": mask_v2_train["launches"].get(name, 0),
                   **{k: v[name] for k, v in v2_driver.items()},
                   **{k: v.get(name, 0) for k, v in one_stage.items()},
                   **{k: v[name] for k, v in tiled_out["launches"].items()},
                   # The cached_train phases' timed replays.
                   **{f"{m}_cached_train": r["launches"][name]
                      for m, r in cached.items()}}
        return dict(launches=sum(by_path.values()),
                    launches_by_path={k: v for k, v in by_path.items() if v})

    def at(rec, case=None):
        out = {"case": case or rec["case"], "ms": rec["kernel_ms"]
               if "kernel_ms" in rec else rec["ms"],
               "bound_ms": rec["bound_ms"], "max_abs_err": rec["max_abs_err"]}
        if "rois_crossing_canvas" in rec:
            out["rois_crossing_canvas"] = rec["rois_crossing_canvas"]
        return out

    kernels = [
        dict(name="nms", route="cuda", source="podtpu_torch/csrc/nms.cu",
             replaces="podtpu/ops/pallas/nms_kernel.py:46",
             **launches("nms"), max_abs_err=nms_rec["max_abs_err"],
             ms=nms_rec["ms"], plain_ms=nms_rec["plain_ms"],
             bound_ms=nms_rec["bound_ms"], bound_by=nms_rec["bound_by"],
             library_ms=None, by_output_size=None,
             # The one-stage paths' single class-offset segment an image,
             # each call as the path made it.
             one_stage={f"{path}_call{k}": {
                 "shape": r["shape"], "ms": r["kernel_ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"],
                 "valid_per_segment": r["valid_per_segment"],
                 "kept_per_segment": r["kept_per_segment"]}
                 for (path, k), r in k1.items()
                 if path.startswith(("retinanet", "fcos"))},
             # The tiled paths' first batch of 8 tiles, each call as the
             # path made it.
             tiled={f"{path}_call{k}": {
                 "shape": r["shape"], "ms": r["kernel_ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "mismatches": r["mismatches"],
                 "valid_per_segment": r["valid_per_segment"],
                 "kept_per_segment": r["kept_per_segment"]}
                 for (path, k), r in k1.items()
                 if path.startswith("tiled")}),
        dict(name="roi_align_fwd", route="cuda",
             source="podtpu_torch/csrc/roi_align.cu",
             replaces="podtpu/ops/pallas/roi_align_kernel.py:157",
             **launches("roi_align_fwd"),
             max_abs_err=roi_rec["max_abs_err"], ms=roi_rec["ms"],
             plain_ms=roi_rec["plain_ms"], bound_ms=roi_rec["bound_ms"],
             bound_by=roi_rec["bound_by"], library_ms=None,
             by_output_size={
                 "7": {**at(roi_rec, "serving_b4_k1000_c256_bf16"),
                       **{p: at(r) for p, r in k2_7.items()}},
                 "14": {**at(k2_14["mask_train"]),
                        **{p: at(r) for p, r in k2_14.items()
                           if p != "mask_train"}}},
             # The tiled paths' first batch of 8 tiles, at 7 (and 14 for
             # the mask model).
             tiled={r["case"]: at(r) | {"shape": r["shape"],
                                        "plain_ms": r["plain_ms"],
                                        "bound_by": r["bound_by"]}
                    for r in k2_tiled if r["case"].startswith("tiled")}),
        dict(name="roi_align_bwd", route="cuda",
             source="podtpu_torch/csrc/roi_align.cu",
             replaces="podtpu/ops/pallas/roi_align_kernel.py:226",
             **launches("roi_align_bwd"),
             max_abs_err=bwd_rec["max_abs_err"], ms=bwd_rec["ms"],
             plain_ms=bwd_rec["plain_ms"], bound_ms=bwd_rec["bound_ms"],
             bound_by=bwd_rec["bound_by"], library_ms=None,
             by_output_size={"7": {**at(bwd_rec, "train_b2_k512_c256_bf16"),
                                   **{p: at(r) for p, r in k3_7.items()}},
                             "14": {**at(k3_14["mask_train"]),
                                    **{p: at(r) for p, r in k3_14.items()
                                       if p != "mask_train"}}}),
    ]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
