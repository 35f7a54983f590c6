"""Command-line tools: detection and training on the card.

Counterpart of ``waldboost_tpu/cli.py``: ``detect_main`` serves one model
through :class:`~waldboost_tpu_torch.parallel.bucket.BucketedDetector`
(any frame size, one set-up per size bucket) or several models through
:func:`waldboost_tpu_torch.detect`, then applies the score threshold and
the host NMS and prints JSON; ``train_main`` trains a detector on the
synthetic stream or a bbGt-style dataset (the native loader of
:mod:`waldboost_tpu_torch.io`) and saves it.  Both take ``--device``, the
card when not given (``--device cpu`` runs each kernel's plain version).
The benchmark command is not ported yet (ROADMAP item A4).
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np

__all__ = ["detect_main", "train_main", "bench_main"]


def _load_gray(path: str) -> np.ndarray:
    """An image file as a 2-D array: ``.npy`` as saved (its dtype kept;
    3-D arrays averaged over the last axis), else decoded to gray by cv2
    (PIL without cv2)."""
    if path.endswith(".npy"):
        img = np.load(path)
        if img.ndim == 3:
            img = img.mean(axis=2).astype(img.dtype)
        return img
    try:
        import cv2
    except ImportError:
        from PIL import Image
        return np.asarray(Image.open(path).convert("L"))
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise IOError(f"cannot read {path}")
    return img


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the current CUDA "
                        "device; 'cpu' runs the kernels' plain versions)")


def detect_main(argv=None):
    """Detect objects in images with one or more models; JSON to stdout."""
    import waldboost_tpu_torch as wt

    p = argparse.ArgumentParser(description="WaldBoost detector (PyTorch/"
                                            "CUDA)")
    p.add_argument("-m", "--model", action="append", required=True,
                   help="Model file(s) (.pb); repeat for multiple models")
    p.add_argument("files", nargs="+", help="Images to process")
    p.add_argument("--n-per-oct", type=int, default=None,
                   help="Override pyramid scales per octave")
    p.add_argument("--iou-threshold", type=float, default=0.2,
                   help="NMS IoU threshold")
    p.add_argument("--score-threshold", type=float, default=0.0)
    p.add_argument("--bucket", type=int, default=128,
                   help="Image-size bucket granularity (one set-up per "
                        "bucket; images are zero-padded up)")
    _add_device(p)
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.DEBUG if args.verbose
                        else logging.WARNING)

    models = []
    for mf in args.model:
        model = wt.load(mf, device=args.device)
        if args.n_per_oct is not None:
            model.channel_opts["n_per_oct"] = args.n_per_oct
        models.append(model)

    images = [_load_gray(f) for f in args.files]
    if len(models) == 1:
        from .parallel.bucket import BucketedDetector

        det = BucketedDetector(models[0], bucket=args.bucket,
                               device=models[0].device)
        boxes_per_image = det.detect_many(images)
    else:
        # several models: one shared channel canvas, one walk each
        boxes_per_image = [wt.detect(im, *models) for im in images]

    results = []
    for filename, boxes in zip(args.files, boxes_per_image):
        if len(boxes):
            keep = boxes.get_field("scores") >= args.score_threshold
            boxes = boxes[np.flatnonzero(keep)]
            boxes = wt.bbx.non_max_suppression(
                boxes, iou_threshold=args.iou_threshold)
        results.append({
            "filename": filename,
            "boxes": boxes.get().astype(int).tolist(),
            "scores": boxes.get_field("scores").astype(float).tolist()
            if len(boxes) else [],
            "labels": boxes.get_field("label").astype(int).tolist()
            if boxes.has_field("label") else [],
        })
    print(json.dumps(results, indent=1))


def train_main(argv=None):
    """Train a detector on synthetic data (default) or a bbGt-style dataset
    (``--images DIR --annotations DIR``, read through the native C++
    prefetching loader when it builds, Python fallbacks otherwise), save
    it, and print one JSON line of its final statistics."""
    import waldboost_tpu_torch as wt
    from .utils import fake_data_generator

    p = argparse.ArgumentParser(description="WaldBoost trainer (PyTorch/"
                                            "CUDA)")
    p.add_argument("-o", "--output", required=True, help="Output model file")
    p.add_argument("--images", default=None, metavar="DIR",
                   help="Training image directory (bbGt-style dataset); "
                        "default: synthetic fake_data_generator stream")
    p.add_argument("--annotations", default=None, metavar="DIR",
                   help="bbGt v3 annotation directory (same-stem .txt files)")
    p.add_argument("--image-ext", default=".pgm",
                   help="Image extension in --images (native loader decodes "
                        "P5/P6 PNM; others fall back to PIL)")
    p.add_argument("--length", type=int, default=32, help="Number of stages")
    p.add_argument("--shape", type=int, nargs=3, default=(12, 12, 4),
                   metavar=("H", "W", "C"), help="Detection window shape")
    p.add_argument("--channels", default="grad_hist",
                   help="Channel function registry name")
    p.add_argument("--shrink", type=int, default=2)
    p.add_argument("--n-per-oct", type=int, default=8)
    p.add_argument("--smooth", type=int, default=1)
    p.add_argument("--alpha", type=float, default=0.2, help="SPRT alpha")
    p.add_argument("--max-depth", type=int, default=2)
    p.add_argument("--min-tp", type=int, default=1000)
    p.add_argument("--min-fp", type=int, default=1000)
    p.add_argument("--fpga", action="store_true",
                   help="FPGA mode: bank-restricted features, quantized "
                        "responses")
    p.add_argument("--learner-state", default=None,
                   help="Learner pickle for resume (saved next to the model)")
    p.add_argument("--seed", type=int, default=None)
    _add_device(p)
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    logging.basicConfig(level=15 if args.verbose else logging.INFO)

    opts = dict(shrink=args.shrink, n_per_oct=args.n_per_oct,
                smooth=args.smooth, channels=args.channels)
    model = wt.Model(tuple(args.shape), opts, device=args.device)
    pool = wt.SamplePool(min_tp=args.min_tp, min_fp=args.min_fp,
                         seed=args.seed)
    dataset = None
    if args.images:
        from .io import bbgt_training_stream
        data = dataset = bbgt_training_stream(
            args.images, args.annotations or args.images,
            image_ext=args.image_ext, loop=True)
    else:
        data = fake_data_generator(seed=args.seed)

    try:
        if args.fpga:
            learner = wt.fpga.train(model, data, pool=pool,
                                    length=args.length,
                                    max_depth=args.max_depth)
        else:
            learner = wt.train(model, data, pool=pool, length=args.length,
                               learner=wt.Learner(alpha=args.alpha,
                                                  max_depth=args.max_depth))
    finally:
        if dataset is not None and hasattr(dataset, "close"):
            dataset.close()  # stop the native loader's worker threads
    model.save(args.output)
    if args.learner_state:
        learner.save(args.learner_state)
    stats = learner.get_stats()
    print(json.dumps({
        "stages": len(model),
        "false_positive_rate": float(stats["false_positive_rate"][-1]),
        "true_positive_rate": float(stats["true_positive_rate"][-1]),
        "loss": float(stats["loss"][-1]),
        "model": args.output,
    }))


def bench_main(argv=None):
    """The port's benchmark: not ported yet."""
    raise NotImplementedError("the port's benchmark is not ported yet "
                              "(ROADMAP item A4)")


if __name__ == "__main__":
    detect_main()
