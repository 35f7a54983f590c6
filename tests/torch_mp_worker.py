"""Multi-process mesh worker of the PyTorch port (torch and the port only).

Launched once per rank by ``tests/test_torch_multiprocess.py`` and by
``chip_smoke.py``'s phase 8f: each process joins a ``torch.distributed``
group (gloo on the CPU, or NCCL with one card per rank), builds a mesh of
``--local-devices`` shards on ``--device`` (the mesh spans every rank) and
runs the SAME program as every other rank (:func:`run_program`):

  1. an 8-stage ``wt.train`` with the device pool sharded over the mesh
     (each process mines the same seeded stream),
  2. a batched sharded detection over the whole mesh: tests/mp_worker.py's
     noise frames, and 8 frames of ``fake_data_generator(seed=6)``, on
     which the trained model keeps windows.

With ``--golden`` it runs the program a second time with each stage's
tree fit held to, and replaced by, the golden's (teacher forcing, as the
tests of the device-pool trainer do).  Rank 0 writes the outputs to
``--out`` (and ``<out>.forced.npz``).
"""

import argparse
import contextlib
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True,
                    help="init_method of the process group (file:// or "
                         "tcp://)")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--device", default="cpu",
                    help="the device of this rank's shards; 'cuda' is the "
                         "rank's own card (cuda:rank)")
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--golden", default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from waldboost_tpu_torch.parallel.mesh import is_multiprocess, make_mesh

    device = args.device
    if device == "cuda":
        torch.cuda.set_device(args.rank)
        device = f"cuda:{args.rank}"
    dist.init_process_group(args.backend, init_method=args.init,
                            rank=args.rank, world_size=args.world)
    try:
        mesh = make_mesh(devices=[device] * args.local_devices)
        assert mesh.size == args.world * args.local_devices, mesh
        assert is_multiprocess(mesh) == (args.world > 1)
        out = args.out if args.rank == 0 else None
        run_program(mesh, out)
        if args.golden:
            run_program(mesh, out and out + ".forced.npz",
                        forced=np.load(args.golden))
        # every rank stays until the others' collectives are done
        dist.barrier()
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def forced_fits(golden):
    """Each stage's fit held to the golden's heap tree (structure and
    thresholds bitwise, predictions within 1e-5) and replaced by it."""
    import torch

    from waldboost_tpu_torch.ops.fit import TreeFitResult
    from waldboost_tpu_torch.parallel import train_step as tts

    real = tts.fit_tree_complete
    used = []

    def fit(*args, **kwargs):
        got = real(*args, **kwargs)
        s = len(used)
        want = TreeFitResult(*(
            torch.from_numpy(np.array(golden[f"s{s}_heap_{k}"])).to(
                got.feature.device)
            for k in ("feature", "threshold", "left", "right", "pred")))
        for k in ("feature", "left", "right", "threshold"):
            if not torch.equal(getattr(got, k).to(getattr(want, k).dtype),
                               getattr(want, k)):
                raise AssertionError(f"stage {s}: the fit's {k} differs "
                                     f"from the golden's")
        if float((got.pred - want.pred).abs().max()) > 1e-5:
            raise AssertionError(f"stage {s}: the fit's predictions differ "
                                 f"from the golden's by more than 1e-5")
        used.append(s)
        return want

    tts.fit_tree_complete = fit
    try:
        yield used
    finally:
        tts.fit_tree_complete = real


def run_program(mesh, out_path, forced=None):
    """The shared train + detect program (also run in one process by the
    test, for the reference outputs); ``forced``: a golden whose trees the
    fits are held to and replaced by."""
    import waldboost_tpu_torch as wt
    from waldboost_tpu_torch.parallel.detect import \
        make_batched_detector_boxes
    from waldboost_tpu_torch.parallel.mesh import gather
    from waldboost_tpu_torch.utils import fake_data_generator

    gen = fake_data_generator(seed=5)
    model = wt.Model((12, 12, 4), dict(shrink=2, n_per_oct=2, smooth=1,
                                       channels="grad_hist"),
                     device=mesh.local_devices[0])
    with (forced_fits(forced) if forced is not None
          else contextlib.nullcontext()):
        learner = wt.train(model, gen, mesh=mesh, length=8,
                           pool=wt.SamplePool(min_tp=64, min_fp=64, seed=0),
                           learner=wt.Learner(alpha=0.2, max_depth=2))

    rng = np.random.RandomState(3)
    images = rng.randint(0, 256, (mesh.size, 48, 64)).astype(np.uint8)
    fn, _ = make_batched_detector_boxes(model, (48, 64), mesh=mesh, k=64,
                                        nms_iou=0.5)
    rects, scores, valid, count, _ = (gather(o, mesh).cpu().numpy()
                                      for o in fn(images))
    scene = scene_frames()
    fn, _ = make_batched_detector_boxes(model, scene.shape[1:], mesh=mesh,
                                        k=1024, nms_iou=0.5)
    scene_out = {f"scene_{k}": gather(o, mesh).cpu().numpy()
                 for k, o in zip(("rects", "scores", "valid", "count"),
                                 fn(scene))}
    if out_path:
        stages = {f"{k}{t}": s[k] for t, (s, _) in enumerate(model)
                  for k in ("feature", "threshold", "left", "right",
                            "prediction")}
        np.savez(out_path, theta=np.asarray(model.theta, np.float64),
                 losses=np.asarray(learner.losses, np.float64),
                 rects=rects, scores=scores, valid=valid, count=count,
                 **scene_out, **stages)


def scene_frames(n=8):
    """(8, 256, 256) uint8 frames of ``fake_data_generator(seed=6)``."""
    from waldboost_tpu_torch.utils import fake_data_generator

    it = fake_data_generator(seed=6)
    return np.stack([next(it)["image"] for _ in range(n)])


if __name__ == "__main__":
    main()
