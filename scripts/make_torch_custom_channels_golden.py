"""Write the golden of serving a model over a user-defined channel function.

Runs the JAX package on the CPU.  ``user_grad`` (two float32 channels: the
image and ``|gx|`` of ``ops.image.gradients``) is registered as a
``ChannelFunction`` with no canvas form, so every canvas is built level by
level (``polyphase.py::_channel_canvas_per_level``).  A (12, 12, 2) model
over it is trained with ``wb.train`` for ``LENGTH`` stages on
``fake_data_generator(seed=7)`` (``SamplePool(min_tp=200, min_fp=200,
seed=0)``, ``Learner(alpha=0.2, max_depth=2)``), then serves
``N_FRAMES`` VGA frames of ``scene_generator(seed=100)`` through
``make_batched_detector_boxes(k=K)``: every survivor, no NMS (XLA:CPU's
``nms_device`` keeps a box at an IoU of exactly 1/2, where the port
follows the host NMS; ROADMAP section C).

Saved to ``tests/data/torch_port_custom_channels_golden.npz``: the model
file's bytes (``model``), the frames' SHA-256, and the outputs ``rects``,
``scores``, ``valid`` and ``count``.  ``chip_smoke.py`` phase 10 and
``tests/test_torch_custom_channels.py`` register the port's own
``user_grad`` under the same name and hold the port to them bitwise.

Usage (from the repository root, about 30 s):

    python scripts/make_torch_custom_channels_golden.py
"""

import argparse
import hashlib
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (12, 12, 2)
OPTS = dict(shrink=2, n_per_oct=8, smooth=1, channels="user_grad")
LENGTH = 8
TRAIN_SEED = 7
N_FRAMES, SCENE_SEED, VGA = 8, 100, (480, 640)
K = 4096


def user_grad(image):
    """The image and ``|gx|`` as two float32 channels (JAX)."""
    import jax.numpy as jnp
    from waldboost_tpu.ops import image as imops
    im = image.astype(jnp.float32)
    gx, _ = imops.gradients(im)
    return jnp.stack([im, jnp.abs(gx)])


def golden_frames(scene_generator, n=N_FRAMES):
    gen = scene_generator(seed=SCENE_SEED, hw=VGA)
    return np.stack([next(gen)["image"] for _ in range(n)])


def frames_digest(frames) -> str:
    return hashlib.sha256(np.ascontiguousarray(frames).tobytes()).hexdigest()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "tests", "data", "torch_port_custom_channels_golden.npz"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    sys.path.insert(0, ROOT)
    import waldboost_tpu as wb
    from waldboost_tpu.parallel.detect import make_batched_detector_boxes
    from waldboost_tpu.utils import fake_data_generator, scene_generator

    wb.channels.register_channel_function(
        wb.channels.ChannelFunction("user_grad", user_grad, 2))
    t0 = time.time()
    model = wb.Model(SHAPE, OPTS)
    wb.train(model, fake_data_generator(seed=TRAIN_SEED),
             pool=wb.SamplePool(min_tp=200, min_fp=200, seed=0),
             learner=wb.Learner(alpha=0.2, max_depth=2), length=LENGTH)
    print(f"trained {len(model)} stages ({time.time() - t0:.1f} s)",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.pb")
        model.save(path)
        with open(path, "rb") as f:
            model_bytes = np.frombuffer(f.read(), np.uint8)

    frames = golden_frames(scene_generator)
    t0 = time.time()
    fn, _ = make_batched_detector_boxes(model, VGA, k=K)
    rects, scores, valid, count, _ = (np.asarray(a) for a in fn(
        jnp.asarray(frames.copy())))
    print(f"served: count {count.tolist()}, kept {valid.sum(axis=1).tolist()}"
          f" ({time.time() - t0:.1f} s)")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, model=model_bytes,
                        frames_sha256=np.array(frames_digest(frames)),
                        rects=rects, scores=scores, valid=valid, count=count)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
