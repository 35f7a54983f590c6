"""Phase times inside kernel S2 (csrc/compact.cu) on the card.

Builds a copy of ``csrc/compact.cu`` with ``%globaltimer`` stamps at its
phase boundaries (block 0 after each grid barrier; the latest block at
its start, at the end of its pass-0 work and at its end), swaps it in for
``ops/nms.py::topk_masked``'s library, and prints, for S2 on the inputs
the flagship's two-phase detector gives it at VGA (8 scenes) and config
5's at 4K (8 noise frames), in the masked and the hs/alive form, k 128,
1024 and 8192: the device ms per call (torch.profiler) and the
microseconds of pass 0 (counts, digits, resolution, two barriers), the
refinement passes, the write, the sort, the last block's start and the
end of the last block's pass-0 work, each from the kernel's start.
The kernel the package builds has no stamps.

    python scripts/topk_phase_stamps.py      # on the card, ~1 min
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import waldboost_tpu_torch as wt  # noqa: E402
from waldboost_tpu_torch import _build  # noqa: E402
from waldboost_tpu_torch.ops import nms as nms_mod  # noqa: E402

#: (marker in csrc/compact.cu, stamp slot, whose time, where): "first"
#: block 0's, "last" the latest block's, just after or before the marker
STAMPS = (("  unsigned target = 0;\n", 0, "first", "after"),
          ("  unsigned target = 0;\n", 5, "last", "after"),
          ("  digit_pass(a, 0, s_hist, s_warp);\n", 6, "last", "after"),
          ("  // 2. rows with more than k finite", 1, "first", "before"),
          ("  // 3. the ordered write", 2, "first", "before"),
          ("  // 4. the sort of each row", 3, "first", "before"),
          ("  // rows of several runs", 4, "last", "before"))
LABELS = ("pass 0", "refine", "write", "sort", "last block start",
          "pass-0 work end")


def stamped_source() -> str:
    src = open(os.path.join(_build.CSRC, "compact.cu")).read()
    src = src.replace("namespace {\n", "__device__ unsigned long long "
                      "g_stamp[8];\nnamespace {\n", 1)
    for marker, slot, how, where in STAMPS:
        if marker not in src:
            raise SystemExit(f"marker {marker!r} not in csrc/compact.cu")
        t = ('unsigned long long t_; asm volatile("mov.u64 %0, '
             '%%globaltimer;" : "=l"(t_));')
        put = (f"if (blockIdx.x == 0 && threadIdx.x == 0) {{ {t} "
               f"g_stamp[{slot}] = t_; }}\n" if how == "first" else
               f"if (threadIdx.x == 0) {{ {t} atomicMax(&g_stamp[{slot}], "
               f"t_); }}\n")
        src = src.replace(marker, marker + put if where == "after"
                          else put + marker, 1)
    return src + ('\nextern "C" int wb_stamps(void* out) { return (int)'
                  'cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp)); }\n')


def build(tmp: str) -> ctypes.CDLL:
    src, lib = os.path.join(tmp, "compact_stamps.cu"), \
        os.path.join(tmp, "libcompact_stamps.so")
    with open(src, "w") as f:
        f.write(stamped_source())
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                    "-o", lib, src], check=True, capture_output=True)
    c = ctypes.CDLL(lib)  # _build.entry declares wb_topk's signature
    c.wb_stamps.argtypes = [ctypes.c_void_p]
    c.wb_stamps.restype = ctypes.c_int
    return c


def phases(lib, call):
    """The microseconds of LABELS for one call, from the kernel's start."""
    torch.cuda.synchronize()
    call()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 8)()
    lib.wb_stamps(ctypes.addressof(buf))
    b = list(buf)
    span = [(b[i + 1] - b[i]) / 1e3 if b[i + 1] >= b[i] else None
            for i in range(4)]
    return span + [(b[5] - b[0]) / 1e3, (b[6] - b[0]) / 1e3]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    print(cs.card_line())
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        _build._LIBS["compact"] = lib
        synth = wt.load(os.path.join(ROOT, "models", "flagship_synth_64.pb"),
                        device=dev)
        fpga = wt.load(os.path.join(ROOT, "models", "fpga_4k_synth_64.pb"),
                       device=dev)
        gen = torch.Generator(device=dev).manual_seed(9)
        runs = (("VGA", synth, cs.VGA, {}, cs.scene_batch(cs.BATCH).to(dev)),
                ("4K", fpga, cs.HW4K, {"k": 128},
                 torch.randint(0, 256, (cs.BATCH,) + cs.HW4K, generator=gen,
                               dtype=torch.uint8, device=dev)))
        for label, model, hw, kw, images in runs:
            det, _ = wt.make_batched_detector_boxes(model, hw, device=dev,
                                                    two_phase=True, **kw)
            inp = cs.TpInputs(det, images)
            for form in ("masked", "hs"):
                for k in (128, 1024, 8192):
                    call = (lambda: nms_mod.topk_masked(inp.masked, k)) \
                        if form == "masked" else \
                        (lambda: nms_mod.topk_masked(inp.hs, k, alive=inp.al))
                    ms = cs.device_ms(call)
                    got = phases(lib, call)
                    print(f"{label} {form} k={k}: {ms:.4f} ms on the device; "
                          + ", ".join(f"{n} {v:.3f} us" if v is not None
                                      else f"{n} none"
                                      for n, v in zip(LABELS, got)))


if __name__ == "__main__":
    main()
