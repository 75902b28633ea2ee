"""The masked cdist walk kernels at other tilings, side by side on the card.

    python3 scripts/torch_cdist_tilings.py [--out tilings.jsonl]

csrc/masked_cdist.cu's walk (walk_d2) gives each thread 2 columns and
stages 16 features a chunk: a stage of 512 columns x 16 features, the
size that the wide kernel's rows leave in shared memory. This builds
copies of the source at the other splits of that stage (columns a thread
x features a chunk: 1 x 32, 4 x 8, 8 x 4), calls each through its C
entry, holds each output bit for bit against the plain version on
exact-grid inputs, and prints the CUDA-graph replay times of every
variant beside torch.cdist + topk, one JSON line per shape.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from pose6d_tpu_torch.ops import kernels as K  # noqa: E402
from pose6d_tpu_torch.ops.kernels import _build  # noqa: E402

SHAPE = "  static constexpr int kRows = R, kCols = 2, kFC = 16;\n"
SWIZZLE = "    return jj * kFC + 4 * (i ^ ((jj >> 1) & 3));\n"
# the general swizzle: columns 8 / kVec apart alternate their float4 order
GENERAL = ("    return jj * kFC + 4 * (i ^ ((jj / (8 / kVec)) & "
           "(kVec - 1)));\n")
TILINGS = ((2, 16), (1, 32), (4, 8), (8, 4))
# (label, C, k, columns)
CASES = (("top-24 C=30", 30, 24, 5120), ("top-24 C=128", 128, 24, 5120),
         ("argmin C=96", 96, 1, 5120), ("top-5 C=128", 128, 5, 5120),
         ("top-16 C=96", 96, 16, 5120), ("top-24 C=30 M=8192", 30, 24, 8192))


def variant(cols: int, fc: int) -> str:
    src = (_build.CSRC / "masked_cdist.cu").read_text()
    if SHAPE not in src or SWIZZLE not in src:
        raise RuntimeError("walk tiling not found in masked_cdist.cu")
    return src.replace(SHAPE, SHAPE.replace("kCols = 2, kFC = 16",
                                            f"kCols = {cols}, kFC = {fc}")
                       ).replace(SWIZZLE, GENERAL)


def build(tmp: Path, cols: int, fc: int) -> ctypes.CDLL:
    src = tmp / f"masked_cdist_{cols}x{fc}.cu"
    src.write_text(variant(cols, fc))
    so = src.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=900)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _build.SOURCES["masked_cdist.cu"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def launcher(lib, a, b, bv, k: int, optin: int):
    """A closure that launches `lib`'s kernel for (a, b, bv, k), the wide
    kernel on the rows route where its shared memory fits."""
    bsz, n, c = a.shape
    m = b.shape[1]
    dev = a.device
    splits = lib.masked_topk_cdist_splits(bsz, n, m, c, k,
                                          _build.sm_count(dev))
    wide = k > 16 or (c > 64 and k > 8)
    route = 0 if lib.masked_topk_cdist_wide_smem(m, 1) <= optin else 1
    d2 = torch.empty((bsz, n, k), device=dev)
    idx = torch.empty((bsz, n, k), dtype=torch.int32, device=dev)
    part_d2 = torch.empty((bsz, splits, n, k), device=dev)
    part_idx = torch.empty_like(part_d2, dtype=torch.int32)

    def run():
        code = lib.masked_topk_cdist_f32(
            a.data_ptr(), b.data_ptr(), bv.data_ptr(), d2.data_ptr(),
            idx.data_ptr(), part_d2.data_ptr(), part_idx.data_ptr(), bsz, n,
            m, c, k, splits, route if wide else 0, a.stride(0), a.stride(1),
            b.stride(0), b.stride(1), bv.stride(0), _build.stream_ptr(dev))
        _build.check(code, "masked_topk_cdist")
        return d2, idx
    return run, route


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also append the JSON lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_cdist_tilings: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gpu = cs.gpu_name_and_limit()
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(TILINGS)) as ex:
            libs = dict(zip(TILINGS, ex.map(lambda t: build(Path(tmp), *t),
                                            TILINGS)))
        g = torch.Generator(device=dev).manual_seed(0)
        for label, c, k, m in CASES:
            for bsz in (1, cs.BATCH):
                a = cs.grid_points((bsz, 2048, c), c, dev, g)
                b = cs.grid_points((bsz, m, c), c, dev, g)
                b[:, 1:64:2] = b[:, 0:64:2]
                bv = torch.arange(m, device=dev).expand(bsz, m) < m - 120
                want = K.masked_topk_cdist_plain(a, b, bv, k)
                line = dict(gpu=gpu, case=label, batch=bsz, tilings={})
                for (cols, fc), lib in libs.items():
                    run, route = launcher(lib, a, b, bv, k, optin)
                    got = run()
                    if not all(torch.equal(x, y) for x, y in zip(got, want)):
                        raise AssertionError(f"{label} {cols}x{fc}: not the "
                                             "plain version's output")
                    line["tilings"][f"{cols}x{fc}"] = dict(
                        ms=cs.graph_ms(run, 5), route=route)
                line["library_ms"] = cs.graph_ms(lambda: torch.topk(
                    (torch.cdist(a, b) ** 2).masked_fill_(~bv[:, None],
                                                          float("inf")),
                    k, largest=False), 3)
                print(json.dumps(line), flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
