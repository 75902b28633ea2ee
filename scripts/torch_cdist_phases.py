"""Where the masked cdist wide kernel spends a block's cycles, on the card.

    python3 scripts/torch_cdist_phases.py [--out phases.jsonl]

Builds a copy of csrc/masked_cdist.cu with clock64() stamps in the wide
kernel's rows route (after the walk, the row statistics, the candidate
compaction, the radix select, the winners and the rank sort; and the
cycles thread 0 waits for each staged chunk in the walk), calls its C
entry through ctypes and prints the median cycles of the 256 blocks of
frame 0, per phase, on exact-grid inputs (2048 rows x 5120 columns).
Beside it, the committed kernel's two routes (rows in shared memory and
the recomputing walk) timed by CUDA-graph replay, with their outputs
compared. One JSON line per shape.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from pose6d_tpu_torch.ops.kernels import _build  # noqa: E402

# (text after which a stamp goes, stamp slot); slot 7 holds the walk's wait
STAMP = ("  if (threadIdx.x == 0 && blockIdx.z == 0) "
         "g_prof[blockIdx.x * 8 + %d] = clock64();\n")
ANCHORS = (
    ("  const int row0 = blockIdx.x * kWarps, row = row0 + warp;\n", 0),
    ("        [](int) {});\n", 1),
    ("    st.reduce();\n    bool cand = false;\n", 2),
    ("      cand = cp.n <= kCand;\n    }\n", 3),
    ("      select_row(rx, win, st, k, cp.n, cand_value);\n", 4),
    ("                  i < cp.n ? ccol[i] : 0, i < cp.n);\n      }\n", 5),
    ("    out_idx[r0 + slot] = j;\n  }\n", 6),
)
PHASES = ("walk", "statistics", "compaction", "radix", "winners", "rank")
SHAPES = ((30, 24, 1), (30, 24, 16), (30, 64, 1), (96, 16, 1), (128, 24, 1))


def patched_source() -> str:
    src = (_build.CSRC / "masked_cdist.cu").read_text()
    for text, slot in ANCHORS:
        if text not in src:
            raise RuntimeError(f"anchor not found: {text!r}")
        src = src.replace(text, text + STAMP % slot, 1)
    loop = ("  for (int q = 0; q < total; ++q) {\n"
            "    const int t0 = w.j_begin + q / nch * W::kTile, ch = q % nch;\n")
    wait = "    async_copy::wait<1>();\n    __syncthreads();\n"
    end = ("    __syncthreads();  // buffer q & 1 is refilled by the next "
           "iteration\n  }\n")
    for text in (loop, wait, end):
        if text not in src:
            raise RuntimeError(f"anchor not found: {text!r}")
    src = src.replace(loop, "  long long waited = 0;\n" + loop, 1)
    src = src.replace(wait, "    const long long tw = clock64();\n" + wait
                      + "    waited += clock64() - tw;\n", 1)
    src = src.replace(end, end + "  if (threadIdx.x == 0 && blockIdx.z == 0) "
                      "g_prof[blockIdx.x * 8 + 7] = waited;\n", 1)
    src = src.replace("namespace {\n",
                      "__device__ long long g_prof[1 << 16];\nnamespace {\n",
                      1)
    return src + ('\nextern "C" int prof_read(void* dst, int n) {\n'
                  '  return (int)cudaMemcpyFromSymbol(dst, g_prof, n * '
                  'sizeof(long long));\n}\n')


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _build.SOURCES["masked_cdist.cu"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def launcher(lib, a, b, bv, k: int, route: int):
    """A closure that launches the wide kernel of `lib` on (a, b, bv)."""
    bsz, n, c = a.shape
    m = b.shape[1]
    d2 = torch.empty((bsz, n, k), device=a.device)
    idx = torch.empty((bsz, n, k), dtype=torch.int32, device=a.device)
    sc_bits = torch.empty_like(d2)
    sc_idx = torch.empty_like(idx)

    def run():
        code = lib.masked_topk_cdist_f32(
            a.data_ptr(), b.data_ptr(), bv.data_ptr(), d2.data_ptr(),
            idx.data_ptr(), sc_bits.data_ptr(), sc_idx.data_ptr(), bsz, n, m,
            c, k, 1, route, a.stride(0), a.stride(1), b.stride(0),
            b.stride(1), bv.stride(0), _build.stream_ptr(a.device))
        _build.check(code, "masked_topk_cdist")
        return d2, idx
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also append the JSON lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_cdist_phases: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gpu = cs.gpu_name_and_limit()
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "masked_cdist_phases.cu"
        src.write_text(patched_source())
        so = src.with_suffix(".so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        str(_build.CSRC), "-o", str(so), str(src)],
                       check=True, capture_output=True, timeout=600)
        prof = load(so)
        prof.prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib = _build.library("masked_cdist.cu")
        g = torch.Generator(device=dev).manual_seed(0)
        n, m = 2048, 5120
        for c, k, bsz in SHAPES:
            a = cs.grid_points((bsz, n, c), c, dev, g)
            b = cs.grid_points((bsz, m, c), c, dev, g)
            b[:, 1:64:2] = b[:, 0:64:2]
            bv = torch.arange(m, device=dev).expand(bsz, m) < m - 120
            launcher(prof, a, b, bv, k, 0)()
            torch.cuda.synchronize()
            buf = np.zeros(256 * 8, np.int64)
            _build.check(prof.prof_read(buf.ctypes.data, buf.size), "read")
            st = buf.reshape(256, 8).astype(np.float64)
            phases = np.diff(st[:, :7], axis=1)
            rows, walk = launcher(lib, a, b, bv, k, 0), launcher(lib, a, b, bv,
                                                                 k, 1)
            same = all(torch.equal(x, y) for x, y in zip(rows(), walk()))
            line = dict(
                gpu=gpu, c=c, k=k, batch=bsz, rows=n, columns=m,
                cycles_median={p: float(np.median(phases[:, i]))
                               for i, p in enumerate(PHASES)},
                cycles_total_median=float(np.median(st[:, 6] - st[:, 0])),
                walk_wait_cycles_median=float(np.median(st[:, 7])),
                rows_route_ms=cs.graph_ms(rows, 5),
                walk_route_ms=cs.graph_ms(walk, 5), routes_equal=same,
                timing="cycles: clock64 of thread 0, median over frame 0's "
                       "256 blocks; ms: CUDA-graph replay")
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
