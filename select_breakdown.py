"""A clock64 breakdown of K11 (``csrc/select.cu``) in a source tree, on the card.

    python3 select_breakdown.py _archive/parent     # an unpacked git archive of another commit
    python3 select_breakdown.py .                   # this tree

The tree's ``select.cu`` is built alone with the library's flags and
``-DGG_SELECT_PROBES``: thread 0 of each block of the first row records,
after a block barrier, (phase, ``clock64``, ``%globaltimer``) at each
probe point, and each lane of the output phase adds the cycles of its
selected and of its unselected writes (the most of any thread a block). A
source without probe points (the cluster of 8 blocks of the commit before
``GG_PROBE``) gets them inserted at the same phases: the count
(``fill_bits`` and the block's reduction), the cluster's exchange, the
partition (its selected points and its tail apart), the storm's OR, each
radix pass and the partition after it. The barriers the probes add cost a
few hundred cycles each; the cases run 50 times after 5 warm launches.

Cases, built from this tree's ``chip_smoke.py``: a warm scan's budgets and
keys at 131,072 points (k = 8,192, 726 marchable), and the storms of
20,000 marchable points at 2^17 and 2^18 points. Prints one JSON line a
case: each rank's phases in order with their mean cycles and nanoseconds
since the previous probe, and the output loops' cycles; the last line is
the whole record. Phase ids: 0 start, 1 count, 2 exchange, 3 common
partition, 4 the storm's key OR, 5 the storm's selected count, 6 the
storm's partition, 20 + byte the radix pass of that key byte.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs
from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.ops import _build
from groundgrid_torch.ops.select import select_candidates_plain
from groundgrid_torch.runtime.bench import synthetic_records

REPS, WARM = 50, 5

# the probe points of select.cu as it stood before it carried its own
# (a cluster of 8 blocks, __cluster_dims__), as (anchor, replacement)
_PROBES = r'''
__device__ unsigned long long gg_probe_rec[16][64][3];
__device__ unsigned int gg_probe_count[16];
__device__ unsigned long long gg_probe_max[16][4];
__device__ __forceinline__ void gg_probe(int id) {
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.x < 16) {
    const unsigned int n = gg_probe_count[blockIdx.x]++;
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (n < 64) {
      gg_probe_rec[blockIdx.x][n][0] = (unsigned long long)id;
      gg_probe_rec[blockIdx.x][n][1] = (unsigned long long)clock64();
      gg_probe_rec[blockIdx.x][n][2] = t;
    }
  }
  __syncthreads();
}
#define GG_PROBE(id) gg_probe(id)
#define GG_PROBE_START(v) const long long v = clock64()
#define GG_PROBE_ADD(slot, v) \
  if (blockIdx.y == 0 && blockIdx.x < 16) \
  atomicMax(&gg_probe_max[blockIdx.x][slot], (unsigned long long)(clock64() - v))
'''

_READER = r'''
extern "C" int gg_select_probes(unsigned long long* rec, unsigned int* counts,
                                unsigned long long* max) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(rec, gg_probe_rec, sizeof(gg_probe_rec));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(counts, gg_probe_count, sizeof(gg_probe_count));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(max, gg_probe_max, sizeof(gg_probe_max));
  static const unsigned int zero_counts[16] = {};
  static const unsigned long long zero_max[16][4] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(gg_probe_count, zero_counts, sizeof(zero_counts));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(gg_probe_max, zero_max, sizeof(zero_max));
  return (int)err;
}
'''

_OLD_POINTS = [
    ("namespace cg = cooperative_groups;\n", "namespace cg = cooperative_groups;\n" + _PROBES),
    ("  __shared__ Shared sh;\n  const size_t row = blockIdx.y;",
     "  __shared__ Shared sh;\n  GG_PROBE(0);\n  const size_t row = blockIdx.y;"),
    ("  return (unsigned int)cluster_reduce<false>(block_reduce<false>(count, sh), sh, before);",
     "  const unsigned long long total = block_reduce<false>(count, sh);\n  GG_PROBE(1);\n"
     "  const unsigned int all = (unsigned int)cluster_reduce<false>(total, sh, before);\n"
     "  GG_PROBE(2);\n  return all;"),
    ("    partition<16>(budget, c0, len, k, n_m, Positive{}, (unsigned int)before, pidx, sh);\n"
     "    return;",
     "    partition<16>(budget, c0, len, k, n_m, Positive{}, (unsigned int)before, pidx, sh);\n"
     "    GG_PROBE(3);\n    return;"),
    ("    for (unsigned int m = word; m; m &= m - 1) {\n      const int b = __ffs(m) - 1;\n"
     "      const unsigned int pos = before + __popc(word & ((1u << b) - 1u));\n"
     "      if (pos < (unsigned int)k) pidx[pos] = i0 + b;\n    }\n",
     "    GG_PROBE_START(t_sel);\n"
     "    for (unsigned int m = word; m; m &= m - 1) {\n      const int b = __ffs(m) - 1;\n"
     "      const unsigned int pos = before + __popc(word & ((1u << b) - 1u));\n"
     "      if (pos < (unsigned int)k) pidx[pos] = i0 + b;\n    }\n"
     "    GG_PROBE_ADD(0, t_sel);\n    GG_PROBE_START(t_tail);\n"),
    ("    base += sh.tile_total[parity];", "    GG_PROBE_ADD(1, t_tail);\n"
     "    base += sh.tile_total[parity];"),
    ("  any = cluster_reduce<true>(block_reduce<true>(any, sh), sh);",
     "  any = cluster_reduce<true>(block_reduce<true>(any, sh), sh);\n  GG_PROBE(4);"),
    ("    cluster.sync();  // every block has read the histograms; sh's decision is visible\n",
     "    cluster.sync();  // every block has read the histograms; sh's decision is visible\n"
     "    GG_PROBE(20 + shift / 8);\n"),
    ("  count_selected<8>(keys, c0, len, top, &before, sh);  // k in all\n",
     "  count_selected<8>(keys, c0, len, top, &before, sh);  // k in all\n  GG_PROBE(5);\n"),
    ("  partition<8>(keys, c0, len, k, (unsigned int)k, top, (unsigned int)before, pidx, sh);\n}",
     "  partition<8>(keys, c0, len, k, (unsigned int)k, top, (unsigned int)before, pidx, sh);\n"
     "  GG_PROBE(6);\n}"),
]


def instrumented(root: str, tmp: str) -> tuple[str, bool]:
    """The tree's select.cu with probes, built alone; (library, takes a cluster argument)."""
    text = open(os.path.join(root, "groundgrid_torch", "csrc", "select.cu")).read()
    flags = []
    if "GG_PROBE" in text:
        flags = ["-DGG_SELECT_PROBES"]
    else:
        for anchor, repl in _OLD_POINTS:
            if text.count(anchor) != 1:
                raise RuntimeError(f"select.cu: no single probe anchor {anchor[:60]!r}")
            text = text.replace(anchor, repl)
        text += _READER
    src = os.path.join(tmp, "select_probes.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = src[:-3] + ".so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared", "-o", lib, src]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    with_cluster = re.search(r"gg_select\([^)]*int cluster", text) is not None
    return lib, with_cluster


def cases(device):
    config = GroundGridConfig(sorted_scans=True)
    records = synthetic_records(config, 5)
    driver = cs.warm_driver(config, records, device)
    x = cs.march_inputs(config, driver, records[4])
    p = x["budget"].shape[-1]
    return {"scan": (x["budget"], x["key"]),
            "storm_2^17": cs.overflow_budgets(p, 20000, 1, device),
            "storm_2^18": cs.overflow_budgets(2 * p, 20000, 2, device)}, config


def run(lib_path: str, with_cluster: bool, budget, key, k):
    lib = ctypes.CDLL(lib_path)
    entry = lib.gg_select
    P, I = ctypes.c_void_p, ctypes.c_int
    entry.argtypes = [P, P, I, I, I] + ([I] if with_cluster else []) + [P, P, P]
    reader = lib.gg_select_probes
    reader.argtypes = [P, P, P]
    p = budget.shape[-1]
    pidx = torch.empty(k, dtype=torch.int64, device=budget.device)
    n_m = torch.empty((), dtype=torch.int64, device=budget.device)
    rec = np.zeros((16, 64, 3), np.uint64)
    counts = np.zeros(16, np.uint32)
    most = np.zeros((16, 4), np.uint64)
    seqs = []
    for rep in range(WARM + REPS):
        args = [budget.data_ptr(), key.data_ptr(), p, 1, k] + ([0] if with_cluster else []) + [
            pidx.data_ptr(), n_m.data_ptr(), torch.cuda.current_stream().cuda_stream]
        if entry(*args) != 0:
            raise RuntimeError("select launch failed")
        if reader(rec.ctypes.data, counts.ctypes.data, most.ctypes.data) != 0:
            raise RuntimeError("probe read failed")
        if rep >= WARM:
            ranks = [r for r in range(16) if counts[r] > 0]
            seqs.append(({r: rec[r, :min(int(counts[r]), 64)].copy() for r in ranks},
                         most[ranks].copy(), ranks))
    want = select_candidates_plain(budget, key, k)
    if not (torch.equal(pidx, want[0]) and int(n_m) == int(want[1])):
        raise AssertionError("the instrumented kernel differs from the plain version")
    ranks = seqs[0][2]
    out = {}
    for j, r in enumerate(ranks):
        ids = seqs[0][0][r][:, 0]
        cyc = np.mean([np.diff(s[0][r][:, 1].astype(np.int64)) for s in seqs], axis=0)
        ns = np.mean([np.diff(s[0][r][:, 2].astype(np.int64)) for s in seqs], axis=0)
        loops = np.mean([s[1][j] for s in seqs], axis=0)
        out[f"rank{r}"] = {"phases": [[int(i), float(c), float(t)]
                                      for i, c, t in zip(ids[1:], cyc, ns)],
                           "selected_write_cycles": float(loops[0]),
                           "unselected_write_cycles": float(loops[1])}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__)
        return 2
    cs.phase_environment()
    device = torch.device("cuda", 0)
    inputs, config = cases(device)
    k = config.max_outlier_candidates
    record = {"tree": argv[0]}
    with tempfile.TemporaryDirectory() as tmp:
        lib, with_cluster = instrumented(argv[0], tmp)
        for name, (budget, key) in inputs.items():
            record[name] = run(lib, with_cluster, budget, key, k)
            print(json.dumps({name: record[name]}), flush=True)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
