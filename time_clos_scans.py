#!/usr/bin/env python3
"""Device times of the PyTorch port's Clos kernels (the phased scan's, the
front ends, the in-vreg layers and the W = 0 extraction), on one tree of
the port and one NVIDIA GPU.

    python3 time_clos_scans.py [--tree DIR] [--set NAME=VALUE ...]

Imports ``spmv_research_tpu_torch`` from DIR (default: this checkout), so
that two trees, such as a parent commit unpacked into a git-ignored
directory and this checkout, can be timed in turns on one card: parent,
change, change, parent. Each call is timed alone by ``chip_smoke.py``'s
``DeviceTimer`` (CUDA events after a 1 GiB L2 flush and a spin kernel that
hides the host's enqueue), the mean of 30 calls, and warm (30 calls back to
back behind the spin kernel, no flush: the inputs in the L2, as on the main
path):

* B1 ``closg_front`` on the scircuit twin's CLOSG program (bench.py's line,
  RCM, N = 2^20) with x from a seed, B7 ``closg_front_win`` on the
  same twin's ``fuse_windows=True`` program, and B4 ``closg_front_lut`` on
  its value-LUT program (``chip_smoke.py`` phase 9's: the values
  quantised to 64 levels from ``PCG64(13)``);
* the r2 step of that program (``clos_r2``: the r2 layer with its
  transposes; on a tree without it, ``_t_fwd``, ``clos_invreg`` and
  ``_t_bwd`` timed as one unit) and of the same twin's CLOS perm network,
  and ``clos_invreg`` on the CLOS perm network's r1 layer;
* K3 ``closg_r3_scan_yext`` on the scircuit twin's CLOSG program (bench.py's
  line, RCM, N = 2^20) with its capped stages;
* B8 ``clos_r3_fill``, ``clos_r3_scan`` and ``clos_r3_valid`` (the whole
  plane) on the same twin's CLOS program;
* B5 ``closg_r3_scan`` on a random 2^20-slot plane, 14 stages;
* B15's scan over 12 random chunks of 2^20 slots, 9 stages;
* B6 on the gupta3 twin's 10-chunk W = 0 program (validation_twins.txt:30,
  RCM), each chunk's scanned plane from the plain versions: the y of all
  chunks, as the tree's chunked SpMV extracts it — one launch over every
  chunk (``closg_cand_yext_chunked``), or on a tree without it one launch a
  chunk and the concatenation of their rows;
* one whole gupta3 CLOSG SpMV through ``ops.spmv``: its device time (cold
  only) and ``host_us``, the host's enqueue time of one SpMV (20 calls
  back to back, no synchronize between them), measured 5 times.

With ``--set NAME=VALUE`` the tree's ``csrc/closg.cu`` is built with its
constant ``constexpr ... NAME`` set to VALUE, to compare designs of one
kernel on one card, such as ``kR2Run`` (floats of each natural block an
r2 tile reads: the tile width at V = 1024).
Inputs are made from seeds. Prints the card's name and power limit, then
one JSON line: each kernel's cold ms, warm ms and launches a call.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(
        __file__)), help="checkout whose spmv_research_tpu_torch is timed")
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="build closg.cu with constexpr NAME = VALUE")
    args = ap.parse_args()
    from chip_smoke import (GUPTA3_LINE, DeviceTimer,  # this checkout's
                            host_us)
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_clos_scans: needs a CUDA device")
    from spmv_research_tpu_torch import bench
    from spmv_research_tpu_torch.convert.reorder import rcm_if_beneficial
    from spmv_research_tpu_torch.core.host import HostCSR
    from spmv_research_tpu_torch.gen import generate_from_line
    from spmv_research_tpu_torch.ops import (build_clos_gather,
                                             build_clos_gather_auto, spmv)
    from spmv_research_tpu_torch.ops import clos_cuda as K
    from spmv_research_tpu_torch.ops.clos import build_clos
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory()
    if args.set:
        with open(K.SOURCE) as f:
            src = f.read()
        for item in args.set:
            name, value = item.split("=", 1)
            src, n = re.subn(rf"(constexpr \w+ {name} = )[^;]+;",
                             rf"\g<1>{value};", src)
            if n != 1:
                sys.exit(f"time_clos_scans: no constexpr {name} in "
                         f"{K.SOURCE}")
        K._CUDA.source = os.path.join(tmp.name, "closg.cu")
        with open(K._CUDA.source, "w") as f:
            f.write(src)
    K.build()
    host = rcm_if_beneficial(generate_from_line(bench.SCIRCUIT_LINE)[0])[0]
    G, C = build_clos_gather(host).to(dev), build_clos(host).to(dev)
    F = build_clos_gather(host, fuse_windows=True).to(dev)
    lrng = np.random.Generator(np.random.PCG64(13))
    levels = lrng.uniform(-1.0, 1.0, 64)
    Lu = build_clos_gather(HostCSR.from_arrays(
        host.ia, host.ja, levels[lrng.integers(0, 64, host.nnz)], host.m,
        host.n), value_lut=True).to(dev)
    gup = rcm_if_beneficial(generate_from_line(GUPTA3_LINE)[0])[0]
    Ag = build_clos_gather_auto(gup).to(dev)
    rng = np.random.Generator(np.random.PCG64(7))
    xd = torch.as_tensor(rng.uniform(0.0, 1.0, host.n), dtype=torch.float32,
                         device=dev)

    def plane(n, ints=False):
        a = (rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32) if ints
             else rng.uniform(-1, 1, n).astype(np.float32))
        return torch.as_tensor(a, device=dev).view(-1, 128)

    v = plane(G.N)
    xg = torch.as_tensor(rng.uniform(0.0, 1.0, gup.n), dtype=torch.float32,
                         device=dev)
    parts = []
    for c in Ag.chunks:
        u = K.clos_r2_torch(K.closg_front_torch(c.rowidx, c.perm_r1,
                                                c.vals_cs, xg),
                            c.perm_r2, c.V)
        parts.append((K.closg_r3_scan_torch(u, c.perm_r3, c.scan_hi,
                                            c.scan_stages), c.ycand, c.ysel))

    def b6():
        """The y of every gupta3 chunk, as the tree's SpMV extracts it."""
        if hasattr(K, "closg_cand_yext_chunked"):
            return K.closg_cand_yext_chunked(parts, Ag.row_split)
        return torch.cat([K.closg_cand_yext(*p).reshape(-1)[:c.m]
                          for p, c in zip(parts, Ag.chunks)])

    w3, hi = plane(1 << 20, ints=True), plane(1 << 20, ints=True)
    vx, w3x = plane(12 << 20), plane(12 << 20, ints=True)
    def r2(v, w, V):
        """The r2 layer with its transposes, as the tree computes it."""
        if hasattr(K, "clos_r2"):
            return K.clos_r2(v, w, V)
        from spmv_research_tpu_torch.ops.clos import _t_bwd, _t_fwd
        return _t_bwd(K.clos_invreg(_t_fwd(v, V), w), V)

    calls = {
        "closg_front": lambda: K.closg_front(G.rowidx, G.perm_r1, G.vals_cs,
                                             xd),
        "closg_front_win": lambda: K.closg_front_win(
            F.gbase, F.nbids, F.perm_r1, F.vals_cs, xd, F.dense_blocks),
        "closg_front_lut": lambda: K.closg_front_lut(
            Lu.rowidx, Lu.perm_r1, Lu.vals_cs, xd),
        "r2_closg": lambda: r2(v, G.perm_r2, G.V),
        "r2_clos": lambda: r2(v, C.perm_r2, C.V),
        "clos_invreg": lambda: K.clos_invreg(v, C.perm_r1),
        "closg_r3_scan_yext": lambda: K.closg_r3_scan_yext(
            v, G.perm_r3, G.scan_hi, G.ysel_w, G.wstart, G.acc_ptr,
            G.acc_src, G.scan_cap or G.scan_stages),
        "clos_r3_fill": lambda: K.clos_r3_fill(v, C.widen_r3, C.fill_hi,
                                               C.fill_stages),
        "clos_r3_scan": lambda: K.clos_r3_scan(v, C.perm_r3, C.vals,
                                               C.scan_hi, C.scan_stages),
        "clos_r3_valid": lambda: K.clos_r3_valid(v, C.compact_r3),
        "closg_r3_scan": lambda: K.closg_r3_scan(v, w3, hi, range(14)),
        "closgx_r3_scan_yext": lambda: K._scan_phases(
            "closgx_r3_scan_yext", vx, w3x, None, range(9), 1 << 20),
        "b6_gupta3": b6,
    }
    timer = DeviceTimer(spec=None)
    out = {}
    for name, fn in calls.items():
        K.reset_launch_counts()
        fn()
        launches = sum(K.LAUNCHES.values())  # one call's
        out[name] = {"ms": timer.ms(fn), "warm_ms": timer.warm_ms(fn),
                     "launches": launches}
    out["spmv_gupta3"] = {
        "ms": timer.ms(lambda: spmv(Ag, xg), iters=10),
        "host_us": [host_us(lambda: spmv(Ag, xg), n=20) for _ in range(5)]}
    print(json.dumps({"tree": args.tree, "set": args.set,
                      "kernels": out}), flush=True)
    tmp.cleanup()


if __name__ == "__main__":
    main()
