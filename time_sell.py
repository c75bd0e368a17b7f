#!/usr/bin/env python3
"""Device times of the PyTorch port's column-locality SpMV kernels, SELLW's
B11 and SELLR's B14, on one tree of the port and one NVIDIA GPU.

    python3 time_sell.py [--tree DIR]

Imports ``spmv_research_tpu_torch`` from DIR (default: this checkout), so
that two trees, such as a parent commit unpacked into a git-ignored
directory and this checkout, can be timed in turns on one card: parent,
change, change, parent. Each call is timed alone by ``chip_smoke.py``'s
``DeviceTimer`` (CUDA events after a 1 GiB L2 flush and a spin kernel that
hides the host's enqueue), the mean of 30 calls: ``ms`` after a flush that
writes the 1 GiB, as ``chip_smoke.py`` times every kernel (the L2 left
dirty), ``ms_clean`` after one that reads it (the L2 left clean):

* ``sellw``: ``sellw_planes`` on the shipsec1 twin's SELLW program
  (``chip_smoke.py``'s line, RCM), B11 once per stage class;
* ``sellw_spmm_k1``: ``sellw_spmm_planes`` (B12) on the same program with
  one column of X;
* ``sellw_stream``: ``sellw_planes`` on the seeded tridiagonal program of
  n = 1.2M (``stream_wins``);
* ``sellr_place``, ``sellr_flush`` and ``sellr_y`` (both, back to back) on
  the shipsec1 twin's SELLR program, the flush fed the plain version's R;
* ``cusparse_shipsec1``, ``cusparse_tridiagonal``: cuSPARSE's fp32 CSR SpMV
  of the same matrices (the library yardstick; the same call in every
  tree);
* ``host_us``: the host's microseconds per shipsec1 SELLR and SELLW SpMV
  through ``ops.spmv``, 64 enqueued back to back (``chip_smoke.host_us``):
  what a sweep row reads when the host, not the card, bounds it.

Inputs are made from seeds. Prints the card's name and power limit, then
one JSON line: each call's two times and its kernel launches a call.
"""

import argparse
import json
import os
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(
        __file__)), help="checkout whose spmv_research_tpu_torch is timed")
    args = ap.parse_args()
    from chip_smoke import (SHIPSEC1_LINE, STREAM_N,  # this checkout's
                            DeviceTimer, cusparse, host_us)
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import scipy.sparse as sp
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_sell: needs a CUDA device")
    from spmv_research_tpu_torch.convert.reorder import rcm_if_beneficial
    from spmv_research_tpu_torch.core.host import HostCSR
    from spmv_research_tpu_torch.gen import generate_from_line
    from spmv_research_tpu_torch.ops import spmv
    from spmv_research_tpu_torch.ops import sell_cuda as KS
    from spmv_research_tpu_torch.ops.sellr import build_sellr
    from spmv_research_tpu_torch.ops.sellw import build_sellw, class_plan
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    KS.build()
    ship = rcm_if_beneficial(generate_from_line(SHIPSEC1_LINE)[0])[0]
    Aw, Ar = build_sellw(ship).to(dev), build_sellr(ship).to(dev)
    rng = np.random.Generator(np.random.PCG64(11))
    tri = HostCSR.from_scipy(sp.diags(
        [rng.uniform(-1, 1, STREAM_N - 1), rng.uniform(-1, 1, STREAM_N),
         rng.uniform(-1, 1, STREAM_N - 1)], [-1, 0, 1],
        shape=(STREAM_N, STREAM_N), format="csr"))
    As = build_sellw(tri).to(dev)
    xs = torch.as_tensor(np.random.Generator(np.random.PCG64(7)).uniform(
        0.0, 1.0, ship.n), dtype=torch.float32, device=dev)
    xt = torch.as_tensor(rng.uniform(-1.0, 1.0, STREAM_N),
                         dtype=torch.float32, device=dev)
    w_args = (Aw.word, Aw.vals, Aw.wrow, xs, class_plan(Aw), Aw.G)
    s_args = (As.word, As.vals, As.wrow, xt, class_plan(As), As.G)
    p_args = (Ar.word, Ar.vals, Ar.smeta, xs, Ar.nchunks, Ar.stages,
              Ar.rolls)
    R = KS.sellr_place_torch(*p_args)
    lib_ship, lib_tri = cusparse(ship, dev), cusparse(tri, dev)
    calls = {
        "sellw": lambda: KS.sellw_planes(*w_args),
        "sellw_spmm_k1": lambda: KS.sellw_spmm_planes(
            *w_args[:3], xs.view(1, -1), *w_args[4:]),
        "sellw_stream": lambda: KS.sellw_planes(*s_args, stream_wins=True),
        "sellr_place": lambda: KS.sellr_place(*p_args),
        "sellr_flush": lambda: KS.sellr_flush(R, Ar.gptr, Ar.gchunk),
        "sellr_y": lambda: KS.sellr_y(Ar.word, Ar.vals, Ar.smeta, Ar.gptr,
                                      Ar.gchunk, xs, Ar.nchunks, Ar.stages,
                                      Ar.rolls),
        "cusparse_shipsec1": lambda: lib_ship @ xs.unsqueeze(1),
        "cusparse_tridiagonal": lambda: lib_tri @ xt.unsqueeze(1),
    }
    timer, clean = DeviceTimer(spec=None), DeviceTimer(spec=None, clean=True)
    out = {}
    for name, fn in calls.items():
        KS.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        launches = {k: v for k, v in KS.LAUNCHES.items() if v}  # one call's
        out[name] = {"ms": timer.ms(fn), "ms_clean": clean.ms(fn),
                     "launches": launches}
    host = {key: host_us(lambda: spmv(F, xs), n=64)
            for key, F in (("SELLR", Ar), ("SELLW", Aw))}
    print(json.dumps({"tree": args.tree, "kernels": out, "host_us": host}),
          flush=True)


if __name__ == "__main__":
    main()
