"""Dump the card's facts as one JSON object.

Counterpart of the JAX repository's ``tools/machine_info.py``, role of the
reference's machines_info/ (lstopo + lscpu dumps): what hardware did these
numbers come from. On a CUDA card: the name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
them, ``torch.cuda.get_device_properties`` (SMs, memory), the torch and
CUDA versions and ``utils/roofline.py``'s data-sheet bandwidth and fp32
peak; without one, ``"backend": "cpu"``::

    python -m spmv_research_tpu_torch.tools.machine_info
"""

import json
import subprocess
from typing import Optional


def card() -> Optional[str]:
    """``nvidia-smi``'s "name, power.limit" line of the first card, or None
    where there is no nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0] if lines else None


def info() -> dict:
    import torch

    from ..utils.roofline import device_spec

    out = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if not torch.cuda.is_available():
        return {"backend": "cpu", **out}
    props = torch.cuda.get_device_properties(0)
    spec = device_spec("cuda:0")
    return {
        "backend": "cuda",
        "device_count": torch.cuda.device_count(),
        "devices": [torch.cuda.get_device_name(i)
                    for i in range(torch.cuda.device_count())],
        "device_kind": props.name,
        "name_power_limit": card(),
        "sm_count": props.multi_processor_count,
        "memory_GiB": props.total_memory / 2**30,
        "compute_capability": f"{props.major}.{props.minor}",
        **out,
        "hbm_bw_GBps": spec.hbm_bw / 1e9 if spec else None,
        "hbm_GB": spec.hbm_gb if spec else None,
        "peak_f32_tflops": spec.peak_tflops if spec else None,
    }


def main(argv=None):
    print(json.dumps(info(), indent=2))


if __name__ == "__main__":
    main()
