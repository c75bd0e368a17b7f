from .dispatch import spmv, available_impls
from . import reference    # registers CSR/torch
from . import clos_gather  # registers CLOSG/torch and CLOSG/cuda
from . import sellw        # registers SELLW/torch and SELLW/cuda
from . import sellr        # registers SELLR/torch and SELLR/cuda
from .clos_gather import (ClosG, ClosGChunked, build_clos_gather,
                          build_clos_gather_auto, execute_closg_numpy,
                          from_jax_program)
from .sellw import SellW, SellWBuildError, build_sellw, execute_sellw_numpy
from .sellr import SellR, SellRBuildError, build_sellr, execute_sellr_numpy
