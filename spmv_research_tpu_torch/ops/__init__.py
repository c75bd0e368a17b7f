from .dispatch import spmv, available_impls, default_impl
from . import reference    # registers CSR/torch
from . import clos_gather  # registers CLOSG/torch and CLOSG/cuda
from . import rowsplit     # registers RSPLIT/torch and RSPLIT/cuda
from . import clos_xl      # registers CLOSGX/torch and CLOSGX/cuda
from . import densemv      # registers DENSE/torch
from . import sellw        # registers SELLW/torch and SELLW/cuda
from . import sellr        # registers SELLR/torch and SELLR/cuda
from .clos_gather import (ClosG, ClosGChunked, build_clos_gather,
                          build_clos_gather_auto, execute_closg_numpy,
                          from_jax_program)
from .clos_xl import (ClosGX, build_clos_gather_xl, closgx_from_jax,
                      execute_closgx_numpy)
from .densemv import DenseBuildError, DenseMV, build_dense
from .rowsplit import (RowSplit, execute_rowsplit_numpy, rowsplit_from_jax,
                       split_long_rows)
from .sellw import SellW, SellWBuildError, build_sellw, execute_sellw_numpy
from .sellr import SellR, SellRBuildError, build_sellr, execute_sellr_numpy
