from .dispatch import spmv, spmm, sddmm, available_impls, default_impl
from . import reference    # registers CSR/torch, CSR/sparse and the classic
                           # formats' torch impls
from . import clos_gather  # registers CLOSG/torch and CLOSG/cuda
from . import rowsplit     # registers RSPLIT/torch and RSPLIT/cuda
from . import clos_xl      # registers CLOSGX/torch and CLOSGX/cuda
from . import densemv      # registers DENSE/torch
from . import sellw        # registers SELLW/torch and SELLW/cuda
from . import sellr        # registers SELLR/torch and SELLR/cuda
from . import btile        # registers BTILE/torch and BTILE/cuda (no SpMV)
from . import compensated  # registers CSRDS/torch
from . import sellw_ds     # registers SELLWDS/torch and SELLWDS/cuda
from . import clos         # registers CLOS/torch and CLOS/cuda
from . import clos_mcast   # registers CLOSM/torch and CLOSM/cuda
from . import bfly         # registers BFLY/torch and BFLY/cuda
from . import gatherk      # registers SELLG/torch (SpMM) and CSR/gather (SDDMM)
from . import bsr_mxu      # registers BSRG/torch and BSR/mxu (SDDMM)
from . import value_compress  # registers CSR_LUT/torch
from . import csr_chunked  # registers CSR/torchc (SpMV and SpMM)
from .bfly import Bfly, bfly_from_jax, build_bfly, spmv_bfly_cuda_fused
from .bsr_mxu import BsrG, bsr_sddmm_to_csr_values, build_bsrg
from .btile import (BTile, BTileBuildError, btile_from_jax, build_btile,
                    execute_btile_numpy, sddmm_slab_to_csr_values)
from .compensated import (CsrDS, DSRangeError, build_csrds, csrds_from_jax,
                          spmv_csrds_f64, spmv_csrds_pair)
from .clos import Clos, build_clos, clos_from_jax, execute_clos_numpy
from .clos_mcast import (ClosM, build_clos_mcast, closm_from_jax,
                         execute_closm_numpy)
from .clos_gather import (ClosG, ClosGChunked, build_clos_gather,
                          build_clos_gather_auto, execute_closg_numpy,
                          from_jax_program)
from .clos_xl import (ClosGX, build_clos_gather_xl, closgx_from_jax,
                      execute_closgx_numpy)
from .csr_chunked import CSRChunked, build_csr_chunked
from .densemv import DenseBuildError, DenseMV, build_dense
from .gatherk import SellG, build_sellg
from .routing import RoutingError
from .rowsplit import (RowSplit, execute_rowsplit_numpy, rowsplit_from_jax,
                       split_long_rows)
from .sellw import SellW, SellWBuildError, build_sellw, execute_sellw_numpy
from .sellr import SellR, SellRBuildError, build_sellr, execute_sellr_numpy
from .sellw_ds import (SellWDS, build_sellwds, sellwds_from_jax,
                       spmv_sellwds_cuda_pair, spmv_sellwds_f64,
                       spmv_sellwds_torch_pair)
from .value_compress import CSRLUT, build_csr_lut
