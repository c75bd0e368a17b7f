"""The distributed layer on ``torch.distributed`` (counterpart of
``spmv_research_tpu/parallel/``): one process a device, the collectives
in ``comm.py``; each builder's host half (``plan_*``) needs no process
group."""

from .dist import (
    make_sparse_mesh, partition_rows_nnz_balanced, build_sharded_csr,
    ShardedCSR, distributed_spmv, distributed_cg_step, plan_sharded_csr,
    plan_col_sharded_csr,
)
from .multihost import init_multihost, weak_scaling_efficiency
from .dist import (build_col_sharded_csr, distributed_spmv_psum_scatter,
                   ColShardedCSR)
from .dist_closg import (build_sharded_closg, distributed_spmv_closg,
                         ShardedClosG)
from .dist_sellr import (build_dist_sellr, dist_spmv_sellr,
                         dist_spmv_sellr_host, DistSellR, plan_dist_sellr)
from .dist_closgx import (build_dist_closgx, dist_spmv_closgx,
                          dist_spmv_closgx_host, DistClosGX, plan_dist_closgx)
