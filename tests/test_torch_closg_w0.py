"""CLOSG's W = 0 back end in the port (kernels B5 and B6) against the JAX
package.

A 128-row group whose row ends span more than 64 window octaves gets no
windowed extraction: the program runs the r3 layer and the full segmented
scan (``_r3_scan_kernel_noval``), then picks each y element from one of C
candidate scan rows (``_extract_y_kernel``). Two matrices: 130 rows of 520
nnz (W = 0, C = 128, no capping), and the same shape with one row of 33,000
nnz, whose scan needs stage 15 and so the ``scan_hi`` guard plane.

Both packages build the program from the same matrix and must give
identical arrays. The Pallas kernels run in interpret mode on the CPU; the
port runs the plain PyTorch versions, which its wrappers take for CPU
tensors. B5 and B6 are shifts, adds in the same order and picks, so they
must match exactly; y is held to 1e-6 of |A|·|x| against the JAX pallas
path (the 130-row case; the scan_hi case against the float64 executor only,
as its interpret run is slow).
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from spmv_research_tpu.core.host import HostCSR as JaxHostCSR
from spmv_research_tpu.ops import spmv as jax_spmv
from spmv_research_tpu.ops.bfly_pallas import _call
from spmv_research_tpu.ops.clos_gather import _extract_y_kernel
from spmv_research_tpu.ops.clos_gather import build_clos_gather as jax_build
from spmv_research_tpu.ops.clos_gather import (
    execute_closg_numpy as jax_execute_numpy)
from spmv_research_tpu.ops.clos_pallas import _r3_scan_kernel_noval

from spmv_research_tpu_torch.core.host import HostCSR
from spmv_research_tpu_torch.ops import build_clos_gather, spmv
from spmv_research_tpu_torch.ops import clos_cuda as K
from spmv_research_tpu_torch.ops.clos import _t_bwd, _t_fwd
from spmv_research_tpu_torch.ops.clos_gather import (
    DATA_FIELDS, META_FIELDS, execute_closg_numpy)
from spmv_research_tpu_torch.ops.clos_route import LANES, SUB

from torch_cases import rel_err, w0_matrix

MATRICES = {"w0": lambda: w0_matrix(130, 520),
            "scan_hi": lambda: w0_matrix(130, 600, heavy=33000)}


@pytest.fixture(scope="module", params=sorted(MATRICES))
def case(request):
    """(name, matrix, JAX ClosG, the port's own ClosG, x)."""
    mat = MATRICES[request.param]()
    Aj = jax_build(JaxHostCSR.from_scipy(mat))
    A = build_clos_gather(HostCSR.from_scipy(mat))
    x = np.random.Generator(np.random.PCG64(7)).uniform(0.0, 1.0,
                                                         mat.shape[1])
    return request.param, mat, Aj, A, x.astype(np.float32)


def _r3_input(A, x):
    """The plane that enters the back end (front end, r2 layer)."""
    v = K.closg_front_torch(A.rowidx, A.perm_r1, A.vals_cs,
                            torch.from_numpy(x))
    return _t_bwd(K.clos_invreg_torch(_t_fwd(v, A.V), A.perm_r2), A.V)


def _jax_scan(Aj, v):
    """spmv_closg_pallas's W = 0 scan call (clos_gather.py:807)."""
    return _call(partial(_r3_scan_kernel_noval, (SUB * Aj.V, Aj.scan_stages)),
                 jnp.asarray(v.numpy()), Aj.perm_r3, Aj.scan_hi)


def test_program_identical(case):
    name, _, Aj, A, _ = case
    assert A.W == 0 and A.yext_classes == () and A.C > 64
    for f in DATA_FIELDS:
        assert np.array_equal(getattr(A, f).numpy(),
                              np.asarray(getattr(Aj, f))), f
    assert ({f: getattr(A, f) for f in META_FIELDS}
            == {f: getattr(Aj, f) for f in META_FIELDS})
    # the scan_hi case scans past stage 14, so its guards need the full plane
    assert (len(A.scan_stages) > 15) == (name == "scan_hi")
    assert (A.scan_hi.numel() == A.N) == (name == "scan_hi")
    # no classes: zero y batches, and border is never read
    assert A.acc_ptr.tolist() == [0] and A.acc_src.numel() == 0


def test_r3_scan_matches_noval_kernel(case):
    _, _, Aj, A, x = case
    v = _r3_input(A, x)
    want = np.asarray(_jax_scan(Aj, v))
    got = K.closg_r3_scan_torch(v, A.perm_r3, A.scan_hi, A.scan_stages)
    assert np.array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(K.closg_r3_scan(v, A.perm_r3, A.scan_hi,
                                       A.scan_stages), got)


def test_cand_yext_matches_extract_kernel(case):
    _, _, Aj, A, x = case
    scr = _jax_scan(Aj, _r3_input(A, x))
    C, m_rows = Aj.C, Aj.ysel.shape[0]
    want = pl.pallas_call(
        partial(_extract_y_kernel, (C, m_rows)),
        out_shape=jax.ShapeDtypeStruct((m_rows, LANES), scr.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(scr.at[Aj.ycand].get(), Aj.ysel)
    scr_t = torch.from_numpy(np.array(scr))
    got = K.closg_cand_yext_torch(scr_t, A.ycand, A.ysel)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(K.closg_cand_yext(scr_t, A.ycand, A.ysel), got)


def test_y_matches_jax_and_float64_executor(case):
    name, mat, Aj, A, x = case
    got = spmv(A, torch.from_numpy(x)).numpy()       # CPU tensor: "torch"
    assert got.shape == (mat.shape[0],)
    x64 = x.astype(np.float64)
    ref = execute_closg_numpy(A, x64)
    assert np.array_equal(ref, jax_execute_numpy(Aj, x64))
    assert rel_err(mat, x, ref) <= 1e-7      # float32 values, float64 sums
    scale = np.abs(mat) @ np.abs(x64) + 1e-30
    assert np.max(np.abs(got - ref) / scale) <= 1e-6
    if name == "w0":                         # interpret run of ~8 s
        want = np.asarray(jax_spmv(Aj, jnp.asarray(x), impl="pallas"))
        assert np.max(np.abs(got - want) / scale) <= 1e-6


def test_from_jax_program_runs_w0(case):
    _, _, Aj, A, x = case
    from spmv_research_tpu_torch.ops import from_jax_program
    B = from_jax_program({f: np.asarray(getattr(Aj, f)) for f in DATA_FIELDS},
                         {f: getattr(Aj, f) for f in META_FIELDS})
    xt = torch.from_numpy(x)
    assert torch.equal(spmv(B, xt), spmv(A, xt))
