from .coo_csr import (coo_to_csr, csr_to_coo, csr_row_permute,
                      fix_diagonal_zeros, make_spd, make_diag_dominant)
from .reorder import reverse_cuthill_mckee, rcm_reorder, rcm_if_beneficial
from .features import extract_features, MatrixFeatures
from .build import build_csr
