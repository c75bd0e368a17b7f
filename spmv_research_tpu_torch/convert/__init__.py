from .coo_csr import (coo_to_csr, csr_to_coo, csr_row_permute,
                      csr_expand_symmetric, csr_drop_upper,
                      fix_diagonal_zeros, make_spd, make_diag_dominant)
from .reorder import (reverse_cuthill_mckee, rcm_reorder, rcm_if_beneficial,
                      sigma_sort_rows)
from .features import extract_features, MatrixFeatures
from .build import (BSRBuildError, CSRSymBuildError, DIABuildError,
                    LDUBuildError, build_bsr, build_coo, build_csc, build_csr,
                    build_csr_sym, build_dia, build_ell, build_ldu,
                    build_sellcs)
from .cluster import kmeans_rows, kmeans_reorder, row_feature_vectors
from .cache import cached_build, save_format, load_format, matrix_digest
