from . import native
from .div_codec import DivPackets, compress_csr, decompress
from .matrix_market import mtx_read, mtx_write
from .openfoam import read_openfoam_matrix_dir
