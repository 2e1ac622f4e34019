from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.matrix.io import read_matrix, write_matrix

__all__ = ["CsrMatrix", "read_matrix", "write_matrix"]
