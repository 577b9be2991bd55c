"""``paddle.linalg`` (counterpart of ``paddle_tpu/linalg.py``): the
``Tensor``-level linear-algebra ops of ``ops/linalg.py``."""

from .ops._primitive import OP_TABLE as _OPS

__all__ = [
    "matmul", "bmm", "mm", "dot", "mv", "cross", "trace", "norm", "dist",
    "cholesky", "cholesky_solve", "qr", "svd", "eig", "eigh", "eigvals",
    "eigvalsh", "inverse", "inv", "pinv", "solve", "triangular_solve",
    "lstsq", "matrix_power", "matrix_rank", "det", "slogdet", "cond", "lu",
    "multi_dot", "corrcoef", "cov", "householder_product", "matrix_exp",
    "lu_unpack", "vector_norm", "matrix_norm", "svd_lowrank", "pca_lowrank",
    "svdvals", "ormqr"]

globals().update({n: _OPS[n] for n in __all__})
