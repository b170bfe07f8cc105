"""Work of one gradient of the ``D``-dimensional AR(1) Gaussian for one
chain: ``grad(x) = -P x`` with ``P`` tridiagonal, so ``D`` products on the
diagonal and ``2 (D - 1)`` multiply-adds off it, and the sign:
``grad_flops = D + 4 (D - 1) + D = 6 D - 4``.  There is no matrix product
(``grad_matmul_flops = 0``).
"""


def grad_flops(cfg: dict) -> int:
    return 6 * cfg["dim"] - 4


def grad_matmul_flops(cfg: dict) -> int:
    return 0

