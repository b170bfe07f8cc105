"""Work of one gradient of Bayesian logistic regression, ``N`` points x
``D`` regressors, for one chain (one lane), as the algorithm needs it.

``grad(w) = X^T (y * sigmoid(-y * (X w))) - w``:

* the two matrix products, ``X w`` and ``X^T g``: ``2 N D`` FLOPs each,
  so ``4 N D``;
* per data point: ``y * z``, ``sigmoid(-.)`` (exp, add, reciprocal) and
  ``y * s``: ``5 N``;
* per regressor: the prior's ``- w``: ``D``.

So ``grad_flops = 4 N D + 5 N + D`` and ``grad_matmul_flops = 4 N D``.

Bytes of the two products over one execution of the gradient across a
batch with ``a`` active lanes, each input read once and each output
written once (float32): ``X`` twice (``8 N D``), and per active lane its
``w`` and ``X w`` row out, then its ``g`` row in and ``X^T g`` out
(``8 N + 8 D``).  So ``matmul_bytes(execs, lanes) = execs * 8 N D + lanes *
(8 N + 8 D)`` for ``execs`` executions holding ``lanes`` active lanes in
all.
"""


def grad_flops(cfg: dict) -> int:
    n, d = cfg["num_data"], cfg["dim"]
    return 4 * n * d + 5 * n + d


def grad_matmul_flops(cfg: dict) -> int:
    return 4 * cfg["num_data"] * cfg["dim"]


def matmul_bytes(cfg: dict, execs: int, lanes: int) -> int:
    n, d = cfg["num_data"], cfg["dim"]
    return execs * 8 * n * d + lanes * (8 * n + 8 * d)
