"""The Gaussian process behind the autotuner's expected improvement: the
port of ``horovod_tpu.autotune.gp_fit_predict`` (``horovod_tpu/autotune.py:57``).

In the JAX package the maths is native, ``horovod_tpu/cc/src/autotuner.h``
``GaussianProcess`` (lines 79-148) reached through ``libhvd_core.so``: a
squared-exponential kernel of length scale 0.3, signal variance 1 and
noise variance 1e-4 on the diagonal, targets normalised by their mean and
sample standard deviation, and a Cholesky solve (GPML Algorithm 2.1).
Here it is plain Python floats (IEEE double, as the header's), with every
sum and solve in the header's loop order, so that the two agree to
rounding and a near-tie between EI candidates breaks the same way. No
``sum()``: since Python 3.12 it sums floats with compensation, in another
order than the header's loop.
"""

from __future__ import annotations

import math
from typing import Sequence

LENGTH_SCALE = 0.3
SIGNAL_VAR = 1.0
NOISE_VAR = 1e-4


def _kernel(a: Sequence[float], b: Sequence[float]) -> float:
    d2 = 0.0
    for i in range(len(a)):
        d2 += (a[i] - b[i]) * (a[i] - b[i])
    return SIGNAL_VAR * math.exp(-0.5 * d2 / (LENGTH_SCALE * LENGTH_SCALE))


def _cholesky(a: list, n: int) -> bool:
    """In place, row-major; False when not positive definite."""
    for i in range(n):
        for j in range(i + 1):
            s = a[i * n + j]
            for k in range(j):
                s -= a[i * n + k] * a[j * n + k]
            if i == j:
                if s <= 0.0:
                    return False
                a[i * n + j] = math.sqrt(s)
            else:
                a[i * n + j] = s / a[j * n + j]
        for j in range(i + 1, n):
            a[i * n + j] = 0.0
    return True


def _forward_solve(L: list, n: int, b: Sequence[float]) -> list:
    y = list(b)
    for i in range(n):
        s = y[i]
        for k in range(i):
            s -= L[i * n + k] * y[k]
        y[i] = s / L[i * n + i]
    return y


def _chol_solve(L: list, n: int, b: Sequence[float]) -> list:
    b = _forward_solve(L, n, b)
    for i in range(n - 1, -1, -1):
        s = b[i]
        for k in range(i + 1, n):
            s -= L[k * n + i] * b[k]
        b[i] = s / L[i * n + i]
    return b


def gp_fit_predict(X: Sequence[Sequence[float]], y: Sequence[float],
                   xstar: Sequence[float]) -> tuple[float, float]:
    """Fit the GP to ``(X, y)`` and predict ``(mu, sigma)`` at ``xstar``.
    Raises RuntimeError where the kernel matrix is not positive definite,
    as the JAX package does."""
    X = [[float(v) for v in row] for row in X]
    y = [float(v) for v in y]
    n = len(X)
    if n == 0 or len(y) != n:
        raise RuntimeError("GP fit failed (matrix not positive definite?)")
    mean = 0.0
    for v in y:
        mean += v
    mean /= n
    var = 0.0
    for v in y:
        var += (v - mean) * (v - mean)
    var = var / (n - 1) if n > 1 else 1.0
    y_std = math.sqrt(var) if var > 1e-12 else 1.0
    yn = [(v - mean) / y_std for v in y]
    L = [0.0] * (n * n)
    for i in range(n):
        for j in range(n):
            L[i * n + j] = _kernel(X[i], X[j])
            if i == j:
                L[i * n + j] += NOISE_VAR
    if not _cholesky(L, n):
        raise RuntimeError("GP fit failed (matrix not positive definite?)")
    alpha = _chol_solve(L, n, yn)
    q = [float(v) for v in xstar]
    ks = [_kernel(q, X[i]) for i in range(n)]
    m = 0.0
    for i in range(n):
        m += ks[i] * alpha[i]
    v = _forward_solve(L, n, ks)
    var_star = SIGNAL_VAR
    for i in range(n):
        var_star -= v[i] * v[i]
    return m * y_std + mean, math.sqrt(max(var_star, 1e-12)) * y_std
