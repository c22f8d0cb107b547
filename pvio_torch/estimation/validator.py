"""Factor validation: forward-mode Jacobians against central finite
differences, and a dependency check for hand-written Jacobians.

Matches `pvio_tpu/estimation/validator.py`: `ValidationReport`,
`validate_factor` and `check_dependencies`. The residual functions take a
tangent tensor and return a residual tensor; results come back as numpy.
"""

from dataclasses import dataclass

import numpy as np
import torch

from pvio_torch.utils.autodiff import value_and_jacfwd


@dataclass
class ValidationReport:
    max_abs_error: float
    max_rel_error: float
    jac_autodiff: np.ndarray
    jac_fd: np.ndarray
    passed: bool

    def __str__(self):
        status = "PASS" if self.passed else "FAIL"
        return (f"[{status}] max_abs_err={self.max_abs_error:.3e} "
                f"max_rel_err={self.max_rel_error:.3e}")


def _np(x):
    return x.detach().cpu().numpy().astype(np.float64).reshape(-1)


def validate_factor(residual_fn, tangent_dim, eps=1e-7, atol=1e-5, rtol=1e-4,
                    dtype=torch.float64, device="cpu"):
    """Check d residual / d tangent of `residual_fn(delta)` at delta = 0."""
    zeros = torch.zeros(tangent_dim, dtype=dtype, device=device)
    _, J = value_and_jacfwd(residual_fn, zeros)
    J = J.detach().cpu().numpy().reshape(-1, tangent_dim)
    J_fd = np.zeros_like(J)
    for k in range(tangent_dim):
        d = zeros.clone()
        d[k] = eps
        J_fd[:, k] = (_np(residual_fn(d)) - _np(residual_fn(-d))) / (2 * eps)
    abs_err = np.abs(J - J_fd)
    rel_err = abs_err / np.maximum(np.abs(J_fd), 1.0)
    passed = bool(np.all(abs_err < atol + rtol * np.abs(J_fd)))
    return ValidationReport(
        max_abs_error=float(abs_err.max()) if abs_err.size else 0.0,
        max_rel_error=float(rel_err.max()) if rel_err.size else 0.0,
        jac_autodiff=J, jac_fd=J_fd, passed=passed)


def check_dependencies(residual_fn, jac_analytic, tangent_dim, dtype=torch.float64,
                       device="cpu"):
    """Leads for a dropped chain-rule term: probe each tangent slot k with a
    huge finite value (1e30; a NaN would poison every output of a whitening
    matmul) and list the (entry, slot) pairs whose residual entry changes
    while the analytic Jacobian claims an exact 0 there. Empty = pass."""
    J = np.asarray(jac_analytic.detach().cpu() if torch.is_tensor(jac_analytic)
                   else jac_analytic, float).reshape(-1, tangent_dim)
    r0 = _np(residual_fn(torch.zeros(tangent_dim, dtype=dtype, device=device)))
    suspects = []
    for k in range(tangent_dim):
        d = torch.zeros(tangent_dim, dtype=dtype, device=device)
        d[k] = 1e30
        r = _np(residual_fn(d))
        depends = ~np.isfinite(r) | (np.abs(r - r0) > 1e-12 * (1.0 + np.abs(r0)))
        for i in np.nonzero(depends & (J[:, k] == 0.0))[0]:
            suspects.append((int(i), k))
    return suspects
