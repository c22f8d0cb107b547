"""Autodiff helpers. Matches `pvio_tpu/utils/autodiff.py::value_and_jacfwd`."""

import torch
from torch.func import jacfwd


def value_and_jacfwd(f, x):
    """f(x) and its Jacobian w.r.t. the 1-D tensor x by forward mode
    (one pushforward per basis vector, batched). Returns (y, J) with
    J.shape == y.shape + x.shape."""
    def f_aux(x_):
        y_ = f(x_)
        return y_, y_

    J, y = jacfwd(f_aux, has_aux=True)(x)
    return y, J
