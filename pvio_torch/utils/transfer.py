"""Batched host <-> device transfers of the host loop.

The port's counterpart of the reference's `jax.device_put` of a whole
pytree and of `copy_to_host_async` + `jax.device_get`
(`pvio_tpu/core/host_window.py:159-210`, `feature_tracker.py:23-31`,
`swt.py:108-112`, `core.py:192-217`).

`upload` copies every host array into ONE fresh pinned buffer and sends it
to the card with ONE non-blocking copy; the tensors are views of the
device buffer. The host arrays are copied into the staging buffer before
the call returns, so the caller may mutate its mirrors at once: a
non-blocking copy straight from a `torch.from_numpy` alias of a mirror
would read the mirror whenever the copy runs. `Fetch` starts the reverse:
the device tensors of a pytree are packed into one byte buffer on the card
(one `torch.cat`) and copied with ONE non-blocking copy into pinned
memory, and a CUDA event marks its end; `get` waits on the events of
every `Fetch` in a tree and returns numpy copies. On the CPU both are
plain copies.

Dtypes: floating arrays take the engine dtype, booleans and uint8 stay,
every other integer becomes int64 (the port's window indices).
"""

import numpy as np
import torch

_ALIGN = 16


def _host_array(a, np_float):
    a = np.asarray(a)
    if a.dtype.kind == "f":
        dt = np_float
    elif a.dtype == np.bool_ or a.dtype == np.uint8:
        dt = a.dtype
    elif a.dtype.kind in "iu":
        dt = np.int64
    else:
        raise TypeError(f"upload: unsupported dtype {a.dtype}")
    return np.array(a, dtype=dt, order="C", copy=True)


def upload(arrays, device, dtype):
    """Tensors on `device` of a sequence of host arrays (numpy arrays or
    scalars), from one host -> device copy."""
    device = torch.device(device)
    np_float = np.float32 if dtype == torch.float32 else np.float64
    host = [_host_array(a, np_float) for a in arrays]
    if device.type == "cpu":
        return [torch.from_numpy(h) for h in host]
    offsets, total = _layout(host)
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    _pack(buf.numpy(), host, offsets)
    return _views(buf.to(device, non_blocking=True), host, offsets)


def _layout(host):
    """Byte offsets of the arrays in one buffer (16-byte aligned) and its
    size."""
    offsets, total = [], 0
    for h in host:
        offsets.append(total)
        total += -(-max(h.nbytes, 1) // _ALIGN) * _ALIGN
    return offsets, total


def _pack(raw, host, offsets):
    for h, off in zip(host, offsets):
        raw[off:off + h.nbytes] = h.reshape(-1).view(np.uint8)


def _views(buf, host, offsets):
    """Typed, shaped views of a packed byte tensor."""
    return [buf[off:off + h.nbytes].view(torch.from_numpy(np.empty(0, h.dtype)).dtype)
            .view(h.shape) for h, off in zip(host, offsets)]


def _flatten(tree, leaves):
    if isinstance(tree, dict):
        return ("dict", [(k, _flatten(tree[k], leaves)) for k in sorted(tree)])
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return ("named", type(tree), [_flatten(x, leaves) for x in tree])
    if isinstance(tree, (tuple, list)):
        return ("seq", type(tree), [_flatten(x, leaves) for x in tree])
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("leaf", len(leaves) - 1)
    return ("const", tree)


def _unflatten(spec, values):
    kind = spec[0]
    if kind == "dict":
        return {k: _unflatten(s, values) for k, s in spec[1]}
    if kind == "named":
        return spec[1](*(_unflatten(s, values) for s in spec[2]))
    if kind == "seq":
        return spec[1](_unflatten(s, values) for s in spec[2])
    if kind == "leaf":
        return values[spec[1]]
    return spec[1]


class Fetch:
    """A device -> host copy of a pytree of tensors, started at
    construction (one packed non-blocking copy on CUDA) and harvested by
    `result()` (or `get`)."""

    def __init__(self, tree):
        leaves = []
        self._spec = _flatten(tree, leaves)
        self._meta = [(t.dtype, tuple(t.shape)) for t in leaves]
        self._event = None
        if leaves and leaves[0].device.type == "cuda":
            parts = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in leaves]
            packed = torch.cat(parts)
            self._host = torch.empty(packed.numel(), dtype=torch.uint8, pin_memory=True)
            self._host.copy_(packed, non_blocking=True)
            self._sizes = [p.numel() for p in parts]
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._leaves = [t.detach() for t in leaves]
        self._value = None

    def result(self):
        if self._value is None:
            if self._event is not None:
                self._event.synchronize()
                raw, vals, off = self._host.numpy(), [], 0
                for (dt, shape), n in zip(self._meta, self._sizes):
                    np_dt = torch.empty(0, dtype=dt).numpy().dtype
                    vals.append(np.array(raw[off:off + n].view(np_dt).reshape(shape)))
                    off += n
                self._host = None
            else:
                vals = [np.array(t.numpy()) for t in self._leaves]
                self._leaves = None
            self._value = _unflatten(self._spec, vals)
        return self._value


def get(tree):
    """Host values of a pytree whose leaves are `Fetch`es (harvested),
    tensors (copied now) or anything else (returned as is)."""
    if isinstance(tree, Fetch):
        return tree.result()
    if isinstance(tree, dict):
        return {k: get(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(get(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(get(x) for x in tree)
    if isinstance(tree, torch.Tensor):
        return Fetch(tree).result()
    return tree


def block(x):
    """Wait until the device has computed x (`jax.block_until_ready`)."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.current_stream(x.device).synchronize()
    return x
