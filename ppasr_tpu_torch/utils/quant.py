"""Int8 weight quantization of an exported model (counterpart of
ppasr_tpu/utils/quant.py:1-58), over the numpy flax tree that
``utils/checkpoint`` reads and writes (``export_params``, ``load_msgpack``).

A leaf is quantized when its last path key is ``kernel`` or ``embedding``
and it has two axes or more: symmetric int8 per channel of the LAST axis of
the flax layout (a Dense ``[in, out]``, a conv ``[k, in, out]``), scale
``max(|w|, 1e-8) / 127`` over every other axis, ``np.round`` (half to
even), clipped to ±127, all in float32 as the JAX package does it. Every
other leaf (biases, norms, the BatchNorm statistics of ``batch_stats``) is
kept as it is. Leaves are keyed by their ``'/'``-joined path, in the sorted
order of JAX's tree flattening, so the two packages write the same blob
``{'q', 's', 'raw'}`` and dequantize it bit for bit alike.

Quantize the flax tree, never a torch ``state_dict``: torch keeps Linear
weights ``[out, in]``, whose last axis is another channel axis.
"""
import numpy as np


def _leaves(tree, prefix=()):
    """(path, leaf) in the order of ``jax.tree_util`` (sorted dict keys)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _is_quantizable(path, arr) -> bool:
    return arr.ndim >= 2 and path[-1] in ('kernel', 'embedding')


def quantize_params(params: dict) -> dict:
    """Flax tree of numpy arrays → ``{'q': {path: int8}, 's': {path: float32
    scales [1, .., out]}, 'raw': {path: array}}``."""
    q, s, raw = {}, {}, {}
    for path, leaf in _leaves(params):
        key = '/'.join(path)
        arr = np.asarray(leaf)
        if _is_quantizable(path, arr):
            amax = np.max(np.abs(arr), axis=tuple(range(arr.ndim - 1)),
                          keepdims=True)
            scale = np.maximum(amax, 1e-8) / 127.0
            q[key] = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
            s[key] = scale.astype(np.float32)
        else:
            raw[key] = arr
    return {'q': q, 's': s, 'raw': raw}


def dequantize_params(blob: dict) -> dict:
    """The inverse of ``quantize_params``: ``q · s`` in float32 for the
    quantized leaves, the raw ones cast to float32, in a tree rebuilt from
    the paths."""
    out = {}
    for key in sorted(list(blob['q']) + list(blob['raw'])):
        node = out
        *parents, name = key.split('/')
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = (blob['q'][key].astype(np.float32) * blob['s'][key]
                      if key in blob['q']
                      else np.asarray(blob['raw'][key]).astype(np.float32))
    return out
