"""Floating-point operations of the streaming Squeezeformer
(``configs/squeezeformer.json``), counted as ``flops/conformer.py`` counts
them: two operations per multiply-add of every matrix product and
convolution, over the frames and keys the inputs need.

- the input layer: the 3×3 stride-2 convolutions (1 → d → d channels, the
  second depthwise only under ``dw_stride``) and the input projection,
  ``subsample_flops`` (a depthwise second convolution counts d·9 a
  position, not d²·9);
- a block over tq query frames and tk keys: ``layer_flops`` with the
  feed-forward width d · ``feed_forward_expansion_factor`` and the conv
  kernel (the adaptive scales and the LayerNorms are not counted);
- the blocks at half rate (``reduce_idx`` ≤ i < ``recover_idx``): ⌈tq/2⌉
  queries over ⌊cached/2⌋ + ⌈tq/2⌉ keys;
- the time reduction: a depthwise convolution of kernel k and stride 2 and
  a pointwise one over the ⌈tq/2⌉ frames it gives, 2·t·d·k + 2·t·d²; the
  recovery's linear layer over the tq frames kept, 2·tq·d²;
- the CTC head."""
from flops.conformer import head_flops, layer_flops


def subsample_flops(t_in: int, n_mels: int, d: int, depthwise: bool) -> int:
    t1, f1 = (t_in - 3) // 2 + 1, (n_mels - 3) // 2 + 1
    t2, f2 = (t1 - 3) // 2 + 1, (f1 - 3) // 2 + 1
    if t2 <= 0:
        return 0
    second = d * 9 if depthwise else d * d * 9
    return 2 * t1 * f1 * d * 9 + 2 * t2 * f2 * second + 2 * t2 * f2 * d * d


def _schedule(enc: dict):
    as_list = lambda v: [] if v is None else (  # noqa: E731
        [v] if isinstance(v, int) else list(v))
    reduce_idx = as_list(enc.get('reduce_idx', 5))
    return reduce_idx, as_list(enc.get('recover_idx', 11)) \
        if reduce_idx else []


def encoder_flops(conf: dict, n_out: int, cached: int) -> int:
    """The blocks, the time reduction and the recovery over ``n_out``
    base-rate frames that attend to ``cached`` earlier frames and to each
    other."""
    enc = conf['encoder_conf']
    d = enc['encoder_dim']
    f = d * enc['feed_forward_expansion_factor']
    kernel = enc['cnn_module_kernel']
    k_red = 1 if conf.get('streaming', True) \
        or enc.get('time_reduction_layer_type') == 'stream' else 5
    reduce_idx, recover_idx = _schedule(enc)
    total, tq, past = 0, n_out, cached
    stack = []
    for i in range(enc['num_blocks']):
        if i in reduce_idx:
            stack.append((tq, past))
            tq, past = -(-tq // 2), past // 2
            total += 2 * tq * d * k_red + 2 * tq * d * d
        if i in recover_idx and stack:
            tq, past = stack.pop()
            total += 2 * tq * d * d
        total += layer_flops(d, f, kernel, tq, past + tq)
    return total


def chunk_flops(conf: dict, t_in: int, n_out: int, cached: int) -> int:
    """One stream's chunk step: ``t_in`` feature frames of which ``n_out``
    encoder frames are valid, attending to ``cached`` valid base-rate cache
    frames and the chunk's valid frames."""
    enc = conf['encoder_conf']
    d = enc['encoder_dim']
    return (subsample_flops(t_in, conf['input_dim'], d,
                            bool(enc.get('dw_stride', False)))
            + encoder_flops(conf, n_out, cached)
            + head_flops(n_out, enc.get('output_size', d),
                         conf['vocab_size']))
