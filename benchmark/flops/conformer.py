"""Floating-point operations of the Conformer (``configs/conformer.json``),
counted from shapes: the multiply-adds of every matrix product and
convolution, two operations each. Normalisations, activations, softmax and
masking are not counted. Only the frames and keys the inputs need are
counted (no padding, no idle stream slots, no recomputed cache frames), so
waste shows as a lower share of the peak.

A layer over tq query frames and tk key frames (the attention cache
included), with width d, feed-forward width f and conv kernel K:

- two feed-forwards: 2 · 4·tq·d·f;
- attention: q, k, v and output projections 8·tq·d², the positions'
  projection 2·tk·d², the content and position scores and the weighted sum
  6·tq·tk·d;
- convolution module: pointwise to 2d 4·tq·d², depthwise 2·tq·d·K,
  pointwise 2·tq·d².
"""


def subsample_flops(t_in: int, n_mels: int, d: int) -> int:
    """Two 3×3 stride-2 VALID convolutions (1 → d → d channels) and the
    linear layer over the flattened d·f plane."""
    t1, f1 = (t_in - 3) // 2 + 1, (n_mels - 3) // 2 + 1
    t2, f2 = (t1 - 3) // 2 + 1, (f1 - 3) // 2 + 1
    if t2 <= 0:
        return 0
    return 2 * t1 * f1 * d * 9 + 2 * t2 * f2 * d * d * 9 \
        + 2 * t2 * f2 * d * d


def layer_flops(d, f, kernel, tq, tk, group=1, stride=1):
    """One macaron block; ``group`` folds g frames into each attention
    position (scores over tq/g × tk/g of width g·d); ``stride`` strides the
    convolution module, and the second feed-forward runs on its output."""
    tc = -(-tq // stride)
    return (4 * tq * d * f + 4 * tc * d * f
            + 8 * tq * d * d + 2 * tk * d * d + 6 * tq * tk * d // group
            + 4 * tq * d * d + 2 * tc * d * kernel + 2 * tc * d * d)


def head_flops(t, d, vocab):
    return 2 * t * d * vocab


def chunk_flops(conf: dict, t_in: int, n_out: int, cached: int) -> int:
    """One stream's chunk step: ``t_in`` feature frames of which ``n_out``
    encoder frames are valid, attending to ``cached`` valid cache frames
    and the chunk's valid frames."""
    enc = conf['encoder_conf']
    d, f = enc['output_size'], enc['linear_units']
    return (subsample_flops(t_in, conf['input_dim'], d)
            + enc['num_blocks'] * layer_flops(d, f, enc['cnn_module_kernel'],
                                              n_out, cached + n_out)
            + head_flops(n_out, d, conf['vocab_size']))


def decoder_flops(d, f, heads_layers, u, t, vocab):
    """One transformer decoder of ``heads_layers`` layers over u tokens
    and t encoder frames: causal self-attention (projections 8·u·d²,
    scores and sum 4·u²·d), attention to the encoder (query and output
    4·u·d², keys and values of the frames 4·t·d², scores and sum
    4·u·t·d), a ReLU feed-forward 4·u·d·f, and the output layer 2·u·d·V."""
    per_layer = (8 * u * d * d + 4 * u * u * d + 4 * u * d * d
                 + 4 * t * d * d + 4 * u * t * d + 4 * u * d * f)
    return heads_layers * per_layer + 2 * u * d * vocab


def utterance_train_flops(conf: dict, n_feat_frames: int, n_tokens: int):
    """Three times the forward of one utterance in training (the backward
    counted as twice the forward): the encoder at full context over its
    valid frames, the CTC head, and both decoders over its tokens and
    <sos>/<eos>."""
    enc, dec = conf['encoder_conf'], conf['decoder_conf']
    d, f = enc['output_size'], enc['linear_units']
    t = ((n_feat_frames - 1) // 2 - 1) // 2
    if t <= 0:
        return 0
    fwd = (subsample_flops(n_feat_frames, conf['input_dim'], d)
           + enc['num_blocks'] * layer_flops(d, f, enc['cnn_module_kernel'],
                                             t, t)
           + head_flops(t, d, conf['vocab_size']))
    for n in (dec['num_blocks'], dec['r_num_blocks']):
        fwd += decoder_flops(d, dec['linear_units'], n, n_tokens + 1, t,
                             conf['vocab_size'])
    return 3 * fwd
