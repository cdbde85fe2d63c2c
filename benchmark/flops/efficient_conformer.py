"""Floating-point operations of the EfficientConformer
(``configs/efficient_conformer.json``), counted as ``flops/conformer.py``
counts them, over one utterance's valid frames at full context: layers in
``group_layer_idx`` fold ``group_size`` frames into each attention
position, a layer in ``stride_layer_idx`` strides its convolution module
(its second feed-forward and every later layer run on the strided frames),
and ``stride_kernel`` divides the conv kernel by the stride after it."""
from flops.conformer import head_flops, layer_flops, subsample_flops


def utterance_flops(conf: dict, n_feat_frames: int) -> int:
    """The encoder and CTC head over an utterance of ``n_feat_frames``
    log-mel frames."""
    enc = conf['encoder_conf']
    eff = enc['efficient_conf']
    d, f = enc['output_size'], enc['linear_units']
    strides = dict(zip(eff['stride_layer_idx'], eff['stride']))
    groups = set(eff['group_layer_idx'])
    t = ((n_feat_frames - 1) // 2 - 1) // 2
    if t <= 0:
        return 0
    total = subsample_flops(n_feat_frames, conf['input_dim'], d)
    kernel = enc['cnn_module_kernel']
    for i in range(enc['num_blocks']):
        s = strides.get(i, 1)
        total += layer_flops(d, f, kernel, t, t,
                             eff['group_size'] if i in groups else 1, s)
        if s > 1:
            t = -(-t // s)
            if eff.get('stride_kernel', True):
                kernel //= s
    return total + head_flops(t, d, conf['vocab_size'])
