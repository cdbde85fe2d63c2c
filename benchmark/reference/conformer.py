"""Plain float32 reference of the streaming Conformer (PPASR
``configs/conformer.yml``): one stream's encoder driven chunk by chunk over
its own left-context caches, and the CTC posteriors of each chunk.

A chunk is a window of (chunk − 1)·4 + 7 feature frames (the last window of
an utterance zero-padded to that length) giving ``chunk`` encoder frames.
Self-attention sees the chunk and at most ``cache`` earlier encoder frames
(the cache right-aligned, older frames dropped first); key slot j of S =
cache + chunk slots carries the sinusoid row of absolute frame
offset − cache + j, zero before the first frame. The causal convolution
module carries the last kernel − 1 inputs of each layer.
"""
import torch

from reference import blocks


def layer_kernels(conf: dict):
    return [conf['encoder_conf']['cnn_module_kernel']] \
        * conf['encoder_conf']['num_blocks']


def param_shapes(conf: dict) -> dict:
    enc = conf['encoder_conf']
    return blocks.encoder_param_shapes(
        enc['output_size'], enc['attention_heads'], enc['linear_units'],
        layer_kernels(conf), conf['input_dim'], conf['vocab_size'],
        block_norm=blocks.final_norm(conf))


class Stream:
    """One stream's encoder state; ``step`` runs one window."""

    def __init__(self, W, cmvn, conf: dict, cache: int, device):
        enc = conf['encoder_conf']
        self.W, self.cmvn, self.cache = W, cmvn, cache
        self.d, self.heads = enc['output_size'], enc['attention_heads']
        self.kernels = layer_kernels(conf)
        self.block_norm = blocks.final_norm(conf)
        self.pe = blocks.sinusoids(self.d, 5000, device)
        dk = self.d // self.heads
        n = len(self.kernels)
        z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
        self.k = [z(1, cache, self.heads, dk) for _ in range(n)]
        self.v = [z(1, cache, self.heads, dk) for _ in range(n)]
        self.conv = [z(1, k - 1, self.d) for k in self.kernels]
        self.offset = 0
        self.valid = 0

    def step(self, window: torch.Tensor) -> torch.Tensor:
        """[T_in, 80] window → [chunk, V] posteriors."""
        W, c = self.W, self.cache
        x = blocks.subsample4(W, window[None], self.cmvn)
        t = x.shape[1]
        s = c + t
        idx = torch.arange(s, device=x.device) + self.offset - c
        pos = (self.pe[idx.clamp(min=0)] * (idx >= 0)[:, None])[None]
        mask = (torch.arange(s, device=x.device) >= c - self.valid)[None,
                                                                     None]
        for i, kernel in enumerate(self.kernels):
            p = f'encoder.layers.{i}.'
            x = x + 0.5 * blocks.ffn(W, p + 'feed_forward_macaron',
                                     blocks.layer_norm(W, p +
                                                       'norm_ff_macaron', x))
            y, (k, v) = blocks.rel_attention(
                W, p + 'self_attn', blocks.layer_norm(W, p + 'norm_mha', x),
                pos, mask, self.heads, (self.k[i], self.v[i]))
            self.k[i], self.v[i] = k[:, k.shape[1] - c:], v[:, v.shape[1] - c:]
            x = x + y
            y, self.conv[i] = blocks.conv_module(
                W, p + 'conv_module', blocks.layer_norm(W, p + 'norm_conv', x),
                kernel, cache=self.conv[i])
            x = x + y
            x = x + 0.5 * blocks.ffn(W, p + 'feed_forward',
                                     blocks.layer_norm(W, p + 'norm_ff', x))
            if self.block_norm:
                x = blocks.layer_norm(W, p + 'norm_final', x)
        x = blocks.layer_norm(W, 'encoder.after_norm', x)
        self.offset += t
        self.valid = min(self.valid + t, c)
        return blocks.ctc_probs(W, x)[0]
