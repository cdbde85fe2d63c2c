"""Batched chunked-streaming encode for evaluation (counterpart of
ppasr_tpu/models/streaming_eval.py).

Drives each window through the model's ``stream_step`` exactly as the
streaming predictor does (``models/streaming.ChunkGeometry``), with B
streams sharing one ``StreamingState`` on the model's device.
``streaming_greedy_batch`` takes the argmax and max of each window's
posteriors on the device, so only [B, chunk] id and score planes go to the
host. Both functions run under ``utils/precision.ieee_float32()``.

The JAX functions take ``params`` and jitted step functions; the port's
take the module, which holds its weights, and run eagerly. The attention
families run here, their output lengths divided by the model's
``output_factor``; DeepSpeech2, whose state is no ring cache, raises as
the JAX trainer does for it (ppasr_tpu/trainer.py:790-796). The cache is
the JAX function's ``chunk·left_chunks``.
"""
import numpy as np
import torch

from ppasr_tpu_torch.decoders.greedy import ctc_argmax
from ppasr_tpu_torch.models.streaming import ChunkGeometry
from ppasr_tpu_torch.utils.precision import ieee_float32


def _out_lens(model, in_lens, t_cap):
    olens = ChunkGeometry.n_out(np.asarray(in_lens), model.output_factor)
    return np.minimum(olens, t_cap).astype(np.int32)


def _run_windows(model, inputs, chunk, left_chunks, reduce):
    """[reduce(probs [B, chunk, V]) for each window], the windows run in
    order on the model's device with one shared streaming state."""
    if not model.ring_cache:
        raise NotImplementedError(
            "streaming_eval drives the attention-family chunk API "
            "(get_encoder_out_chunk with a ring-cache state), as in the JAX "
            "package; use the predictor's predict_stream for deepspeech2 "
            "(ROADMAP, raises kept from the JAX package)")
    device = next(model.parameters()).device
    geo = ChunkGeometry(chunk, left_chunks)
    inputs = np.asarray(inputs)
    bsz, t_max, feat_dim = inputs.shape
    n_win = -(-int(geo.n_out(t_max)) // chunk)
    pad_t = (n_win - 1) * geo.stride + geo.window
    # pad_t can fall up to 3 frames short of t_max, when the output frames
    # are a multiple of chunk: those frames end no subsampling step and
    # feed no output frame, so they are dropped (the JAX function raises)
    x = np.zeros((bsz, pad_t, feat_dim), np.float32)
    x[:, :min(t_max, pad_t)] = inputs[:, :pad_t]
    out = []
    with torch.inference_mode(), ieee_float32():
        state = model.init_state(x.shape[0], chunk * left_chunks, device)
        for k in range(n_win):
            xs = torch.from_numpy(
                x[:, k * geo.stride:k * geo.stride + geo.window]).to(device)
            probs_k, _, state = model.stream_step(xs, geo.window, state)
            out.append(reduce(probs_k[:, :chunk]))
    return out


def streaming_encode_batch(model, inputs, in_lens, chunk: int = 16,
                           left_chunks: int = 16):
    """[B, T, F] features → (probs [B, T', V] on the model's device,
    out_lens [B] np) through the chunked-streaming path.

    Tail windows are zero-padded up to the decoding window and clipped by
    out_lens, the same approximation the single-stream predictor makes on
    its final flush."""
    probs = torch.cat(_run_windows(model, inputs, chunk, left_chunks,
                                   lambda p: p), dim=1)
    return probs, _out_lens(model, in_lens, probs.shape[1])


def _argmax_planes(probs_k):
    ids, max_probs = ctc_argmax(probs_k)
    return ids.to(torch.int32).cpu().numpy(), max_probs.cpu().numpy()


def streaming_greedy_batch(model, inputs, in_lens, chunk: int = 16,
                           left_chunks: int = 16):
    """Greedy variant: [B, T, F] → (ids [B, T'] np int32, max_probs
    [B, T'] np, out_lens [B] np); per-window argmax on the device, host
    concat. Feed the planes to ``decoders.greedy._collapse``."""
    planes = _run_windows(model, inputs, chunk, left_chunks, _argmax_planes)
    ids = np.concatenate([p[0] for p in planes], axis=1)
    mp = np.concatenate([p[1] for p in planes], axis=1)
    return ids, mp, _out_lens(model, in_lens, ids.shape[1])
