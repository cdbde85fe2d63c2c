"""Attention and padding masks (counterpart of ppasr_tpu/ops/masks.py:31-120),
built by broadcast integer arithmetic on the lengths' device.

``add_optional_chunk_mask`` covers full context, a fixed decoding chunk, a
static chunk, the pad mask alone, and the random dynamic chunk of training
(``decoding_chunk_size == 0``, :97-112). The training draw is one per batch
and is taken apart from the mask: ``draw_dynamic_chunk`` draws the two raw
integers from a ``torch.Generator`` and ``dynamic_chunk_from_draw`` maps them
to (chunk size, left chunks), so a test can hand the port the draw that
JAX's key gives. ``DeviceChunk`` takes the generator's place in a forward
that a CUDA graph captures: the chunk then reaches the mask as device data,
drawn on the host and written in before each replay.
"""
import torch


def draw_dynamic_chunk(max_len: int, generator: torch.Generator = None):
    """The batch's raw draws: (draw ∈ [1, max(max_len, 2)), left_draw ∈
    [0, 2**30)), as ``jax.random.randint`` draws them from k1 and k2."""
    draw = torch.randint(1, max(max_len, 2), (), generator=generator)
    left = torch.randint(0, 2 ** 30, (), generator=generator)
    return int(draw), int(left)


def dynamic_chunk_from_draw(draw: int, left_draw: int, max_len: int,
                            use_dynamic_left_chunk: bool):
    """(chunk_size, num_left_chunks) of a training batch: the full context
    when draw > max_len // 2, else a chunk of draw % 25 + 1 frames, with
    left_draw % max(⌊(max_len − 1) / chunk⌋, 1) left chunks when
    ``use_dynamic_left_chunk`` (else all of them, −1)."""
    if draw > max_len // 2:
        return max_len, -1
    chunk_size = draw % 25 + 1
    if not use_dynamic_left_chunk:
        return chunk_size, -1
    return chunk_size, left_draw % max((max_len - 1) // chunk_size, 1)


class DeviceChunk:
    """The dynamic chunk as device data, for a captured training forward.

    Given to ``add_optional_chunk_mask`` in place of the ``'chunk'``
    generator, it records the call's (max_len, use_dynamic_left_chunk) and
    builds the chunk mask from ``sizes``, a [2] int64 tensor (chunk size,
    left chunks) on the device. ``draw(generator)`` then draws from a
    micro-step's own ``'chunk'`` generator what the eager forward would
    draw, maps it as ``dynamic_chunk_from_draw`` does and writes it in (two
    fills on the card, no host copy): one graph serves every draw.
    ``sizes`` is made before the capture: a block allocated inside one may
    be an earlier kernel's scratch, which the replay writes over after the
    fills."""

    def __init__(self, device):
        self.sizes = torch.ones(2, dtype=torch.long, device=device)
        self.call = None

    def mask(self, max_len: int, use_dynamic_left_chunk: bool
             ) -> torch.Tensor:
        if self.call is not None:
            raise RuntimeError("the forward draws its dynamic chunk twice; "
                               "a DeviceChunk holds one draw")
        self.call = (max_len, use_dynamic_left_chunk)
        return subsequent_chunk_mask(max_len, self.sizes[0], self.sizes[1],
                                     device=self.sizes.device)

    def draw(self, generator: torch.Generator):
        if self.call is None:
            return
        max_len, use_left = self.call
        chunk, left = dynamic_chunk_from_draw(
            *draw_dynamic_chunk(max_len, generator), max_len, use_left)
        self.sizes[0].fill_(chunk)
        self.sizes[1].fill_(left)


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, T] bool, True on PADDED positions."""
    seq = torch.arange(max_len, device=lengths.device)[None, :]
    return seq >= lengths.to(torch.long)[:, None]


def make_non_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, T] bool, True on VALID positions."""
    return ~make_pad_mask(lengths, max_len)


def subsequent_mask(size: int, device=None) -> torch.Tensor:
    """[size, size] lower-triangular causal mask (ppasr_tpu/ops/masks.py:
    36-40)."""
    i = torch.arange(size, device=device)
    return i[:, None] >= i[None, :]


def subsequent_chunk_mask(size: int, chunk_size, num_left_chunks=-1,
                          device=None) -> torch.Tensor:
    """[size, size] block-causal chunk mask: position i attends to
    [start, (i//chunk + 1) * chunk) with start = 0 when num_left_chunks < 0,
    else max(0, (i//chunk - num_left_chunks) * chunk). The chunk size and
    left chunks are ints, or 0-d int64 tensors on ``device``
    (``DeviceChunk``)."""
    i = torch.arange(size, device=device)[:, None]
    j = torch.arange(size, device=device)[None, :]
    chunk_idx = i // chunk_size
    ending = (chunk_idx + 1) * chunk_size
    start = torch.clamp((chunk_idx - num_left_chunks) * chunk_size,
                        min=0) * (num_left_chunks >= 0)
    return (j >= start) & (j < ending)


def add_optional_chunk_mask(max_len: int, masks: torch.Tensor,
                            use_dynamic_chunk: bool,
                            use_dynamic_left_chunk: bool,
                            decoding_chunk_size: int, static_chunk_size: int,
                            num_decoding_left_chunks: int,
                            generator: torch.Generator = None,
                            chunk_draw: tuple = None) -> torch.Tensor:
    """Combine the [B, 1, T] pad mask with an optional chunk mask →
    [B, T, T] (or the pad mask itself when no chunk mask applies).

    decoding_chunk_size < 0: full context; > 0: that chunk with
    num_decoding_left_chunks; == 0 with use_dynamic_chunk: the training
    draw, ``chunk_draw`` (draw, left_draw) if given, else drawn from
    ``generator``, or read on the device where ``generator`` is a
    ``DeviceChunk``."""
    if use_dynamic_chunk:
        if decoding_chunk_size < 0:
            chunk_size, num_left_chunks = max_len, -1
        elif decoding_chunk_size > 0:
            chunk_size = decoding_chunk_size
            num_left_chunks = num_decoding_left_chunks
        elif isinstance(generator, DeviceChunk):
            return masks & generator.mask(max_len,
                                          use_dynamic_left_chunk)[None, :, :]
        else:
            if chunk_draw is None:
                chunk_draw = draw_dynamic_chunk(max_len, generator)
            chunk_size, num_left_chunks = dynamic_chunk_from_draw(
                *chunk_draw, max_len, use_dynamic_left_chunk)
    elif static_chunk_size > 0:
        chunk_size, num_left_chunks = static_chunk_size, \
            num_decoding_left_chunks
    else:
        return masks
    chunk_masks = subsequent_chunk_mask(max_len, chunk_size, num_left_chunks,
                                        device=masks.device)
    return masks & chunk_masks[None, :, :]
