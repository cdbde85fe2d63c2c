"""What the streaming loops (``predict``, ``serving``,
``models/streaming_eval``) share besides each family's ``stream_step``:
the chunk math of the JAX predictor (ppasr_tpu/predict.py:140-150), which
assumes ×4 subsampling (ROADMAP, "Faults of the reference" item 5), the
running gain and the walks over a state's tensors."""
import numpy as np


class ChunkGeometry:
    """The windows of a streaming decode at ``chunk`` output frames a step:
    ``window`` (chunk − 1)·4 + 7 input frames, ``stride`` chunk·4 frames,
    ``cache_size`` chunk·left_chunks frames of attention history (16
    chunks, the static cap that stands for all of it, where left_chunks ≤
    0), and the 16 kHz samples of a window and of a stride."""
    subsampling, context = 4, 7

    def __init__(self, chunk: int, left_chunks: int = -1):
        self.chunk = chunk
        self.window = (chunk - 1) * self.subsampling + self.context
        self.stride = chunk * self.subsampling
        self.cache_size = chunk * (left_chunks if left_chunks > 0 else 16)
        self.win_samples = self.samples(self.window)
        self.stride_samples = self.stride * 160

    @staticmethod
    def samples(frames: int) -> int:
        """Samples that frame into ``frames`` 25 ms frames at a 10 ms hop."""
        return (frames - 1) * 160 + 400

    @classmethod
    def n_out(cls, frames, output_factor: int = 1):
        """Output frames of a window with ``frames`` valid input frames (an
        int or an array of them), at least 1, divided (rounding up) by the
        model's ``output_factor``."""
        n = np.maximum(frames - cls.context, 0) // cls.subsampling + 1
        return (n + output_factor - 1) // output_factor


class RunningGain:
    """A stream's dB normalization to ``target_db`` (None: none) as an
    additive log-mel offset, from the RMS of all its samples so far."""

    def __init__(self, target_db):
        self.target_db, self.sq_sum, self.n = target_db, 0.0, 0

    def add(self, samples: np.ndarray):
        self.sq_sum += float(np.sum(samples.astype(np.float64) ** 2))
        self.n += len(samples)

    def offset(self) -> float:
        if self.target_db is None or not self.n:
            return 0.0
        rms_db = 10.0 * np.log10(self.sq_sum / self.n + 1e-20)
        return float(min(self.target_db - rms_db, 300.0) * np.log(10.0)
                     / 10.0)


def stream_axes(state):
    """The stream axis of each field of ``state``, as a tree of its shape:
    the state type's own ``stream_axes`` (guessing by size breaks where
    another dimension equals the stream count)."""
    if not hasattr(state, 'stream_axes'):
        raise TypeError(f"unknown state type: {type(state)}")
    return state.stream_axes()


def tree_leaves(tree) -> list:
    """The tensors of a NamedTuple or tuple tree, in order."""
    if isinstance(tree, tuple):
        return [x for part in tree for x in tree_leaves(part)]
    return [tree]


def tree_map(fn, *trees):
    """``fn`` over the tensors of equally shaped NamedTuples and tuples,
    rebuilt as the first tree is."""
    first = trees[0]
    if isinstance(first, tuple):
        out = [tree_map(fn, *parts) for parts in zip(*trees)]
        return type(first)(*out) if hasattr(first, '_fields') \
            else tuple(out)
    return fn(*trees)
