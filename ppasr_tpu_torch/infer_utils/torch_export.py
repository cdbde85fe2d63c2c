"""Serialized inference programs, ``torch.export`` (counterpart of
ppasr_tpu/infer_utils/stablehlo_export.py:1-125, whose ``.stablehlo`` files
PyTorch cannot read).

``trainer.export(save_stablehlo=True)`` writes, next to the msgpack
parameters:

- ``offline.pt2``: ``get_encoder_out(params, speech[b, 16·tb, D], lens[b])``
  with a symbolic batch ``b`` and ``2 ≤ tb ≤ MAX_FRAMES / 16`` (JAX :45-60;
  a time axis in 16-frame units keeps the subsampling and the
  Squeezeformer's reduce and recover arithmetic provably equal);
- ``chunk.pt2``: one streaming ``get_encoder_out_chunk`` step at the window
  (67 frames) and attention cache (64) of the standard decoding, batch 1,
  with the model's state flattened to a plain tuple of tensors at the
  boundary (JAX :62-99); DeepSpeech2's step also takes ``lens``, which the
  program requires to be the window's length (its RNNs run all frames).

``params`` is an input, as in JAX: the programs hold the computation, the
CMVN constants and the positional table, not the weights, which come from
``model.msgpack`` or ``model_quant.msgpack`` as the torch ``state_dict``
(``utils/checkpoint.convert_params``), a dict in the order of the
program's input spec. A program carries the device it was traced on, so
export writes one pair per device kind (``offline.pt2``/``chunk.pt2`` for
the CPU, ``offline.cuda.pt2``/``chunk.cuda.pt2`` for the card), as JAX
lowers for ``platforms=('cpu', 'tpu')``; ``load_exported`` raises for a
device that has no program, never moving one.

Loading needs no model code: ``load_exported`` and
``zero_state_from_exported`` (JAX :102-125) read the programs and rebuild
the zero streaming state from their input specs. DeepSpeech2's RNNs are
the ``ppasr_tpu_torch::rnn`` operator (``ops/rnn``), which this module
registers by importing it.
"""
import contextlib
import copy
import os

import torch
from torch.export import Dim
from torch.utils import _pytree

from ppasr_tpu_torch.ops import rnn as _rnn_op  # noqa: F401  (registers it)

MAX_FRAMES = 16000      # 160 s at a 10 ms shift; keeps T' under max_len 5000
OFFLINE_FILE = 'offline.pt2'
CHUNK_FILE = 'chunk.pt2'


def program_file(name: str, device_type: str) -> str:
    """``offline.pt2`` → ``offline.pt2`` for the CPU, ``offline.cuda.pt2``
    for the card."""
    if device_type == 'cpu':
        return name
    return name.replace('.pt2', f'.{device_type}.pt2')


def state_leaves(state) -> tuple:
    """The tensors of a state NamedTuple (and its nested tuples), in
    order."""
    if isinstance(state, tuple):
        return tuple(leaf for part in state for leaf in state_leaves(part))
    return (state,)


def _unflatten(template, leaves):
    if isinstance(template, tuple):
        parts = [_unflatten(part, leaves) for part in template]
        return type(template)(*parts) if hasattr(template, '_fields') \
            else tuple(parts)
    return next(leaves)


class _Program(torch.nn.Module):
    """Calls ``fn(model, ...)`` with the module's parameters and buffers
    replaced by the ``params`` input. The model is kept out of the module
    tree, so its weights are not part of the program."""

    def __init__(self, model, fn):
        super().__init__()
        self.__dict__['model'] = model
        self.fn = fn

    def call(self, params, *args):
        with torch.nn.utils.stateless._reparametrize_module(self.model,
                                                            params):
            return self.fn(self.model, *args)


class _Offline(_Program):
    def forward(self, params, speech, lens):
        return self.call(params, speech, lens)


class _Chunk(_Program):
    def forward(self, params, xs, state):
        return self.call(params, xs, state)


class _ChunkLens(_Program):
    def forward(self, params, xs, lens, state):
        return self.call(params, xs, lens, state)


@contextlib.contextmanager
def _unpacked_rnns(model):
    """DeepSpeech2's encoders run their RNNs unpacked inside the block
    (``models/deepspeech2.CRNNEncoder._run``)."""
    encoders = [m for m in model.modules() if hasattr(type(m), 'unpacked')]
    for m in encoders:
        m.unpacked = True
    try:
        yield
    finally:
        for m in encoders:
            del m.unpacked


def _write(program, path):
    """Save without the example inputs, which hold the weights."""
    program.example_inputs = None
    tmp = f'{path}.{os.getpid()}.tmp.pt2'
    torch.export.save(program, tmp)
    os.replace(tmp, path)


@torch.no_grad()
def export_programs(model, out_dir: str, use_model: str, input_dim: int,
                    chunk_window: int = 67, chunk_cache: int = 64,
                    devices=None) -> list:
    """Write the offline (and, for a streaming model, the chunk) program
    of ``model`` for each device kind in ``devices`` (default: the CPU,
    and the card too when the model is on it) → the paths written."""
    here = next(model.parameters()).device
    if devices is None:
        devices = ('cpu',) if here.type == 'cpu' else ('cpu', here.type)
    written = []
    for kind in devices:
        m = model if here.type == kind else copy.deepcopy(model).to(kind)
        was_training = m.training
        m.eval()
        try:
            written += _export_on(m, out_dir, use_model, input_dim,
                                  chunk_window, chunk_cache, kind)
        finally:
            m.train(was_training)
    return written


def _export_on(model, out_dir, use_model, input_dim, chunk_window,
               chunk_cache, kind):
    device = torch.device('cuda:0' if kind == 'cuda' else kind)
    params = {k: v.detach() for k, v in model.state_dict().items()}
    param_dims = {k: None for k in params}
    b = Dim('b', min=1)
    tb = Dim('tb', min=2, max=MAX_FRAMES // 16)
    speech = torch.zeros(2, 16 * 7, input_dim, device=device)
    lens = torch.full((2,), 16 * 7, dtype=torch.int32, device=device)
    written = []
    with _unpacked_rnns(model):
        offline = torch.export.export(
            _Offline(model, lambda m, s, l: m.get_encoder_out(s, l)),
            (params, speech, lens),
            dynamic_shapes=(param_dims, {0: b, 1: 16 * tb}, {0: b}),
            strict=False)
        path = os.path.join(out_dir, program_file(OFFLINE_FILE, kind))
        _write(offline, path)
        written.append(path)
        if not model.streaming:
            return written
        xs = torch.zeros(1, chunk_window, input_dim, device=device)
        if use_model == 'deepspeech2':
            template = model.init_state(1, device=device)

            def step(m, x, xl, leaves):
                probs, olens, new = m.get_encoder_out_chunk(
                    x, xl, _unflatten(template, iter(leaves)))
                return probs, olens, state_leaves(new)

            chunk = torch.export.export(
                _ChunkLens(model, step),
                (params, xs, torch.full((1,), chunk_window,
                                        dtype=torch.int32, device=device),
                 state_leaves(template)), strict=False)
        else:
            template = model.init_state(1, chunk_cache, device)

            def step(m, x, leaves):
                probs, new = m.get_encoder_out_chunk(
                    x, _unflatten(template, iter(leaves)))
                return probs, state_leaves(new)

            chunk = torch.export.export(
                _Chunk(model, step), (params, xs, state_leaves(template)),
                strict=False)
        path = os.path.join(out_dir, program_file(CHUNK_FILE, kind))
        _write(chunk, path)
        written.append(path)
    return written


def load_exported(model_dir: str, device='cpu'):
    """(offline program | None, chunk program | None) for ``device``'s
    kind. Raises ``RuntimeError`` when the directory holds programs for
    other devices only."""
    kind = torch.device(device).type
    out = []
    for name in (OFFLINE_FILE, CHUNK_FILE):
        path = os.path.join(model_dir, program_file(name, kind))
        out.append(torch.export.load(path) if os.path.exists(path) else None)
    if out[0] is None:
        others = [f for f in sorted(os.listdir(model_dir))
                  if f.startswith('offline.') and f.endswith('.pt2')]
        if others:
            raise RuntimeError(
                f"{model_dir} holds programs {others} but none for {kind}; "
                f"export on a {kind} device (a program is not moved)")
    return tuple(out)


def exported_args(program) -> tuple:
    """The positional inputs of a program as its trace saw them: a tree of
    fake tensors with their shapes (symbolic where the program is) and
    dtypes."""
    names = set(program.graph_signature.user_inputs)
    vals = [n.meta['val'] for n in program.graph.nodes
            if n.op == 'placeholder' and n.name in names]
    args, _kwargs = _pytree.tree_unflatten(vals, program.call_spec.in_spec)
    return args


def zero_state_from_exported(program, state_index: int, device) -> tuple:
    """The streaming state's zero template, rebuilt from the chunk
    program's input spec: no model code on the serving host."""
    return tuple(torch.zeros(tuple(int(s) for s in v.shape), dtype=v.dtype,
                             device=device)
                 for v in exported_args(program)[state_index])
