"""Checkpoints: flax msgpack ↔ numpy tree ↔ torch ``state_dict``.

The JAX package writes its parameters with ``flax.serialization.to_bytes``
(ppasr_tpu/trainer.py:906-907) and reads them back with
``serialization.from_bytes`` (ppasr_tpu/predict.py:121-126). The port reads
the same file without flax or the ``msgpack`` package:

- ``msgpack_restore`` is a standard-library msgpack decoder for flax's
  format. Flax stores each array as msgpack ext type 1 whose payload is the
  msgpack triple ``(shape, dtype_name, raw_bytes)`` (flax/serialization.py
  ``_ndarray_to_bytes``); ext 3 is a numpy scalar in the same form, ext 2 a
  complex number, and arrays over 2**30 bytes are split into
  ``__msgpack_chunked_array__`` dicts.
- ``convert_params`` maps the flax parameter tree (and the BatchNorm
  ``batch_stats`` collection) onto the port's module names and layouts;
  the flax RNN cells of DeepSpeech2 become ``nn.LSTM``/``nn.GRU``
  weights.

And the way back, so that the trainer's ``model.msgpack`` is the file both
packages read (ppasr_tpu/trainer.py:258-261):

- ``export_params`` maps a module's parameters to the flax tree
  ``{'params': ...}`` (the inverse of ``convert_params``, by module type);
- ``msgpack_serialize`` writes a tree of dicts and numpy arrays in flax's
  format (``flax.serialization.to_bytes``), arrays as ext type 1.
"""
import json
import os
import struct

import numpy as np
import torch
from torch import nn

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), 'utf-8')
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        if b in (0xc4, 0xc5, 0xc6):                     # bin 8/16/32
            n = self.unpack({0xc4: '>B', 0xc5: '>H', 0xc6: '>I'}[b])
            return self.take(n)
        if b in (0xc7, 0xc8, 0xc9):                     # ext 8/16/32
            n = self.unpack({0xc7: '>B', 0xc8: '>H', 0xc9: '>I'}[b])
            code = self.unpack('>b')
            return _ext(code, self.take(n))
        if b == 0xca:
            return self.unpack('>f')
        if b == 0xcb:
            return self.unpack('>d')
        ints = {0xcc: '>B', 0xcd: '>H', 0xce: '>I', 0xcf: '>Q',
                0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
        if b in ints:
            return self.unpack(ints[b])
        if 0xd4 <= b <= 0xd8:                           # fixext 1..16
            code = self.unpack('>b')
            return _ext(code, self.take(1 << (b - 0xd4)))
        if b in (0xd9, 0xda, 0xdb):                     # str 8/16/32
            n = self.unpack({0xd9: '>B', 0xda: '>H', 0xdb: '>I'}[b])
            return str(self.take(n), 'utf-8')
        if b in (0xdc, 0xdd):
            return self.array(self.unpack('>H' if b == 0xdc else '>I'))
        if b in (0xde, 0xdf):
            return self.map(self.unpack('>H' if b == 0xde else '>I'))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _unpack_all(data):
    r = _Reader(data)
    v = r.value()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after msgpack object")
    return v


def _ndarray(payload) -> np.ndarray:
    shape, dtype_name, buf = _unpack_all(payload)
    if isinstance(dtype_name, memoryview):
        dtype_name = str(dtype_name, 'ascii')
    if dtype_name == 'bfloat16':
        raise ValueError("bfloat16 leaves are not supported by the port's "
                         "checkpoint reader")
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def _ext(code, payload):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == _EXT_COMPLEX:
        re, im = _unpack_all(payload)
        return complex(re, im)
    raise ValueError(f"unsupported msgpack ext type {code}")


def _unchunk(tree):
    """Reassemble flax's chunked oversized arrays (flax ``_unchunk``)."""
    if not isinstance(tree, dict):
        return tree
    if '__msgpack_chunked_array__' in tree:
        shape = tuple(tree['shape'][k] for k in sorted(tree['shape'], key=int))
        chunks = [tree['chunks'][k] for k in sorted(tree['chunks'], key=int)]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """flax.serialization.msgpack_restore without flax: bytes → nested dict
    of numpy arrays (read-only views of ``data``)."""
    return _unchunk(_unpack_all(data))


def load_msgpack(path: str):
    with open(path, 'rb') as f:
        return msgpack_restore(f.read())


def load_inference_params(model_dir: str):
    """An exported directory's flax tree → (tree, file name): its
    ``model.msgpack``, else its int8 ``model_quant.msgpack`` dequantized to
    float32 (``utils/quant``), as ppasr_tpu/predict.py:121-138 loads them;
    neither raises ``FileNotFoundError``."""
    from ppasr_tpu_torch.utils.quant import dequantize_params
    for name in ('model.msgpack', 'model_quant.msgpack'):
        path = os.path.join(model_dir, name)
        if os.path.exists(path):
            tree = load_msgpack(path)
            return (tree if name == 'model.msgpack'
                    else dequantize_params(tree)), name
    raise FileNotFoundError(f"no model.msgpack / model_quant.msgpack in "
                            f"{model_dir}")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# flax lists of submodules (``name_<i>``) that the port keeps as
# ``nn.ModuleList``s (``name.<i>``)
_LIST_MODULES = ('layers', 'fwd_rnns', 'bwd_rnns', 'norms')


def _torch_name(path) -> str:
    out = []
    for p in path:
        head, _, idx = p.rpartition('_')
        if head in _LIST_MODULES and idx.isdigit():
            out.extend([head, idx])            # flax list → nn.ModuleList
        else:
            out.append(p)
    return '.'.join(out)


def _flax_path(torch_name: str) -> list:
    """The inverse of ``_torch_name`` for a module's dotted name."""
    parts = torch_name.split('.') if torch_name else []
    path, i = [], 0
    while i < len(parts):
        if parts[i] in _LIST_MODULES and i + 1 < len(parts) \
                and parts[i + 1].isdigit():
            path.append(f'{parts[i]}_{parts[i + 1]}')
            i += 2
        else:
            path.append(parts[i])
            i += 1
    return path


def _convert_leaf(name: str, arr: np.ndarray):
    """(flax leaf name, array) → (torch leaf name, array in torch layout)."""
    if name == 'kernel':
        if arr.ndim == 2:      # Dense [in, out] → Linear.weight [out, in]
            return 'weight', arr.T
        if arr.ndim == 3:      # depthwise 1-D conv [k, 1, C] → [C, 1, k]
            return 'weight', arr.transpose(2, 1, 0)
        if arr.ndim == 4:      # NHWC Conv [kh, kw, in, out] → [out, in, kh, kw]
            return 'weight', arr.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {arr.ndim}")
    if name in ('scale', 'embedding'):   # LayerNorm/BatchNorm, Embed [V, D]
        return 'weight', arr
    if name in ('bias', 'pos_bias_u', 'pos_bias_v', 'ada_scale', 'ada_bias'):
        return name, arr
    raise ValueError(f"unknown parameter leaf {name!r}")


# the gates of flax's OptimizedLSTMCell and GRUCell, in the order nn.LSTM
# (i, f, g, o) and nn.GRU (r, z, n) stack them
_LSTM_GATES, _GRU_GATES = 'ifgo', 'rzn'


def _rnn_from_cell(cell: dict) -> dict:
    """A flax ``OptimizedLSTMCell`` (``{ii,if,ig,io}/kernel``,
    ``{hi,hf,hg,ho}/{kernel,bias}``) or ``GRUCell`` (``{ir,iz,in}/{kernel,
    bias}``, ``{hr,hz}/kernel``, ``hn/{kernel,bias}``) → the ``_l0``
    weights of a one-layer ``nn.LSTM`` / ``nn.GRU``. LSTM: no input bias,
    the hidden biases in ``bias_hh``. GRU: ``bias_ih`` from the input
    biases, ``bias_hh`` zero for r and z and ``hn.bias`` for n (torch and
    flax both apply it inside r·(…))."""
    lstm = 'ii' in cell
    gates = _LSTM_GATES if lstm else _GRU_GATES
    w_ih = np.concatenate([np.asarray(cell['i' + g]['kernel']).T
                           for g in gates])
    w_hh = np.concatenate([np.asarray(cell['h' + g]['kernel']).T
                           for g in gates])
    h = w_hh.shape[1]
    zeros = np.zeros(h, np.float32)
    if lstm:
        b_ih = np.zeros(4 * h, np.float32)
        b_hh = np.concatenate([np.asarray(cell['h' + g]['bias'])
                               for g in gates])
    else:
        b_ih = np.concatenate([np.asarray(cell['i' + g]['bias'])
                               for g in gates])
        b_hh = np.concatenate([zeros, zeros, np.asarray(cell['hn']['bias'])])
    return {'weight_ih_l0': w_ih, 'weight_hh_l0': w_hh,
            'bias_ih_l0': b_ih, 'bias_hh_l0': b_hh}


def _cell_from_rnn(m: nn.Module) -> dict:
    """The inverse of ``_rnn_from_cell`` for a trained module: LSTM input
    and hidden biases fold into the flax hidden biases; GRU r and z biases
    fold into the flax input biases."""
    lstm = isinstance(m, nn.LSTM)
    gates = _LSTM_GATES if lstm else _GRU_GATES
    get = lambda t: t.detach().float().cpu().numpy()  # noqa: E731
    n = len(gates)
    w_ih = np.split(get(m.weight_ih_l0), n)
    w_hh = np.split(get(m.weight_hh_l0), n)
    b_ih = np.split(get(m.bias_ih_l0), n)
    b_hh = np.split(get(m.bias_hh_l0), n)
    cell = {}
    for k, g in enumerate(gates):
        cell['i' + g] = {'kernel': np.ascontiguousarray(w_ih[k].T)}
        cell['h' + g] = {'kernel': np.ascontiguousarray(w_hh[k].T)}
        if lstm:
            cell['h' + g]['bias'] = b_ih[k] + b_hh[k]
        elif g == 'n':
            cell['in']['bias'] = b_ih[k].copy()
            cell['hn']['bias'] = b_hh[k].copy()
        else:
            cell['i' + g]['bias'] = b_ih[k] + b_hh[k]
    return cell


def _convert_tree(tree: dict, prefix: tuple, state: dict):
    for k, v in tree.items():
        if isinstance(v, dict) and k == 'cell' and ('ii' in v or 'ir' in v):
            for leaf, arr in _rnn_from_cell(v).items():
                state[_torch_name(prefix + (leaf,))] = arr
        elif isinstance(v, dict):
            _convert_tree(v, prefix + (k,), state)
        else:
            leaf, value = _convert_leaf(k, np.asarray(v))
            state[_torch_name(prefix + (leaf,))] = value


def convert_params(flax_tree: dict):
    """Flax variables (``{'params': {...}}`` with an optional
    ``'batch_stats'`` collection, or the inner params dict) → torch
    ``state_dict`` of every leaf.

    Maps ``Dense.kernel [in,out]`` → ``Linear.weight [out,in]``, NHWC
    ``Conv.kernel [kh,kw,in,out]`` → ``[out,in,kh,kw]``, the depthwise
    ``[k,1,C]`` kernel → ``[C,1,k]``, LayerNorm and BatchNorm ``scale`` and
    ``Embed.embedding`` → ``weight``; ``pos_bias_u/v [H,dk]``,
    ``ada_scale``/``ada_bias`` and biases unchanged; each RNN ``cell``
    → its ``nn.LSTM``/``nn.GRU`` weights (``_rnn_from_cell``); the
    BatchNorm statistics ``batch_stats/.../{mean,var}`` →
    ``running_mean``/``running_var``."""
    params = flax_tree.get('params', flax_tree)
    state = {}
    _convert_tree(params, (), state)
    stats = flax_tree.get('batch_stats', {}) if 'params' in flax_tree else {}
    for path, arr in _flatten(stats):
        leaf = {'mean': 'running_mean', 'var': 'running_var'}[path[-1]]
        state[_torch_name(path[:-1] + (leaf,))] = np.asarray(arr)
    return {k: torch.from_numpy(np.ascontiguousarray(v).copy())
            for k, v in state.items()}


def _pack(value, out: list):
    if isinstance(value, dict):
        n = len(value)
        out.append(bytes([0x80 | n]) if n < 16 else
                   struct.pack('>BH', 0xde, n) if n < 1 << 16 else
                   struct.pack('>BI', 0xdf, n))
        for k, v in value.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(value, (list, tuple)):
        n = len(value)
        out.append(bytes([0x90 | n]) if n < 16 else
                   struct.pack('>BH', 0xdc, n) if n < 1 << 16 else
                   struct.pack('>BI', 0xdd, n))
        for v in value:
            _pack(v, out)
    elif isinstance(value, str):
        b = value.encode('utf-8')
        n = len(b)
        out.append(bytes([0xa0 | n]) if n < 32 else
                   struct.pack('>BB', 0xd9, n) if n < 1 << 8 else
                   struct.pack('>BH', 0xda, n) if n < 1 << 16 else
                   struct.pack('>BI', 0xdb, n))
        out.append(b)
    elif isinstance(value, (bytes, bytearray, memoryview)):
        b = bytes(value)
        n = len(b)
        out.append(struct.pack('>BB', 0xc4, n) if n < 1 << 8 else
                   struct.pack('>BH', 0xc5, n) if n < 1 << 16 else
                   struct.pack('>BI', 0xc6, n))
        out.append(b)
    elif value is None or isinstance(value, bool):
        out.append({None: b'\xc0', False: b'\xc2', True: b'\xc3'}[value])
    elif isinstance(value, (int, np.integer)) and not isinstance(
            value, np.ndarray):
        v = int(value)
        if 0 <= v < 128:
            out.append(bytes([v]))
        elif -32 <= v < 0:
            out.append(struct.pack('>b', v))
        elif v >= 0:
            out.append(struct.pack('>BQ', 0xcf, v))
        else:
            out.append(struct.pack('>Bq', 0xd3, v))
    elif isinstance(value, float):
        out.append(struct.pack('>Bd', 0xcb, value))
    elif isinstance(value, np.ndarray):
        if value.nbytes > 1 << 30:
            raise ValueError("arrays over 2**30 bytes need flax's chunking, "
                             "which the writer does not do")
        arr = np.ascontiguousarray(value)
        payload = []
        _pack([list(arr.shape), arr.dtype.name, arr.tobytes()], payload)
        payload = b''.join(payload)
        n = len(payload)
        out.append(struct.pack('>BBb', 0xc7, n, _EXT_NDARRAY) if n < 1 << 8
                   else struct.pack('>BHb', 0xc8, n, _EXT_NDARRAY)
                   if n < 1 << 16 else
                   struct.pack('>BIb', 0xc9, n, _EXT_NDARRAY))
        out.append(payload)
    else:
        raise TypeError(f"cannot serialize {type(value).__name__}")


def msgpack_serialize(tree) -> bytes:
    """flax.serialization.msgpack_serialize without flax: a tree of dicts
    (str keys), lists, scalars and numpy arrays → bytes."""
    out = []
    _pack(tree, out)
    return b''.join(out)


def save_msgpack(path: str, tree):
    """Write ``tree`` to ``path`` through a temporary file."""
    tmp = f'{path}.{os.getpid()}.tmp'
    with open(tmp, 'wb') as f:
        f.write(msgpack_serialize(tree))
    os.replace(tmp, path)


def _flax_leaf(module: nn.Module, name: str, arr: np.ndarray):
    """(torch module, parameter name, array) → (flax leaf, array)."""
    from ppasr_tpu_torch.models.base import BatchNorm
    if name in ('bias', 'pos_bias_u', 'pos_bias_v', 'ada_scale', 'ada_bias'):
        return name, arr
    if isinstance(module, (nn.LayerNorm, BatchNorm)):
        return 'scale', arr
    if isinstance(module, nn.Embedding):
        return 'embedding', arr
    if isinstance(module, nn.Linear):
        return 'kernel', arr.T
    if isinstance(module, nn.Conv1d):
        return 'kernel', arr.transpose(2, 1, 0)
    if isinstance(module, nn.Conv2d):
        return 'kernel', arr.transpose(2, 3, 1, 0)
    raise ValueError(f"no flax leaf for {type(module).__name__}.{name}")


def _put(tree: dict, path: list, value):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def export_params(module: nn.Module) -> dict:
    """The module's parameters as the flax variables ``{'params': {...}}``
    of float32 numpy arrays, with a ``'batch_stats'`` collection when it
    has BatchNorms (copies: later updates of the module leave them be), the
    inverse of ``convert_params``: ``layers.<i>`` → ``layers_<i>``,
    ``Linear.weight [out,in]`` → ``kernel [in,out]``, conv weights back to
    NHWC and ``[k,1,C]``, LayerNorm and BatchNorm ``weight`` → ``scale``,
    ``Embedding.weight`` → ``embedding``, each ``nn.LSTM``/``nn.GRU`` → its
    flax ``cell`` (``_cell_from_rnn``), the BatchNorm running statistics →
    ``mean``/``var``."""
    from ppasr_tpu_torch.models.base import BatchNorm
    modules = dict(module.named_modules())
    tree, stats = {}, {}
    for name, m in modules.items():
        if isinstance(m, (nn.LSTM, nn.GRU)):
            _put(tree, _flax_path(name) + ['cell'], _cell_from_rnn(m))
        elif isinstance(m, BatchNorm):
            path = _flax_path(name)
            _put(stats, path + ['mean'], m.running_mean.detach().float()
                 .cpu().numpy().copy())
            _put(stats, path + ['var'], m.running_var.detach().float()
                 .cpu().numpy().copy())
    for name, p in module.named_parameters():
        mod_name, _, leaf = name.rpartition('.')
        if isinstance(modules[mod_name], (nn.LSTM, nn.GRU)):
            continue
        key, arr = _flax_leaf(modules[mod_name], leaf,
                              p.detach().float().cpu().numpy().copy())
        _put(tree, _flax_path(mod_name) + [key], np.ascontiguousarray(arr))
    return {'params': tree, 'batch_stats': stats} if stats \
        else {'params': tree}


def write_inference_artifact(out_dir: str, config: dict, model_msgpack: str,
                             vocab_path: str, mean_istd_path: str,
                             input_dim: int = None) -> str:
    """Write an exported-model directory in the format of
    ppasr_tpu/trainer.py:898-930 (``inference.json`` beside
    ``model.msgpack``, ``vocabulary.txt`` and ``mean_istd.json``). The
    three files are symlinked, never copied. ``config`` is a loaded config
    (``load_config``)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(vocab_path, 'r', encoding='utf-8') as f:
        vocab_size = sum(1 for line in f if line.strip())
    for src, name in ((model_msgpack, 'model.msgpack'),
                      (vocab_path, 'vocabulary.txt'),
                      (mean_istd_path, 'mean_istd.json')):
        dst = os.path.join(out_dir, name)
        if os.path.lexists(dst):
            os.remove(dst)
        os.symlink(os.path.abspath(src), dst)
    if input_dim is None:
        input_dim = int(config['preprocess_conf'].get('n_mels', 80))
    with open(os.path.join(out_dir, 'inference.json'), 'w',
              encoding='utf-8') as f:
        json.dump({'use_model': config['use_model'],
                   'streaming': config.get('streaming', True),
                   'input_dim': input_dim,
                   'vocab_size': vocab_size,
                   'encoder_conf': dict(config.get('encoder_conf') or {}),
                   'decoder_conf': dict(config.get('decoder_conf') or {}),
                   'model_conf': dict(config.get('model_conf') or {})},
                  f, indent=2)
    return out_dir
