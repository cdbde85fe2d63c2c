"""The system under test, built through its public entry point: a
``PPASRPredictor`` over an exported model directory, with the run's seeded
weights and CMVN put in its model on the device.

The directory (``inference.json``, ``vocabulary.txt``, ``mean_istd.json``
and a ``model.msgpack`` of the model's default initialisation) is written
once per checkout under ``build/benchmark/artifacts/<config>/``, a fixed
path, and reused by every later run there. The vocabulary is ``<blank>``,
``<unk>``, ``vocab_size`` − 3 CJK characters and ``<eos>``."""
import json
import os
from pathlib import Path

import torch

from harness import weights
from harness.spec import ROOT, reference_module

ARTIFACTS = ROOT / 'build' / 'benchmark' / 'artifacts'


def write_artifact(conf: dict) -> Path:
    out = ARTIFACTS / conf['name']
    if (out / 'model.msgpack').exists():
        return out
    from ppasr_tpu_torch.models.factory import build_model
    from ppasr_tpu_torch.utils.checkpoint import export_params, save_msgpack
    out.mkdir(parents=True, exist_ok=True)
    vocab = ['<blank>', '<unk>'] + [chr(0x4E00 + i) for i in
                                    range(conf['vocab_size'] - 3)] + ['<eos>']
    (out / 'vocabulary.txt').write_text(
        ''.join(f'{v}\t-1\n' for v in vocab), encoding='utf-8')
    n = conf['input_dim']
    (out / 'mean_istd.json').write_text(json.dumps(
        {'mean': [0.0] * n, 'istd': [1.0] * n}), encoding='utf-8')
    model_keys = ('use_model', 'streaming', 'input_dim', 'vocab_size',
                  'encoder_conf', 'decoder_conf', 'model_conf')
    (out / 'inference.json').write_text(json.dumps(
        {k: conf[k] for k in model_keys}, indent=2), encoding='utf-8')
    model = build_model(conf['use_model'], n, conf['vocab_size'],
                        conf['streaming'], conf['encoder_conf'],
                        conf['decoder_conf'], conf['model_conf'])
    tmp = out / f'model.msgpack.{os.getpid()}.tmp'
    save_msgpack(str(tmp), export_params(model))
    # written back now, in set-up, not by the kernel during the window
    with open(tmp, 'rb') as f:
        os.fsync(f.fileno())
    os.replace(tmp, out / 'model.msgpack')
    return out


def reference_weights(conf: dict, seed: int, device):
    """(weights {name: tensor}, (cmvn mean, cmvn istd)) of the run."""
    shapes = reference_module(conf['family']).param_shapes(conf)
    return (weights.make_weights(shapes, seed, device),
            weights.make_cmvn(conf['input_dim'], seed, device))


def build_predictor(conf: dict, seed: int, device='cuda', **kwargs):
    """The predictor over the checkout's artifact, with the seed's weights
    (the encoder and the CTC head; the attention decoder, which no
    inference path here runs, keeps the artifact's) → (predictor,
    weights, cmvn)."""
    from ppasr_tpu_torch.predict import PPASRPredictor
    pred = PPASRPredictor(model_path=str(write_artifact(conf)),
                          use_gpu=torch.device(device).type == 'cuda',
                          compute_dtype=conf['compute_dtype'],
                          decoder='ctc_greedy', **kwargs)
    W, cmvn = reference_weights(conf, seed, pred.device)
    with torch.no_grad():
        missing, unexpected = pred.model.load_state_dict(W, strict=False)
        if unexpected or any(not k.startswith('decoder.') for k in missing):
            raise RuntimeError(f"weights do not match the model: missing "
                               f"{missing}, unexpected {unexpected}")
        pred.model.encoder.global_cmvn.mean.copy_(cmvn[0])
        pred.model.encoder.global_cmvn.istd.copy_(cmvn[1])
    return pred, W, cmvn
