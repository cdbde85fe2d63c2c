"""A whole run of each cell, on the CPU at a tiny size, with the look for a
card skipped: sound, it comes out correct; with a fault planted in the
program underneath the timed path, ``correct`` comes out false. The faults
a cell can have: a step that returns its state unchanged, half of the
batch left out (for training, the loss's mean over the rest), a token
altered where it is produced. (One card: no exchange between chips to
leave out.)"""
import copy
import json

import pytest
import torch

import run as bench
from harness import model, spec


def tiny_cell(workload):
    cell = spec.Cell(workload)
    conf = copy.deepcopy(cell.config)
    conf['name'] = 'tiny_' + conf['name']
    conf['encoder_conf'].update(output_size=32, linear_units=64,
                                num_blocks=5)
    conf['decoder_conf'].update(linear_units=32, num_blocks=1,
                                r_num_blocks=1)
    conf['vocab_size'] = 60
    cell.config = conf
    mix = cell.traffic
    mix['trace_seconds'] = 1.0
    if mix['kind'] == 'stream':
        mix['streams'] = 3
        mix['length_s'].update(median=1.5, max=3.0)
    elif mix['kind'] == 'offline':
        mix.update(batch=8, pool_batches=2, check_batches=2)
    else:
        conf['encoder_conf']['num_blocks'] = 2
        conf['train_conf']['accum_grad'] = 2
        conf['dataset_conf']['batch_size'] = 3
        mix['length_s'].update(median=1.5, max=3.0)
    return cell


@pytest.fixture(autouse=True)
def artifacts(tmp_path, monkeypatch):
    monkeypatch.setattr(model, 'ARTIFACTS', tmp_path)
    torch.set_num_threads(2)


def state_unchanged(cls, monkeypatch):
    step = cls.get_encoder_out_chunk

    def broken(self, xs, state):
        probs, _ = step(self, xs, state)
        return probs, state
    monkeypatch.setattr(cls, 'get_encoder_out_chunk', broken)


def half_batch_stream(cls, monkeypatch):
    step = cls.get_encoder_out_chunk

    def broken(self, xs, state):
        xs = xs.clone()
        xs[xs.shape[0] // 2:] = 0
        return step(self, xs, state)
    monkeypatch.setattr(cls, 'get_encoder_out_chunk', broken)


def token_stream(cls, monkeypatch):
    step = cls.get_encoder_out_chunk

    def broken(self, xs, state):
        probs, state = step(self, xs, state)
        probs = probs.clone()
        probs[:, 0] = probs[:, 0].roll(1, dims=-1)
        return probs, state
    monkeypatch.setattr(cls, 'get_encoder_out_chunk', broken)


def half_batch_offline(cls, monkeypatch):
    encode = cls.get_encoder_out

    def broken(self, xs, lens):
        h = xs.shape[0] // 2
        if not h:
            return encode(self, xs, lens)
        probs, olens = encode(self, xs[:h], lens[:h])
        return torch.cat([probs, probs]), torch.cat([olens, olens])
    monkeypatch.setattr(cls, 'get_encoder_out', broken)


def token_offline(cls, monkeypatch):
    encode = cls.get_encoder_out

    def broken(self, xs, lens):
        probs, olens = encode(self, xs, lens)
        probs = probs.clone()
        probs[0, 0] = probs[0, 0].roll(1, dims=-1)
        return probs, olens
    monkeypatch.setattr(cls, 'get_encoder_out', broken)


def optimizer_skipped(cls, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, 'step', lambda self: None)


def half_batch_train(cls, monkeypatch):
    forward = cls.forward

    def broken(self, speech, speech_lens, text, text_lens, rngs=None):
        h = max(speech.shape[0] // 2, 1)
        return forward(self, speech[:h], speech_lens[:h], text[:h],
                       text_lens[:h], rngs)
    monkeypatch.setattr(cls, 'forward', broken)


def token_train(cls, monkeypatch):
    forward = cls.forward

    def broken(self, speech, speech_lens, text, text_lens, rngs=None):
        text = text.clone()
        text[0, 0] = (text[0, 0] + 1) % self.vocab_size
        return forward(self, speech, speech_lens, text, text_lens, rngs)
    monkeypatch.setattr(cls, 'forward', broken)


STREAM = 'conformer.stream_rt'
OFFLINE = 'efficient_conformer.offline_b64'
TRAIN = 'conformer.train_f32'


def conformer_cls():
    from ppasr_tpu_torch.models.conformer import ConformerModel
    return ConformerModel


def eff_cls():
    from ppasr_tpu_torch.models.efficient_conformer import \
        EfficientConformerModel
    return EfficientConformerModel


@pytest.mark.parametrize('workload, fault', [
    (STREAM, None), (STREAM, state_unchanged), (STREAM, half_batch_stream),
    (STREAM, token_stream), (OFFLINE, None), (OFFLINE, half_batch_offline),
    (OFFLINE, token_offline), (TRAIN, None), (TRAIN, optimizer_skipped),
    (TRAIN, half_batch_train), (TRAIN, token_train)])
def test_a_fault_makes_the_run_incorrect(workload, fault, monkeypatch):
    cell = tiny_cell(workload)
    if fault is not None:
        fault(eff_cls() if workload == OFFLINE else conformer_cls(),
              monkeypatch)
    result = bench.run_cell(cell, 2 ** 31 + 99, 3.0, 0, dev='cpu')
    print(workload, getattr(fault, '__name__', 'sound'),
          json.dumps({k: v['value'] for k, v in result['checks'].items()}))
    assert result['frames_checked'] > 0
    assert result['correct'] is (fault is None), result['checks']
    assert list(result)[-1] == 'checks'
