"""The port's CLI, ``python -m ppasr_tpu_torch.infer_path``, on the tiny
artifact of tests/torch_tiny_artifact.py and a WAV file, on the CPU: its
offline and simulated-streaming texts equal the JAX predictor's on the same
file and config, with greedy decoding and with ``--decoder
ctc_beam_search`` (configs/conformer.yml's beam conf: beam 300 and a .klm
LM that is absent, so both decode without an LM, and the port names the
file in a warning) and with ``--decoder attention_rescoring``;
``--is_long_audio``, ``--use_pun`` and ``--is_itn`` give the JAX
predictor's texts; ``strtobool`` parses ``bool`` options as
``distutils.util.strtobool`` did."""
import os
import sys

import numpy as np
import pytest

from ppasr_tpu.data.audio import AudioSegment as JaxSegment
from ppasr_tpu.predict import PPASRPredictor as JaxPredictor
from ppasr_tpu_torch import infer_path
from ppasr_tpu_torch.decoders import beam_search_torch
from ppasr_tpu_torch.utils.common import strtobool

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_tiny_artifact import speechlike, write_artifact  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, 'configs', 'conformer.yml')


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    out = tmp_path_factory.mktemp('cli')
    artifact = write_artifact(out)
    wav = str(out / 'utt.wav')
    JaxSegment(speechlike(int(2.6 * 16000), 21), 16000).to_wav_file(wav)
    args = ['--configs', CONFIG, '--model_path', artifact, '--wav_path', wav,
            '--decoder', 'ctc_greedy', '--use_gpu', 'False']
    jax_pred = JaxPredictor(configs=CONFIG, model_path=artifact,
                            decoder='ctc_greedy')
    return args, wav, jax_pred


def test_offline_text_matches_jax(setup):
    args, wav, jax_pred = setup
    got = infer_path.main(args)
    assert got['text'] == jax_pred.predict(wav)['text']
    assert len(got['text']) > 5


def test_real_time_demo_matches_jax(setup):
    args, wav, jax_pred = setup
    got = infer_path.main(args + ['--real_time_demo', 'True'])
    samples = JaxSegment.from_file(wav).samples
    jax_pred.reset_stream()
    for i in range(0, len(samples), 8000):
        want = jax_pred.predict_stream(samples[i:i + 8000],
                                       is_end=i + 8000 >= len(samples))
    assert got['text'] == want['text'] and len(want['text']) > 5


def test_beam_search_cli_matches_jax(setup, monkeypatch):
    args, wav, _ = setup
    said = []
    monkeypatch.setattr(beam_search_torch.logger, 'warning', said.append)
    beam_args = [a if a != 'ctc_greedy' else 'ctc_beam_search' for a in args]
    got = infer_path.main(beam_args)
    jax_pred = JaxPredictor(configs=CONFIG, model_path=args[3],
                            decoder='ctc_beam_search')
    want = jax_pred.predict(wav)
    assert got['text'] == want['text'] and len(want['text']) > 5
    np.testing.assert_allclose(got['score'], want['score'], rtol=1e-5,
                               atol=1e-4)
    assert said and 'zh_giga.no_cna_cmn.prune01244.klm' in said[0]


@pytest.mark.parametrize('option', ['is_long_audio', 'use_pun', 'is_itn'])
def test_unported_options_raise(setup, option):
    """The three options that raised until they were ported: each now runs
    and gives the text the JAX predictor gives with it."""
    args, wav, jax_pred = setup
    got = infer_path.main(args + [f'--{option}', 'true'])
    if option == 'is_long_audio':
        want = jax_pred.predict_long(wav)
    else:
        want = jax_pred.predict(wav, **{option: True})
    assert got['text'] == want['text'] and len(want['text']) > 5


def test_rescoring_cli_matches_jax(setup, tmp_path):
    """configs/conformer.yml with its beam cut from 300 to 16 and the
    hypotheses to 64 tokens, which keeps the CPU run short."""
    args, wav, _ = setup
    with open(CONFIG, encoding='utf-8') as f:
        text = f.read()
    assert 'beam_size: 300' in text
    config = tmp_path / 'conformer_beam16.yml'
    config.write_text(text.replace(
        'beam_size: 300', 'beam_size: 16\n  max_hyp_len: 64'),
        encoding='utf-8')
    rescore_args = [str(config) if a == CONFIG else
                    'attention_rescoring' if a == 'ctc_greedy' else a
                    for a in args]
    got = infer_path.main(rescore_args + ['--is_long_audio', 'true',
                                          '--use_pun', 'true'])
    jax_pred = JaxPredictor(configs=str(config), model_path=args[3],
                            decoder='attention_rescoring')
    want = jax_pred.predict_long(wav, use_pun=True)
    assert got['text'] == want['text'] and len(want['text']) > 5
    np.testing.assert_allclose(got['score'], want['score'], rtol=1e-5,
                               atol=1e-4)


def test_strtobool():
    for word in ('y', 'YES', 't', 'True', 'on', '1'):
        assert strtobool(word) is True
    for word in ('n', 'No', 'f', 'FALSE', 'off', '0'):
        assert strtobool(word) is False
    with pytest.raises(ValueError):
        strtobool('maybe')
