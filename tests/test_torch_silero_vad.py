"""Port parity of the voice activity detector on the CPU: Silero VAD v3
(ppasr_tpu/infer_utils/silero_jax.py against ppasr_tpu_torch/infer_utils/
silero.py, both from the committed ppasr_tpu/assets/silero_vad_v3.npz) and
``VADPredictor`` (ppasr_tpu/infer_utils/vad_predictor.py against the
port's), on signals made from a numpy seed.

Tolerances: speech probabilities and the LSTM's h within 1e-5 absolute
(float32, sums in other orders through the STFT conv and 2 × 64 LSTM
steps), its unbounded cell state c within 1e-5 absolute plus 1e-5
relative; speech timestamps and stream events exact. The ONNX-to-``nn.LSTM``
gate reordering is pinned on its own against a numpy ONNX cell."""
import os
import sys

import numpy as np
import pytest
import torch

from ppasr_tpu.infer_utils import silero_jax
from ppasr_tpu.infer_utils import vad_predictor as jax_vad
from ppasr_tpu_torch.infer_utils import silero
from ppasr_tpu_torch.infer_utils import vad_predictor as port_vad

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_tiny_artifact import speechlike  # noqa: E402

NPZ = port_vad.packaged_silero_path()
TOL = 1e-5


def recording(seed, seconds=(1.2, 2.0, 0.9), gap=0.6):
    """float PCM in [-1, 1]: speech-like stretches between quiet noise."""
    rng = np.random.default_rng(seed)
    parts = []
    for i, s in enumerate(seconds):
        parts.append((rng.standard_normal(int(gap * 16000)) * 30)
                     .astype(np.int16))
        parts.append(speechlike(int(s * 16000), seed * 10 + i))
    parts.append((rng.standard_normal(8000) * 30).astype(np.int16))
    return np.concatenate(parts).astype(np.float32) / 32768


def _onnx_lstm_step(w, r, b, x, h, c):
    """One ONNX LSTM step, gates in i, o, f, c order, in numpy."""
    def sig(v):
        return 1 / (1 + np.exp(-v))
    hid = r.shape[1]
    g = x @ w.T + h @ r.T + b[:4 * hid] + b[4 * hid:]
    i, o, f, cc = np.split(g, 4, axis=-1)
    c = sig(f) * c + sig(i) * np.tanh(cc)
    return sig(o) * np.tanh(c), c


def test_lstm_gate_reordering():
    rng = np.random.default_rng(0)
    hid, n_in = 5, 3
    w = rng.normal(size=(4 * hid, n_in)).astype(np.float32)
    r = rng.normal(size=(4 * hid, hid)).astype(np.float32)
    b = rng.normal(size=(8 * hid,)).astype(np.float32)
    ih, hh, b_ih, b_hh = silero.lstm_from_onnx(w, r, b)
    # ONNX blocks i, o, f, c land at nn.LSTM's i, f, g, o places
    for onnx_k, torch_k in ((0, 0), (1, 3), (2, 1), (3, 2)):
        np.testing.assert_array_equal(ih[torch_k * hid:(torch_k + 1) * hid],
                                      w[onnx_k * hid:(onnx_k + 1) * hid])
        np.testing.assert_array_equal(b_hh[torch_k * hid:(torch_k + 1) * hid],
                                      b[(4 + onnx_k) * hid:
                                        (5 + onnx_k) * hid])
    lstm = torch.nn.LSTM(n_in, hid)
    with torch.no_grad():
        for name, val in (('weight_ih_l0', ih), ('weight_hh_l0', hh),
                          ('bias_ih_l0', b_ih), ('bias_hh_l0', b_hh)):
            getattr(lstm, name).copy_(torch.from_numpy(val))
    x = rng.normal(size=(4, 1, n_in)).astype(np.float32)
    h = np.zeros((1, hid), np.float32)
    c = np.zeros((1, hid), np.float32)
    want = []
    for t in range(4):
        h, c = _onnx_lstm_step(w, r, b, x[t], h, c)
        want.append(h)
    with torch.no_grad():
        got, (hn, cn) = lstm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy()[:, 0], np.concatenate(want),
                               atol=1e-6)
    np.testing.assert_allclose(cn.numpy()[0], c, atol=1e-6)


@pytest.mark.parametrize('sample_rate,window', [(16000, 512), (16000, 1536),
                                                (8000, 256)])
def test_score_windows_match_jax(sample_rate, window):
    params, config = silero_jax.load_params(NPZ, sample_rate)
    net = silero.SileroNet(*silero.load_branch(NPZ, sample_rate)).eval()
    wav = recording(1)[:window * 12].reshape(12, window)
    h = np.zeros((2, 1, 64), np.float32)
    c = np.zeros((2, 1, 64), np.float32)
    jh, jc, th, tc = h, c, torch.from_numpy(h), torch.from_numpy(c)
    for part in (wav[:5], wav[5:]):          # the state carries across
        want, jh, jc = silero_jax.score_windows(params, config, part, jh, jc)
        with torch.no_grad():
            got, th, tc = net.score_windows(torch.from_numpy(part), th, tc)
        assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
        assert np.abs(th.numpy() - np.asarray(jh)).max() <= TOL
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=TOL,
                                   atol=TOL)
    assert 0.0 < float(np.asarray(want).min()) < float(
        np.asarray(want).max()) < 1.0


@pytest.mark.parametrize('seed', [1, 2])
def test_speech_timestamps_and_stream_events_match_jax(seed):
    wav = recording(seed)
    jv, pv = jax_vad.VADPredictor(), port_vad.VADPredictor(device='cpu')
    assert isinstance(pv.model, silero.SileroVAD)
    want = jv.get_speech_timestamps(wav)
    assert pv.get_speech_timestamps(wav) == want and len(want) == 3
    jv.reset_states()
    pv.reset_states()
    events = []
    for i in range(0, 40000, 4000):          # the first speech and silence
        want_ev = jv.stream_vad(wav[i:i + 4000])
        assert pv.stream_vad(wav[i:i + 4000]) == want_ev
        events += want_ev
    assert events


def test_energy_heuristic_without_weights_matches_jax(monkeypatch):
    monkeypatch.setattr(jax_vad, '_packaged_silero_path',
                        lambda: '/nonexistent/silero.npz')
    monkeypatch.setattr(port_vad, 'packaged_silero_path',
                        lambda: '/nonexistent/silero.npz')
    jv, pv = jax_vad.VADPredictor(), port_vad.VADPredictor(device='cpu')
    assert jv.model is None and pv.model is None
    wav = recording(3)
    assert pv.get_speech_timestamps(wav) == jv.get_speech_timestamps(wav)


def test_weights_that_fail_to_load_raise(tmp_path, monkeypatch):
    (tmp_path / 'silero_vad_v3.npz').write_bytes(b'not an npz')
    with pytest.raises(ValueError):
        port_vad.VADPredictor(model_dir=str(tmp_path), device='cpu')
    # the JAX package's own VADModel file, with no Silero weights, that
    # fails to load: it raises rather than falling back to the heuristic
    monkeypatch.setattr(port_vad, 'packaged_silero_path',
                        lambda: '/nonexistent/silero.npz')
    other = tmp_path / 'other'
    other.mkdir()
    (other / 'vad_model.msgpack').write_bytes(b'')
    with pytest.raises(ValueError, match='msgpack'):
        port_vad.VADPredictor(model_dir=str(other), device='cpu')
