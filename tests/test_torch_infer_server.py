"""``python -m ppasr_tpu_torch.infer_server`` (ppasr_tpu_torch/
infer_server.py) over local sockets on the CPU, with the tiny Conformer
artifact: ``POST /recognition`` (raw and multipart) and
``/recognition_long_audio`` give the texts of the port's ``predict`` and
``predict_long``, and of the JAX ``predict`` for the same upload; the
WebSocket stream gives the engine's text, also while an HTTP request runs
mid-utterance; at capacity it sends code 3; ``GET /`` serves
templates/index.html and a path out of static/ gets 403.

The two faults of the repository's infer_server.py that the port repairs
are confirmed on it and pinned: uploads saved as ``<ms>.wav`` overwrite
each other within a millisecond, and the WebSocket applies ``use_pun``
but not ``is_itn``."""
import asyncio
import http.client
import importlib.util
import io
import json
import os
import sys
import threading
import types
import wave

import numpy as np
import pytest

import torch_tiny_artifact as tiny
from ppasr_tpu.predict import PPASRPredictor as JaxPredictor
from ppasr_tpu_torch import infer_server
from ppasr_tpu_torch.predict import PPASRPredictor
from ppasr_tpu_torch.serving import StreamingBatchEngine
from torch_train_util import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIECE = 2560


def wav_bytes(pcm):
    buf = io.BytesIO()
    with wave.open(buf, 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.astype('<i2').tobytes())
    return buf.getvalue()


def args_for(tmp, **kw):
    argv = ['--configs', os.path.join(ROOT, 'configs', 'conformer.yml'),
            '--host', '127.0.0.1', '--port', '0', '--ws_port', '0',
            '--use_gpu', 'False', '--decoder', 'ctc_greedy',
            '--save_audio_dir', str(tmp)]
    for k, v in kw.items():
        argv += [f'--{k}', str(v)]
    return infer_server.parse_args(argv)


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    art = tmp_path_factory.mktemp('server_artifact')
    tiny.write_zoo_artifact(art, 'conformer')
    pred = PPASRPredictor(model_path=str(art), use_gpu=False)
    uploads = tmp_path_factory.mktemp('uploads')
    server = infer_server.RecognitionServer(
        args_for(uploads, model_path=art, max_streams=2),
        predictor=pred).start()
    pcms = [tiny.speechlike(24000 + 5000 * i, 60 + i) for i in range(2)]
    yield types.SimpleNamespace(art=art, pred=pred, server=server,
                                pcms=pcms, uploads=uploads)
    server.stop()


def post(port, path, body, ctype='audio/wav'):
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=120)
    conn.request('POST', path, body=body, headers={'Content-Type': ctype})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def get(port, path):
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=60)
    conn.request('GET', path)
    resp = conn.getresponse()
    out = resp.status, resp.read()
    conn.close()
    return out


def multipart(data):
    boundary = 'ppasrboundary'
    body = (f'--{boundary}\r\nContent-Disposition: form-data; name="audio";'
            f' filename="a.wav"\r\nContent-Type: audio/wav\r\n\r\n').encode() \
        + data + f'\r\n--{boundary}--\r\n'.encode()
    return body, f'multipart/form-data; boundary={boundary}'


async def stream(port, pcm, after_first=None):
    """Stream ``pcm`` in 0.16 s pieces, then b'end' → the last result.
    ``after_first`` runs (in a thread) once the first piece is answered."""
    import websockets
    async with websockets.connect(f'ws://127.0.0.1:{port}') as ws:
        last = None
        for i in range(0, len(pcm), PIECE):
            await ws.send(pcm[i:i + PIECE].astype('<i2').tobytes())
            last = json.loads(await ws.recv())
            if i == PIECE and after_first is not None:
                await asyncio.to_thread(after_first)
        await ws.send(b'end')
        return json.loads(await ws.recv()), last


def test_http_recognition_matches_the_predictors(setup):
    port = setup.server.http_port
    jax_pred = JaxPredictor(model_path=str(setup.art))
    for pcm in setup.pcms:
        want = setup.pred.predict(pcm)
        status, got = post(port, '/recognition', wav_bytes(pcm))
        assert status == 200 and got['code'] == 0 and got['msg'] == 'success'
        assert got['result'] == want['text'] and want['text']
        assert abs(got['score'] - want['score']) < 1e-6
        assert got['result'] == jax_pred.predict(pcm)['text']
        status, again = post(port, '/recognition', *multipart(wav_bytes(pcm)))
        assert status == 200 and again['result'] == want['text']
    long = np.concatenate([setup.pcms[0], np.zeros(8000, np.int16),
                           setup.pcms[1]])
    status, got = post(port, '/recognition_long_audio', wav_bytes(long))
    assert status == 200 and got['result'] == \
        setup.pred.predict_long(long)['text']
    assert post(port, '/recognition', b'')[1]['code'] == 1


def test_websocket_stream_matches_the_engine_with_http_mid_stream(setup):
    """One stream, and an HTTP request answered while it is mid-utterance:
    both texts right, the precision flags shared by the two threads."""
    pcm, other = setup.pcms
    engine = StreamingBatchEngine(setup.pred, max_streams=1)
    slot = engine.open_stream()
    for i in range(0, len(pcm), PIECE):
        engine.feed(slot, pcm[i:i + PIECE].astype('<i2').tobytes())
    want = engine.feed(slot, b'', is_end=True)['text']
    http_result = {}

    def http_call():
        http_result['out'] = post(setup.server.http_port, '/recognition',
                                  wav_bytes(other))

    final, _ = asyncio.run(stream(setup.server.ws_port, pcm, http_call))
    assert final == {'code': 0, 'result': want} and want
    assert http_result['out'][1]['result'] == setup.pred.predict(other)['text']


def test_websocket_at_capacity_sends_code_3(setup, tmp_path):
    server = infer_server.RecognitionServer(
        args_for(tmp_path, max_streams=1), predictor=setup.pred).start()
    try:
        import websockets

        async def two():
            url = f'ws://127.0.0.1:{server.ws_port}'
            async with websockets.connect(url) as first:
                await first.send(setup.pcms[0][:PIECE].tobytes())
                await first.recv()
                async with websockets.connect(url) as second:
                    return json.loads(await second.recv())
        assert asyncio.run(two()) == {'code': 3, 'msg': 'server at capacity'}
    finally:
        server.stop()


def test_get_serves_the_client_and_refuses_traversal(setup):
    port = setup.server.http_port
    status, body = get(port, '/')
    with open(os.path.join(ROOT, 'templates', 'index.html'), 'rb') as f:
        assert status == 200 and body == f.read()
    assert get(port, '/static/../infer_server.py')[0] == 403
    assert get(port, '/static/%2e%2e/setup.py')[0] in (403, 404)
    assert get(port, '/nothing')[0] == 404


@pytest.fixture
def jax_server(monkeypatch, tmp_path):
    """The repository's infer_server.py, imported with its arguments."""
    monkeypatch.setattr(sys, 'argv', ['infer_server.py', '--save_audio_dir',
                                      str(tmp_path / 'jax_uploads')])
    spec = importlib.util.spec_from_file_location(
        'reference_infer_server', os.path.join(ROOT, 'infer_server.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class ReadsUpload:
    """A predictor stand-in whose text is the upload it reads."""

    def predict(self, path, **_):
        with open(path, 'rb') as f:
            return {'text': f.read().decode(), 'score': 0.0}


def test_uploads_in_one_millisecond_keep_their_files(jax_server, setup,
                                                     monkeypatch, tmp_path):
    same_ms = types.SimpleNamespace(time=lambda: 1760000000.0005)
    # the reference: the second upload overwrites the first's file
    monkeypatch.setattr(jax_server, 'time', same_ms)
    jax_server.predictor = ReadsUpload()
    httpd = jax_server.ThreadingHTTPServer(('127.0.0.1', 0),
                                           jax_server.Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        for body in (b'first', b'second'):
            post(httpd.server_address[1], '/recognition', body)
    finally:
        httpd.shutdown()
        httpd.server_close()
    saved = jax_server.args.save_audio_dir
    assert os.listdir(saved) == ['1760000000000.wav']
    with open(os.path.join(saved, '1760000000000.wav'), 'rb') as f:
        assert f.read() == b'second'
    # the port: one file per upload
    monkeypatch.setattr(infer_server, 'time', same_ms)
    server = infer_server.RecognitionServer(args_for(tmp_path / 'port'),
                                            predictor=setup.pred)
    paths = [server.save_upload(body) for body in (b'first', b'second')]
    assert len(set(paths)) == 2 and all(
        os.path.basename(p).startswith('1760000000000_') for p in paths)
    assert [open(p, 'rb').read() for p in paths] == [b'first', b'second']


class FakeSocket:
    """An in-process connection: the given messages in, what is sent
    kept."""

    def __init__(self, messages):
        self.messages, self.sent = list(messages), []

    def __aiter__(self):
        return self

    async def __anext__(self):
        if not self.messages:
            raise StopAsyncIteration
        return self.messages.pop(0)

    async def send(self, text):
        self.sent.append(json.loads(text))


class SaysNumber:
    """An engine stand-in whose stream always says a number in words."""
    max_streams = 1

    def open_stream(self):
        return 0

    def close_stream(self, slot):
        pass

    def feed(self, slot, data, is_end=False):
        return {'text': '一百二十三', 'score': 0.0}


def test_websocket_applies_itn_as_http_does(jax_server, setup, tmp_path):
    # the reference: is_itn is not applied on the stream
    jax_server.args.is_itn = True
    jax_server.streaming_engine = SaysNumber()
    ws = FakeSocket([b'end'])
    asyncio.run(jax_server.ws_handler(ws))
    assert ws.sent[0] == {'code': 0, 'result': '一百二十三'}
    # the port: it is
    server = infer_server.RecognitionServer(
        args_for(tmp_path, is_itn=True), predictor=setup.pred)
    server.engine = SaysNumber()
    ws = FakeSocket([b'end'])
    asyncio.run(server.ws_handler(ws))
    assert ws.sent[0] == {'code': 0, 'result': '123'}
