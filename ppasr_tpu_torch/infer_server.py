"""Speech recognition server: HTTP endpoints and WebSocket streaming
(counterpart of the repository's infer_server.py:1-206):

    python -m ppasr_tpu_torch.infer_server --configs configs/conformer.yml \
        --model_path models/conformer_streaming_fbank/infer/

- ``GET /`` and ``/index.html`` serve templates/index.html, ``/static/...``
  the files under static/, refusing with 403 a path that leaves it;
- ``POST /recognition`` (``predict``) and ``/recognition_long_audio``
  (``predict_long``) take the audio as the raw body or as the first file
  of a multipart upload and answer ``{code, msg, result, score}``;
- the WebSocket at ``ws_port`` gives each connection a slot of one
  ``serving.StreamingBatchEngine``: binary PCM frames in, ``{code,
  result}`` out for each; ``b'end'`` ends the utterance and opens the
  next; at capacity it sends code 3 and closes.

HTTP requests run in the threads of the standard library's
``ThreadingHTTPServer``, one predictor call at a time behind
``predictor_lock``; the WebSocket side runs on an asyncio loop in a thread
of its own and feeds the engine, which holds its own lock, from worker
threads. Both run their model calls
under ``utils/precision.ieee_float32``, whose count keeps TF32 off while
either side is inside. The model runs on ``cuda:0`` unless ``--use_gpu
False``.

Differences from the reference script, each a fault of it (ROADMAP Queue
C): an upload is saved under a name of its own (``<ms>_<random>.wav``),
where the reference's ``<ms>.wav`` lets two uploads in one millisecond
overwrite each other; and the WebSocket applies ``is_itn`` as HTTP does,
where the reference applies ``use_pun`` only. Arguments are parsed in
``main(argv)``, not at import, and ``websockets`` is imported when the
stream side starts.
"""
import argparse
import asyncio
import functools
import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ppasr_tpu_torch.utils.common import add_arguments, print_arguments
from ppasr_tpu_torch.utils.logger import setup_logger

logger = setup_logger(__name__)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg('configs', str, 'configs/conformer.yml', 'config file path')
    add_arg('host', str, '0.0.0.0', 'bind address')
    add_arg('port', int, 5000, 'HTTP port (0: any free port)')
    add_arg('ws_port', int, 5001, 'WebSocket streaming port (0: any free '
            'port)')
    add_arg('model_path', str, 'models/conformer_streaming_fbank/infer/',
            'exported model dir')
    add_arg('decoder', str, None, 'ctc_greedy | ctc_beam_search | '
            'attention_rescoring')
    add_arg('use_gpu', bool, True, 'run on cuda:0 (False: the CPU)')
    add_arg('use_pun', bool, False, 'restore punctuation')
    add_arg('is_itn', bool, False, 'inverse text normalization')
    add_arg('use_device_frontend', bool, False,
            'fbank on the card (the streaming windows of predict_stream '
            'and the batches of predict_batch and predict_long)')
    add_arg('save_audio_dir', str, 'dataset/upload_audio',
            'where uploaded audio is saved')
    add_arg('max_streams', int, 16,
            'concurrent WebSocket streams (batched on one device state)')
    return parser.parse_args(argv)


def json_body(payload) -> bytes:
    return json.dumps(payload, ensure_ascii=False).encode('utf-8')


def extract_upload(body: bytes, content_type: str) -> bytes:
    """The audio of a request body: the first file part of a multipart
    upload, else the body itself (infer_server.py:61-72)."""
    if 'multipart/form-data' in content_type and b'\r\n\r\n' in body:
        boundary = content_type.split('boundary=')[-1].encode()
        for part in body.split(b'--' + boundary):
            if b'filename=' in part and b'\r\n\r\n' in part:
                return part.split(b'\r\n\r\n', 1)[1].rsplit(b'\r\n', 1)[0]
    return body


class Handler(BaseHTTPRequestHandler):
    """The HTTP side; ``self.server.app`` is the ``RecognitionServer``."""

    def log_message(self, fmt, *log_args):
        logger.info("%s " + fmt, self.address_string(), *log_args)

    def _send(self, status, body=b'', ctype=None):
        self.send_response(status)
        if ctype:
            self.send_header('Content-Type', ctype)
            self.send_header('Access-Control-Allow-Origin', '*')
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, payload, status=200):
        self._send(status, json_body(payload),
                   'application/json; charset=utf-8')

    def do_GET(self):
        """The web demo client: templates/index.html and static/."""
        if self.path in ('/', '/index.html'):
            path = os.path.join(ROOT, 'templates', 'index.html')
            ctype = 'text/html; charset=utf-8'
        elif self.path.startswith('/static/'):
            static_root = os.path.realpath(os.path.join(ROOT, 'static'))
            path = os.path.realpath(
                os.path.join(static_root, self.path[len('/static/'):]))
            if not path.startswith(static_root + os.sep):
                self._send(403)
                return
            ctype = 'application/javascript' if path.endswith('.js') \
                else 'application/octet-stream'
        else:
            self._send(404)
            return
        if not os.path.isfile(path):
            self._send(404)
            return
        with open(path, 'rb') as f:
            self._send(200, f.read(), ctype)

    def do_POST(self):
        app = self.server.app
        length = int(self.headers.get('Content-Length', 0))
        audio = extract_upload(self.rfile.read(length),
                               self.headers.get('Content-Type', ''))
        if not audio:
            self._json({'code': 1, 'msg': 'no audio data'}, 400)
            return
        if self.path.startswith('/recognition_long_audio'):
            fn = app.predictor.predict_long
        elif self.path.startswith('/recognition'):
            fn = app.predictor.predict
        else:
            self._json({'code': 1, 'msg': 'not found'}, 404)
            return
        try:
            path = app.save_upload(audio)
            with app.predictor_lock:
                result = fn(path, use_pun=app.args.use_pun,
                            is_itn=app.args.is_itn)
            self._json({'code': 0, 'msg': 'success',
                        'result': result['text'],
                        'score': float(result['score'])})
        except Exception as e:
            logger.exception("recognition failed")
            self._json({'code': 2, 'msg': str(e)}, 500)


class RecognitionServer:
    """The predictor, the engine and the two listening sides."""

    def __init__(self, args, predictor=None):
        from ppasr_tpu_torch.predict import PPASRPredictor
        from ppasr_tpu_torch.serving import StreamingBatchEngine
        self.args = args
        self.predictor = predictor or PPASRPredictor(
            configs=args.configs, model_path=args.model_path,
            use_gpu=args.use_gpu, decoder=args.decoder, use_pun=args.use_pun,
            use_device_frontend=args.use_device_frontend)
        self.predictor_lock = threading.Lock()
        self.engine = StreamingBatchEngine(
            self.predictor, max_streams=args.max_streams) \
            if self.predictor.streaming else None
        self.httpd = None
        self.http_port = self.ws_port = None
        self._loop = self._ws_thread = self._ws_stop = None

    def save_upload(self, audio: bytes) -> str:
        """Write an upload to ``save_audio_dir`` under a name no other
        upload takes → its path."""
        os.makedirs(self.args.save_audio_dir, exist_ok=True)
        fd, path = tempfile.mkstemp(
            prefix=f'{int(time.time() * 1000)}_', suffix='.wav',
            dir=self.args.save_audio_dir)
        with os.fdopen(fd, 'wb') as f:
            f.write(audio)
        return path

    def _feed(self, slot: int, message: bytes, is_end: bool) -> str:
        """One stream message through the engine → the stream's text,
        punctuated and normalized as the HTTP side's."""
        text = self.engine.feed(slot, b'' if is_end else message,
                                is_end=is_end)['text']
        if text and (self.args.use_pun or self.args.is_itn):
            with self.predictor_lock:
                text = self.predictor._result(text, 0.0, self.args.use_pun,
                                              self.args.is_itn)['text']
        return text

    async def ws_handler(self, websocket):
        """The streaming protocol (infer_server.py:147-183) for one
        connection: anything with ``async for`` over its messages and an
        ``async send``."""
        engine = self.engine
        slot = engine.open_stream()
        if slot is None:
            await websocket.send(json.dumps(
                {'code': 3, 'msg': 'server at capacity'}))
            return
        logger.info(f"websocket client connected (slot {slot})")
        try:
            async for message in websocket:
                if isinstance(message, str):
                    message = message.encode()
                is_end = message == b'end'
                # in a thread: a chunk step must not stall the other
                # connections' messages on the loop (the engine locks)
                text = await asyncio.to_thread(self._feed, slot, message,
                                               is_end)
                await websocket.send(json.dumps(
                    {'code': 0, 'result': text}, ensure_ascii=False))
                if is_end:
                    engine.close_stream(slot)
                    slot = engine.open_stream()
                    if slot is None:
                        await websocket.send(json.dumps(
                            {'code': 3, 'msg': 'server at capacity'}))
                        break
        finally:
            if slot is not None:
                engine.close_stream(slot)
            logger.info("websocket client disconnected")

    # -------------------------------------------------------------- lifecycle

    def start(self):
        """Listen: HTTP in a thread, and (for a streaming model) the
        WebSocket on an asyncio loop in another. Returns when both are
        bound."""
        self.httpd = ThreadingHTTPServer((self.args.host, self.args.port),
                                         Handler)
        self.httpd.daemon_threads = True
        self.httpd.app = self
        self.http_port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        logger.info(f"HTTP endpoints on http://{self.args.host}:"
                    f"{self.http_port} (/recognition, "
                    f"/recognition_long_audio)")
        if self.engine is not None:
            import websockets
            bound = threading.Event()
            failed = []

            def run():
                self._loop = asyncio.new_event_loop()
                asyncio.set_event_loop(self._loop)
                try:
                    self._loop.run_until_complete(self._serve_ws(
                        websockets, bound))
                except Exception as e:  # re-raised by start()
                    failed.append(e)
                    bound.set()
                finally:
                    self._loop.close()

            self._ws_thread = threading.Thread(target=run, daemon=True)
            self._ws_thread.start()
            bound.wait()
            if failed:
                self.stop()
                raise failed[0]
        return self

    async def _serve_ws(self, websockets, bound):
        self._ws_stop = asyncio.get_running_loop().create_future()
        async with websockets.serve(self.ws_handler, self.args.host,
                                    self.args.ws_port) as server:
            self.ws_port = next(iter(server.sockets)).getsockname()[1]
            logger.info(f"WebSocket streaming on ws://{self.args.host}:"
                        f"{self.ws_port}")
            bound.set()
            await self._ws_stop

    def stop(self):
        """Close both sides and join the WebSocket thread."""
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None
        if self._ws_thread is not None:
            if self._ws_stop is not None:
                self._loop.call_soon_threadsafe(self._ws_stop.set_result,
                                                None)
            self._ws_thread.join(30)
            self._ws_thread = None


def main(argv=None, block: bool = True):
    """Parse ``argv``, build the predictor and start the server; serve
    until interrupted, or with ``block=False`` return the started
    ``RecognitionServer`` (``stop()`` ends it)."""
    args = parse_args(argv)
    print_arguments(args=args)
    server = RecognitionServer(args).start()
    if not block:
        return server
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return server


if __name__ == '__main__':
    main()
