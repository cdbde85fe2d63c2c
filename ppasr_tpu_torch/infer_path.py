"""Recognize an audio file: offline, long-audio (VAD-segmented) or as a
simulated stream (counterpart of the repository's infer_path.py):

    python -m ppasr_tpu_torch.infer_path --wav_path a.wav \
        --model_path <exported dir> [--real_time_demo True] \
        [--is_long_audio True] [--use_pun True] [--is_itn True]

Runs on ``cuda:0`` unless ``--use_gpu False``. The decoder is the config's
(``decoder``; beam search for configs/conformer.yml, configured by its
``ctc_beam_search_decoder_conf``) unless ``--decoder`` names
``ctc_greedy``, ``ctc_beam_search`` or ``attention_rescoring``.
"""
import argparse
import functools
import time

from ppasr_tpu_torch.data.audio import AudioSegment
from ppasr_tpu_torch.predict import PPASRPredictor
from ppasr_tpu_torch.utils.common import add_arguments, print_arguments
from ppasr_tpu_torch.utils.logger import setup_logger

logger = setup_logger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg('configs', str, 'configs/conformer.yml', 'config file path')
    add_arg('wav_path', str, 'dataset/test.wav', 'audio file to recognize')
    add_arg('model_path', str,
            'models/conformer_streaming_fbank/infer/', 'exported model dir')
    add_arg('decoder', str, None,
            'ctc_greedy, ctc_beam_search or attention_rescoring (default: '
            'the config\'s)')
    add_arg('is_long_audio', bool, False, 'use VAD-segmented long-audio mode')
    add_arg('real_time_demo', bool, False, 'simulate streaming recognition')
    add_arg('use_gpu', bool, True, 'run on cuda:0 (False: the CPU)')
    add_arg('use_pun', bool, False, 'restore punctuation')
    add_arg('is_itn', bool, False, 'inverse text normalization')
    add_arg('use_device_frontend', bool, False,
            'featurize on the card (streaming windows + offline batches)')
    return parser.parse_args(argv)


def predict_audio(predictor, wav_path, use_pun=False, is_itn=False):
    start = time.time()
    result = predictor.predict(wav_path, use_pun=use_pun, is_itn=is_itn)
    logger.info(f"time: {int((time.time() - start) * 1000)}ms, "
                f"score: {result['score']:.2f}, text: {result['text']}")
    return result


def predict_long_audio(predictor, wav_path, use_pun=False, is_itn=False):
    start = time.time()
    result = predictor.predict_long(wav_path, use_pun=use_pun, is_itn=is_itn)
    logger.info(f"long audio time: {int((time.time() - start) * 1000)}ms, "
                f"score: {result['score']:.2f}, text: {result['text']}")
    return result


def real_time_predict_demo(predictor, wav_path, use_pun=False,
                           is_itn=False):
    """Feed the file in 0.5 s pieces as a live stream would."""
    audio = AudioSegment.from_file(wav_path)
    samples = audio.samples
    sr = audio.sample_rate
    chunk = int(0.5 * sr)
    result = None
    for i in range(0, len(samples), chunk):
        is_end = i + chunk >= len(samples)
        start = time.time()
        result = predictor.predict_stream(samples[i:i + chunk],
                                          is_end=is_end, use_pun=use_pun,
                                          is_itn=is_itn, sample_rate=sr)
        logger.info(f"[{i / sr:5.1f}s] {int((time.time() - start) * 1000)}ms"
                    f" → {result['text']}")
    predictor.reset_stream()
    return result


def main(argv=None):
    args = parse_args(argv)
    print_arguments(args=args)
    predictor = PPASRPredictor(configs=args.configs,
                               model_path=args.model_path,
                               use_gpu=args.use_gpu, decoder=args.decoder,
                               use_pun=args.use_pun,
                               use_device_frontend=args.use_device_frontend)
    text_opts = dict(use_pun=args.use_pun, is_itn=args.is_itn)
    if args.real_time_demo:
        return real_time_predict_demo(predictor, args.wav_path, **text_opts)
    if args.is_long_audio:
        return predict_long_audio(predictor, args.wav_path, **text_opts)
    return predict_audio(predictor, args.wav_path, **text_opts)


if __name__ == "__main__":
    main()
