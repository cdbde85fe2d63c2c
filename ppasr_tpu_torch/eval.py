"""Evaluate a checkpoint on the test manifest (counterpart of the
repository's eval.py):

    python -m ppasr_tpu_torch.eval --configs configs/conformer.yml \
        --resume_model models/conformer_streaming_fbank/best_model \
        [--streaming_eval True] [--overwrites "decoder=ctc_greedy"]

Decodes with the config's ``decoder`` (greedy, the beam search or
attention rescoring) and prints the loss and the error rate
(``PPASRTrainer.evaluate``). Runs on ``cuda:0`` unless ``--use_gpu
False``; without a card the default raises.
"""
import argparse
import functools
import time

from ppasr_tpu_torch.utils.common import add_arguments, print_arguments
from ppasr_tpu_torch.utils.logger import setup_logger

logger = setup_logger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg('configs', str, 'configs/conformer.yml', 'config file path')
    add_arg('use_gpu', bool, True, 'run on cuda:0 (False: the CPU)')
    add_arg('resume_model', str, 'models/', 'checkpoint dir to evaluate')
    add_arg('display_result', bool, False, 'print per-utterance results')
    add_arg('streaming_eval', bool, False,
            'encode through the chunked-streaming path (live-session CER)')
    add_arg('overwrites', str, None, 'config overrides')
    return parser.parse_args(argv)


def main(argv=None):
    """→ (trainer, error rate, loss); the trainer's ``eval_results`` hold
    each utterance's text."""
    args = parse_args(argv)
    print_arguments(args=args)
    from ppasr_tpu_torch.trainer import PPASRTrainer
    trainer = PPASRTrainer(configs=args.configs, use_gpu=args.use_gpu,
                           overwrites=args.overwrites)
    start = time.time()
    error_rate, loss = trainer.evaluate(resume_model=args.resume_model,
                                        display_result=args.display_result,
                                        streaming_eval=args.streaming_eval)
    metrics_type = trainer.configs.get('metrics_type', 'cer')
    logger.info(f"eval done in {time.time() - start:.2f}s: loss={loss:.5f} "
                f"{metrics_type}={error_rate:.5f}")
    return trainer, error_rate, loss


if __name__ == '__main__':
    main()
