"""Grid-search the decoder's weights on the test manifest (counterpart of
the repository's tools/tune.py):

    python -m ppasr_tpu_torch.tune --configs configs/conformer.yml \
        --resume_model models/conformer_streaming_fbank/best_model \
        [--tune_target lm --num_alphas 30 --num_betas 20]
        [--tune_target rescore --num_weights 11]

``--tune_target lm`` decodes with ``ctc_beam_search`` at every (alpha,
beta) of the grid (each rounded to 2 decimals); ``rescore`` decodes with
``attention_rescoring`` at every ``rescore_ctc_weight`` (rounded to 3).
Each candidate gets a fresh ``PPASRTrainer`` and one ``evaluate``; the
lowest error rate wins, the first one on a tie. The config is read with the
port's own reader, ``--overwrites`` applied before the candidates' values.
Runs on ``cuda:0`` unless ``--use_gpu False``.
"""
import argparse
import functools
import json

import numpy as np

from ppasr_tpu_torch.utils.common import add_arguments, print_arguments


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg('configs', str, 'configs/conformer.yml', 'config file path')
    add_arg('use_gpu', bool, True, 'run on cuda:0 (False: the CPU)')
    add_arg('resume_model', str, 'models/', 'checkpoint dir to evaluate')
    add_arg('num_alphas', int, 30, 'number of alpha candidates')
    add_arg('num_betas', int, 20, 'number of beta candidates')
    add_arg('alpha_from', float, 1.0, 'alpha range start')
    add_arg('alpha_to', float, 3.2, 'alpha range end')
    add_arg('beta_from', float, 0.1, 'beta range start')
    add_arg('beta_to', float, 4.5, 'beta range end')
    add_arg('tune_target', str, 'lm', 'lm (alpha/beta) | rescore (ctc weight)')
    add_arg('num_weights', int, 11, 'rescore: number of ctc-weight candidates')
    add_arg('weight_from', float, 0.0, 'rescore: ctc-weight range start')
    add_arg('weight_to', float, 1.0, 'rescore: ctc-weight range end')
    add_arg('overwrites', str, None, 'config overrides for every candidate')
    return parser.parse_args(argv)


def _candidates(args):
    """[(decoder, {beam-conf key: value}, label)] of the search."""
    if args.tune_target == 'rescore':
        return [('attention_rescoring',
                 {'rescore_ctc_weight': round(float(w), 3)},
                 f"rescore_ctc_weight={round(float(w), 3)}")
                for w in np.linspace(args.weight_from, args.weight_to,
                                     args.num_weights)]
    if args.tune_target != 'lm':
        raise ValueError(f"unknown tune_target {args.tune_target!r}")
    if args.num_alphas < 0 or args.num_betas < 0:
        raise ValueError("num_alphas/num_betas must be non-negative")
    return [('ctc_beam_search', {'alpha': round(a, 2), 'beta': round(b, 2)},
             f"alpha={round(a, 2)} beta={round(b, 2)}")
            for a in np.linspace(args.alpha_from, args.alpha_to,
                                 args.num_alphas)
            for b in np.linspace(args.beta_from, args.beta_to,
                                 args.num_betas)]


def main(argv=None):
    """→ (best candidate's beam-conf values, its error rate, [(values,
    error rate)] of every candidate)."""
    args = parse_args(argv)
    from ppasr_tpu_torch.trainer import PPASRTrainer
    configs = json.loads(json.dumps(PPASRTrainer(
        args.configs, use_gpu=args.use_gpu,
        overwrites=args.overwrites).configs))
    print_arguments(args, configs)
    metrics_type = configs.get('metrics_type', 'cer')
    best, best_label, best_err, tried = None, None, float('inf'), []
    for decoder, values, label in _candidates(args):
        configs['decoder'] = decoder
        configs.setdefault('ctc_beam_search_decoder_conf', {})
        configs['ctc_beam_search_decoder_conf'].update(values)
        trainer = PPASRTrainer(configs=configs, use_gpu=args.use_gpu)
        err, _ = trainer.evaluate(resume_model=args.resume_model)
        tried.append((values, err))
        if err < best_err:
            best, best_label, best_err = values, label, err
        print(f"{label} {metrics_type}={err:.5f} | best: {best_label} "
              f"{metrics_type}={best_err:.5f}", flush=True)
    print(f"[FINAL] {best_label} {metrics_type}={best_err:.5f}", flush=True)
    return best, best_err, tried


if __name__ == '__main__':
    main()
