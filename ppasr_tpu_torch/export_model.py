"""Export a checkpoint as an inference artifact (counterpart of the
repository's export_model.py):

    python -m ppasr_tpu_torch.export_model --configs configs/conformer.yml \
        --save_model_path models/ [--resume_model models/<name>/best_model]

Writes ``<save_model_path>/<name>/infer`` (``PPASRTrainer.export``), which
``PPASRPredictor(model_path=...)`` of either package loads; with
``--save_quant True`` also the int8 ``model_quant.msgpack``, with
``--save_stablehlo True`` the ``torch.export`` programs that
``infer_utils.inference_predictor.InferencePredictor`` serves. Runs on
``cuda:0`` unless ``--use_gpu False``.
"""
import argparse
import functools

from ppasr_tpu_torch.utils.common import add_arguments, print_arguments


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg('configs', str, 'configs/conformer.yml', 'config file path')
    add_arg('use_gpu', bool, True, 'load the model on cuda:0 (False: the '
            'CPU)')
    add_arg('save_model_path', str, 'models/', 'checkpoint root dir')
    add_arg('resume_model', str, None,
            'checkpoint dir (default: last_model)')
    add_arg('save_quant', bool, False,
            'also write model_quant.msgpack, the int8 weights')
    add_arg('save_stablehlo', bool, False,
            'also write the offline and chunk programs (torch.export: '
            'offline.pt2, chunk.pt2; *.cuda.pt2 on the card)')
    add_arg('overwrites', str, None, 'config overrides')
    return parser.parse_args(argv)


def main(argv=None):
    """→ the exported directory."""
    args = parse_args(argv)
    print_arguments(args=args)
    from ppasr_tpu_torch.trainer import PPASRTrainer
    trainer = PPASRTrainer(configs=args.configs, use_gpu=args.use_gpu,
                           overwrites=args.overwrites)
    return trainer.export(save_model_path=args.save_model_path,
                          resume_model=args.resume_model,
                          save_quant=args.save_quant,
                          save_stablehlo=args.save_stablehlo)


if __name__ == '__main__':
    main()
