"""Pre-compute the host features of the manifests (counterpart of the
repository's extract_features.py):

    python -m ppasr_tpu_torch.extract_features \
        --configs configs/conformer.yml [--save_dir dataset/features] \
        [--splits test]

Writes pooled ``.npy`` files under ``save_dir`` and a ``manifest_features``
list beside each manifest, which evaluation then reads
(``PPASRTrainer.extract_features``). Host work only: no card is needed.
"""
import argparse
import functools

from ppasr_tpu_torch.utils.common import add_arguments, print_arguments


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg('configs', str, 'configs/conformer.yml', 'config file path')
    add_arg('save_dir', str, 'dataset/features', 'feature output dir')
    add_arg('splits', str, 'train,test',
            "which manifests to process, e.g. 'test'")
    add_arg('overwrites', str, None, 'config overrides')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    print_arguments(args=args)
    from ppasr_tpu_torch.trainer import PPASRTrainer
    trainer = PPASRTrainer(configs=args.configs, use_gpu=False,
                           overwrites=args.overwrites)
    trainer.extract_features(save_dir=args.save_dir,
                             splits=tuple(args.splits.split(',')))
    return trainer


if __name__ == '__main__':
    main()
