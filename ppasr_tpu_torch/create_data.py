"""Create the manifests, the vocabulary and the CMVN statistics
(counterpart of the repository's create_data.py):

    python -m ppasr_tpu_torch.create_data --configs configs/conformer.yml \
        --annotation_path dataset/annotation/ [--num_samples 5000]

Reads the annotation directory's ``path\ttext`` lists and writes the
config's ``train_manifest``, ``test_manifest``, ``dataset_vocab`` and
``mean_istd_path`` (``PPASRTrainer.create_data``). Host work only: no card
is needed.
"""
import argparse
import functools

from ppasr_tpu_torch.utils.common import add_arguments, print_arguments


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg('configs', str, 'configs/conformer.yml', 'config file path')
    add_arg('annotation_path', str, 'dataset/annotation/',
            'annotation dir (tab-separated path\\ttext files)')
    add_arg('noise_dir', str, 'dataset/audio/noise', 'noise wav dir')
    add_arg('num_samples', int, 5000, 'utterances for CMVN stats (-1 = all)')
    add_arg('count_threshold', int, 2, 'min char count for the vocab')
    add_arg('is_change_frame_rate', bool, True,
            'resample audio to target rate')
    add_arg('max_test_manifest', int, 10000, 'max test manifest entries')
    add_arg('only_keep_zh_en', bool, True, 'filter text to zh chars + ascii')
    add_arg('overwrites', str, None, 'config overrides')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    print_arguments(args=args)
    from ppasr_tpu_torch.trainer import PPASRTrainer
    trainer = PPASRTrainer(configs=args.configs, use_gpu=False,
                           overwrites=args.overwrites)
    trainer.create_data(annotation_path=args.annotation_path,
                        noise_dir=args.noise_dir,
                        num_samples=args.num_samples,
                        count_threshold=args.count_threshold,
                        is_change_frame_rate=args.is_change_frame_rate,
                        max_test_manifest=args.max_test_manifest,
                        only_keep_zh_en=args.only_keep_zh_en)
    return trainer


if __name__ == '__main__':
    main()
