"""Train a model (counterpart of the repository's train.py):

    python -m ppasr_tpu_torch.train --configs configs/campaign/conformer_synth.yml \
        [--use_gpu False] [--augment_conf_path configs/augmentation.json] \
        [--overwrites "dataset_conf.batch_size=8,train_conf.max_epoch=2"]

Runs on ``cuda:0`` unless ``--use_gpu False``; without a card the default
raises. On N cards, one process each (``batch_size`` is a rank's):

    torchrun --nproc_per_node=N -m ppasr_tpu_torch.train --configs ...

(NCCL; gloo where N exceeds the cards, and N gloo processes on the CPU
with ``--use_gpu False``). ``kill -USR1 <pid>`` dumps every thread's stack
to stderr.
"""
import argparse
import faulthandler
import functools
import signal

from ppasr_tpu_torch.utils.common import add_arguments, print_arguments


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg('configs', str, 'configs/conformer.yml', 'config file path')
    add_arg('use_gpu', bool, True, 'train on cuda:0 (False: the CPU)')
    add_arg('save_model_path', str, 'models/', 'where to save checkpoints')
    add_arg('log_dir', str, 'log/', 'tensorboard scalars and the '
            'profile_steps trace')
    add_arg('resume_model', str, None, 'checkpoint dir to resume from')
    add_arg('pretrained_model', str, None, 'pretrained weights to warm-start')
    add_arg('augment_conf_path', str, 'configs/augmentation.json',
            'augmentation pipeline JSON')
    add_arg('overwrites', str, None,
            'config overrides, e.g. "train_conf.max_epoch=100"')
    return parser.parse_args(argv)


def main(argv=None):
    faulthandler.register(signal.SIGUSR1)
    args = parse_args(argv)
    print_arguments(args=args)
    import torch.distributed as dist

    from ppasr_tpu_torch.trainer import PPASRTrainer
    trainer = PPASRTrainer(configs=args.configs, use_gpu=args.use_gpu,
                           overwrites=args.overwrites,
                           data_augment_configs=args.augment_conf_path)
    try:
        return trainer.train(save_model_path=args.save_model_path,
                             log_dir=args.log_dir,
                             resume_model=args.resume_model,
                             pretrained_model=args.pretrained_model)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == '__main__':
    main()
