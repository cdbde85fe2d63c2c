"""Training orchestration (counterpart of ppasr_tpu/trainer.py:50-932).

``PPASRTrainer(configs, use_gpu=True, overwrites=None,
data_augment_configs=None)``, for every family of ``models/factory``
(DeepSpeech2's loss is CTC alone: its ``loss_att`` and ``th_accuracy``
read 0 in the step's metrics, as in the JAX train step):

- ``create_data`` (:88-128): the annotation directory's manifests
  (``data/manifest.create_manifest``), the noise manifest, the vocabulary
  (``<blank>``, ``<unk>``, the tokens seen at least ``count_threshold``
  times by (−count, token), ``<eos>``), ``mean_istd.json``
  (``data/normalizer``) and, for ``manifest_type: 'binary'``, the binary
  stores; ``extract_features`` (:130-181): host features pooled into
  ``.npy`` files flushed every 600 s of audio, and ``manifest_features``
  lists that ``evaluate`` then reads.
- ``train`` (:356-638): sortagrad batches of ``batch_size · accum_grad``
  utterances, each reshaped to [accum_grad, micro] and skipped when micro
  is 0; one optimizer update per batch (``train_state.make_train_step``);
  with ``train_conf.device_frontend`` the loader yields int16 waveforms
  and fbank with dither, SpecAugment and SpecSub run on the device
  (``ops/frontend``), else host features with the host feature stages
  (``data/augmentor/feature_augmentors``); ``enable_amp`` computes in bf16
  over float32 parameters; per-interval loss, lr and audio-s/s logs; a
  per-epoch ``evaluate`` on the test set and on the train-subset probe
  (``train_probe_size``, txt manifests); checkpoints ``epoch_N``,
  ``last_model`` and ``best_model`` with rolling deletion; resume from
  ``last_model``; ``train_conf.profile_steps: [start, stop]``, one
  ``torch.profiler`` trace (CPU and, on a card, CUDA activity, with the
  train step's ``utils/trace`` spans) into ``<log_dir>/profile``; the
  scalars ``Train/Loss``, ``Train/lr``, ``Train/<metric>``,
  ``Test/<metric>`` and ``Test/Loss`` through tensorboardX or
  ``torch.utils.tensorboard`` when one imports (else one warning). The
  eval decoder is built before the first step.
- ``evaluate`` (:710-870) → (error rate, mean loss), with the decoder
  that ``decoders/factory`` builds (:640-692): greedy; ``ctc_beam_search`` with
  ``backend`` ``'torch'`` (alias ``'jax'``, the default; from the CTC
  logits), ``'host'`` or ``'native'`` (an existing ``.klm`` goes to
  native); ``attention_rescoring`` (``rescore_ctc_weight`` and
  ``max_hyp_len`` from the beam conf). ``streaming_eval`` encodes through
  ``models/streaming_eval``: the argmax per window for greedy, else the
  posteriors then the beam (rescoring decodes greedy there, as in JAX).
  The loss is the full-context one. Each call's per-utterance text,
  score and reference are kept in ``eval_results``.
- ``export`` (:874-932): ``infer/`` with ``model.msgpack``,
  ``inference.json``, ``mean_istd.json`` and the vocabulary, which both
  packages' predictors load; with ``save_quant`` the int8
  ``model_quant.msgpack``, with ``save_stablehlo`` the ``torch.export``
  programs that ``infer_utils/inference_predictor`` serves.
- Checkpoints hold ``model.msgpack``, the flax tree that both packages
  read (``utils/checkpoint.export_params``), ``model.state`` and, unlike
  the JAX package's ``optimizer.msgpack``, the optimizer's state as
  PyTorch's own ``optimizer.pt``. ``pretrained_model`` is a shape-filtered
  partial load of any ``model.msgpack``, the JAX package's included.

The model runs on ``cuda:0`` (under torchrun, on its rank's card) unless
``use_gpu=False``; without a card ``use_gpu=True`` raises. Each update's
random streams derive from seed 1000 and the update count. No fallback: an unknown decoder, a beam decoder or
rescorer that fails to build, and rescoring with DeepSpeech2 raise, where
the JAX trainer decodes greedy; ``streaming_eval`` with DeepSpeech2
raises, as in JAX.

Multi-process data parallelism (:409-466, :598, :627): under torchrun's
environment (``torchrun --nproc_per_node=N -m ppasr_tpu_torch.train``)
``train`` starts the process group (``parallel.init_distributed``: NCCL on
the cards, gloo on the CPU or with more ranks than cards), runs on its
rank's device and wraps the model in DDP (``train_state.data_parallel``),
also with one rank. With more than one rank each takes its slice of every
world batch (``SortagradDistributedBatchSampler``, ``batch_size ·
accum_grad`` utterances a rank) padded to a target all ranks derive from
the world batch's durations and texts (1.12 × the duration under
augmentation, plus 64 samples in raw mode or 4 frames otherwise).
``dataset_conf.pad_to_max`` pads every batch to the largest such target of
the manifest. Only rank 0 writes checkpoints, the tensorboard scalars and
the ``profile_steps`` trace; every rank evaluates, and every rank reads
``last_model`` when it resumes, after a barrier. Without torchrun's
environment nothing of this starts.
"""
import json
import math
import os
import shutil
import time
from collections import Counter
from datetime import timedelta

import numpy as np
import torch

from ppasr_tpu_torch.config import load_augmentation_config, load_config
from ppasr_tpu_torch.data.dataset import ASRDataset
from ppasr_tpu_torch.data.loader import DataLoader
from ppasr_tpu_torch.data.manifest import (count_manifest, create_manifest,
                                           create_manifest_binary,
                                           create_noise, read_manifest)
from ppasr_tpu_torch.data.normalizer import FeatureNormalizer
from ppasr_tpu_torch.data.sampler import (SortagradBatchSampler,
                                          SortagradDistributedBatchSampler)
from ppasr_tpu_torch.decoders.beam_search_torch import TorchBeamSearchDecoder
from ppasr_tpu_torch.decoders.factory import build_decoder
from ppasr_tpu_torch.decoders.greedy import _collapse, greedy_decoder_batch
from ppasr_tpu_torch.decoders.rescoring import AttentionRescoringDecoder
from ppasr_tpu_torch.infer_utils.torch_export import export_programs
from ppasr_tpu_torch.models.factory import build_model
from ppasr_tpu_torch.models.streaming_eval import (streaming_encode_batch,
                                                   streaming_greedy_batch)
from ppasr_tpu_torch.parallel.distributed import barrier, init_distributed
from ppasr_tpu_torch.predict import ieee_float32
from ppasr_tpu_torch.train_state import (TrainState, create_train_state,
                                         data_parallel, fold_in,
                                         make_train_step)
from ppasr_tpu_torch.utils.checkpoint import (convert_params, export_params,
                                              load_msgpack, save_msgpack)
from ppasr_tpu_torch.utils.common import dict_to_object, labels_to_string
from ppasr_tpu_torch.utils.logger import setup_logger
from ppasr_tpu_torch.utils.metrics import cer, wer
from ppasr_tpu_torch.utils.quant import quantize_params

logger = setup_logger(__name__)

TRAIN_SEED = 1000


class PPASRTrainer:
    def __init__(self, configs, use_gpu: bool = True,
                 overwrites: str = None, data_augment_configs: str = None):
        """``configs``: YAML path or dict; ``overwrites``: comma-separated
        ``dotted.key=value`` pairs typed as the values they replace;
        ``data_augment_configs``: augmentation.json path."""
        if use_gpu and not torch.cuda.is_available():
            raise RuntimeError("use_gpu=True but torch.cuda.is_available() "
                               "is False; pass use_gpu=False for the CPU")
        self.use_gpu = use_gpu
        self.device = torch.device('cuda:0' if use_gpu else 'cpu')
        self.rank, self.world = 0, 1  # ``train`` sets them under torchrun
        self.configs = load_config(configs) if not isinstance(configs, dict) \
            else dict_to_object(configs)
        if overwrites:
            for pair in overwrites.split(','):
                key, value = pair.split('=')
                self._overwrite(key.strip(), value.strip())
        self.use_model = self.configs.use_model
        self.streaming = bool(self.configs.get('streaming', True))
        self.feature_method = self.configs.preprocess_conf.get(
            'feature_method', 'fbank')
        self.augment_conf_path = data_augment_configs
        self.model_dir_name = (f"{self.use_model}"
                               f"{'_streaming' if self.streaming else ''}"
                               f"_{self.feature_method}")
        self.stop_train = False
        self.stop_eval = False
        self.step_losses = []   # every update's loss, a 0-d device tensor
        self.eval_results = []  # the last evaluate's utterances
        self._eval_decoder_model = None
        self._eval_decoder = None

    def _overwrite(self, dotted_key, value):
        node = self.configs
        keys = dotted_key.split('.')
        for k in keys[:-1]:
            node = node[k]
        old = node.get(keys[-1])
        if isinstance(old, bool):
            value = value.lower() in ('true', '1')
        elif isinstance(old, int):
            value = int(value)
        elif isinstance(old, float):
            value = float(value)
        node[keys[-1]] = value

    # ------------------------------------------------------------ data prep

    def create_data(self, annotation_path: str = 'dataset/annotation/',
                    noise_dir: str = 'dataset/audio/noise',
                    num_samples: int = 5000, count_threshold: int = 2,
                    is_change_frame_rate: bool = True,
                    max_test_manifest: int = 10000,
                    only_keep_zh_en: bool = True):
        """Manifests → vocabulary → CMVN → binary stores (:88-128)."""
        dataset_conf = self.configs.dataset_conf
        sample_rate = self.configs.preprocess_conf.sample_rate
        create_manifest(annotation_path, dataset_conf.train_manifest,
                        dataset_conf.test_manifest,
                        is_change_frame_rate=is_change_frame_rate,
                        target_sr=sample_rate,
                        max_test_manifest=max_test_manifest,
                        only_keep_zh_en=only_keep_zh_en)
        if noise_dir and os.path.exists(noise_dir):
            create_noise(noise_dir, dataset_conf.noise_manifest_path,
                         target_sr=sample_rate)
        counter = Counter()
        count_manifest(counter, dataset_conf.train_manifest)
        tokens = [t for t, c in sorted(counter.items(),
                                       key=lambda kv: (-kv[1], kv[0]))
                  if c >= count_threshold]
        os.makedirs(os.path.dirname(dataset_conf.dataset_vocab) or '.',
                    exist_ok=True)
        with open(dataset_conf.dataset_vocab, 'w', encoding='utf-8') as f:
            f.write('<blank>\t-1\n<unk>\t-1\n')
            for t in tokens:
                f.write(f"{t}\t{counter[t]}\n")
            f.write('<eos>\t-1\n')
        logger.info(f"vocab size: {len(tokens) + 3}")
        FeatureNormalizer(dataset_conf.mean_istd_path).compute_mean_istd(
            dict(self.configs.preprocess_conf),
            read_manifest(dataset_conf.train_manifest),
            num_samples=num_samples)
        if dataset_conf.get('manifest_type') == 'binary':
            create_manifest_binary(dataset_conf.train_manifest,
                                   dataset_conf.test_manifest)
        logger.info("create_data done")

    def extract_features(self, save_dir: str = 'dataset/features',
                         splits=('train', 'test')):
        """Host features of the ``splits`` manifests, appended into one
        array per ~600 s of audio and saved as ``<save_dir>/<split>/
        <time>/<n>.npy``; the entries of ``<manifest>`` with
        ``manifest`` → ``manifest_features`` carry each utterance's
        ``start_frame``/``end_frame`` in its file (:130-181)."""
        manifests = {'train': self.configs.dataset_conf.train_manifest,
                     'test': self.configs.dataset_conf.test_manifest}
        for data_list_file in [manifests[s] for s in splits]:
            split = data_list_file.split('.')[-1]
            out_dir = os.path.join(save_dir, split, str(int(time.time())))
            os.makedirs(out_dir, exist_ok=True)
            dataset = ASRDataset(
                data_list_file, self.configs.dataset_conf.dataset_vocab,
                preprocess_conf=dict(self.configs.preprocess_conf),
                max_duration=-1, min_duration=0,
                manifest_type=self.configs.dataset_conf.get('manifest_type',
                                                            'txt'))
            save_data_list = data_list_file.replace('manifest',
                                                    'manifest_features')
            pooled, time_sum, file_idx = None, 0.0, 0
            save_path = os.path.join(out_dir, f'{file_idx}.npy')
            with open(save_data_list, 'w', encoding='utf-8') as f:
                for i in range(len(dataset)):
                    feature, _ = dataset[i]
                    entry = dataset.entry(i)
                    time_sum += entry.get('duration', 0)
                    pooled = feature if pooled is None else \
                        np.concatenate([pooled, feature], axis=0)
                    f.write(json.dumps(
                        {'audio_filepath': save_path.replace('\\', '/'),
                         'duration': entry.get('duration', 0),
                         'text': entry['text'],
                         'start_frame': pooled.shape[0] - feature.shape[0],
                         'end_frame': pooled.shape[0]},
                        ensure_ascii=False) + '\n')
                    if time_sum > 600:
                        np.save(save_path, pooled)
                        pooled, time_sum = None, 0.0
                        file_idx += 1
                        save_path = os.path.join(out_dir, f'{file_idx}.npy')
                if pooled is not None:
                    np.save(save_path, pooled)
            logger.info(f"features for [{data_list_file}] written; new list: "
                        f"[{save_data_list}]")

    # ------------------------------------------------------ model and data

    def _build_dataset(self, train: bool, return_raw: bool = False,
                       manifest_override: str = None):
        dataset_conf = self.configs.dataset_conf
        aug_conf = load_augmentation_config(self.augment_conf_path) \
            if (train and self.augment_conf_path) else None
        manifest = manifest_override or (
            dataset_conf.train_manifest if train
            else dataset_conf.test_manifest)
        if not train and manifest_override is None:
            feat_manifest = manifest.replace('manifest', 'manifest_features')
            if feat_manifest != manifest and os.path.exists(feat_manifest) \
                    and dataset_conf.get('use_precomputed_features', True):
                logger.info(f"eval uses precomputed features: "
                            f"{feat_manifest}")
                manifest = feat_manifest
        # the CMVN is in the model (GlobalCMVN from mean_istd_path): the
        # dataset yields raw features
        return ASRDataset(
            manifest, dataset_conf.dataset_vocab,
            preprocess_conf=dict(self.configs.preprocess_conf),
            min_duration=dataset_conf.get('min_duration', 0.5),
            max_duration=dataset_conf.get('max_duration', 20) if train else -1,
            manifest_type=dataset_conf.get('manifest_type', 'txt'),
            augmentation_config=aug_conf, train=train, return_raw=return_raw)

    def _build_model(self, input_dim, vocab_size, amp: bool = None):
        """The model on the trainer's device, float32 parameters; with
        ``amp`` (default: ``enable_amp``) computing in bf16 (cast at
        use)."""
        model = build_model(
            self.use_model, input_dim, vocab_size, streaming=self.streaming,
            encoder_conf=dict(self.configs.get('encoder_conf', {}) or {}),
            decoder_conf=dict(self.configs.get('decoder_conf', {}) or {}),
            model_conf=dict(self.configs.get('model_conf', {}) or {}),
            mean_istd_path=self.configs.dataset_conf.mean_istd_path)
        model.to(self.device)
        if amp is None:
            amp = self.configs.get('train_conf', {}).get('enable_amp', False)
        if amp:
            model.set_compute_dtype(torch.bfloat16, at_use=True)
        return model

    @staticmethod
    def _init_params(model, seed=TRAIN_SEED):
        return model.init_weights(torch.Generator().manual_seed(seed))

    def _create_state(self, model) -> TrainState:
        train_conf = self.configs.get('train_conf', {}) or {}
        return create_train_state(
            model, dict(self.configs.get('optimizer_conf', {}) or {}),
            grad_clip=float(train_conf.get('grad_clip', 5.0)))

    # ----------------------------------------------------------- checkpoints

    def _save_dir(self, save_model_path):
        return os.path.join(save_model_path, self.model_dir_name)

    def _save_checkpoint(self, save_model_path, state: TrainState, epoch,
                         error_rate=None, test_loss=None, best=False):
        """model.msgpack + optimizer.pt + model.state JSON; ``last_model``
        copy and rolling deletion of ``epoch_{N-3}`` (:250-280)."""
        base = self._save_dir(save_model_path)
        path = os.path.join(base, 'best_model' if best else f'epoch_{epoch}')
        os.makedirs(path, exist_ok=True)
        save_msgpack(os.path.join(path, 'model.msgpack'),
                     export_params(state.model))
        torch.save(state.optimizer.state_dict(),
                   os.path.join(path, 'optimizer.pt'))
        metric_key = 'test_cer' if self.configs.get(
            'metrics_type', 'cer') == 'cer' else 'test_wer'
        with open(os.path.join(path, 'model.state'), 'w',
                  encoding='utf-8') as f:
            json.dump({'last_epoch': epoch, metric_key: error_rate,
                       'test_loss': test_loss, 'step': int(state.step)}, f)
        if not best:
            last = os.path.join(base, 'last_model')
            shutil.rmtree(last, ignore_errors=True)
            shutil.copytree(path, last)
            shutil.rmtree(os.path.join(base, f'epoch_{epoch - 3}'),
                          ignore_errors=True)

    def _load_checkpoint(self, save_model_path, state: TrainState,
                         required: bool = False):
        """Resume from ``<save_model_path>/<model>/last_model`` or from a
        directory holding ``model.msgpack`` (:282-324). Returns the last
        epoch (0 for a fresh start); ``required`` raises when there is no
        checkpoint."""
        if os.path.exists(os.path.join(save_model_path or '',
                                       'model.msgpack')):
            last = save_model_path
        else:
            last = os.path.join(self._save_dir(save_model_path), 'last_model')
        model_path = os.path.join(last, 'model.msgpack')
        if not os.path.exists(model_path):
            if required:
                raise FileNotFoundError(
                    f"no checkpoint found at {save_model_path!r} (looked for "
                    f"{model_path}); pass the models root or a checkpoint "
                    f"dir containing model.msgpack")
            return 0
        state.model.load_state_dict(convert_params(load_msgpack(model_path)),
                                    strict=True)
        opt_path = os.path.join(last, 'optimizer.pt')
        if os.path.exists(opt_path):
            state.optimizer.load_state_dict(
                torch.load(opt_path, map_location=self.device))
        else:
            logger.warning(f"no optimizer.pt in {last}: the optimizer "
                           f"starts fresh")
        last_epoch, step = 0, 0
        state_path = os.path.join(last, 'model.state')
        if os.path.exists(state_path):
            with open(state_path, 'r', encoding='utf-8') as f:
                meta = json.load(f)
            last_epoch = meta.get('last_epoch', 0)
            step = meta.get('step', 0)
        state.step = int(step)
        logger.info(f"resumed from {last} (epoch {last_epoch})")
        return last_epoch

    def _load_pretrained(self, pretrained_model, model):
        """Shape-filtered partial load of a ``model.msgpack`` (a file or a
        directory holding one), from either package (:326-352)."""
        if not pretrained_model:
            return model
        path = pretrained_model
        if os.path.isdir(path):
            path = os.path.join(path, 'model.msgpack')
        if not os.path.exists(path):
            logger.warning(f"pretrained model missing: {path}")
            return model
        loaded = convert_params(load_msgpack(path))
        current = model.state_dict()
        keep = {k: v for k, v in loaded.items()
                if k in current and v.shape == current[k].shape}
        model.load_state_dict(keep, strict=False)
        logger.info(f"pretrained load: {len(keep)} kept, "
                    f"{len(current) - len(keep)} skipped")
        return model

    # ----------------------------------------------------------------- train

    def train(self, save_model_path: str = 'models/',
              log_dir: str = 'log/', max_epoch: int = None,
              resume_model: str = None, pretrained_model: str = None):
        """Train; returns the final ``TrainState``. ``log_dir`` receives the
        scalars and the ``profile_steps`` trace."""
        # the process group starts here, as in JAX (:409-420), so that the
        # host-only entry points never join one
        self.rank, self.world, self.device = init_distributed(self.use_gpu)
        train_conf = self.configs.train_conf
        dataset_conf = self.configs.dataset_conf
        accum_grad = int(train_conf.get('accum_grad', 1))
        batch_size = int(dataset_conf.get('batch_size', 16))
        max_epoch = max_epoch or int(train_conf.get('max_epoch', 200))
        log_interval = int(train_conf.get('log_interval', 100))
        device_frontend = bool(train_conf.get('device_frontend'))
        train_dataset = self._build_dataset(train=True,
                                            return_raw=device_frontend)
        test_dataset = self._build_dataset(train=False)
        vocab_size = train_dataset.vocab_size
        input_dim = train_dataset.feature_dim

        # the train-subset probe: an augmentation-free slice of the train
        # manifest, evenly spaced over its durations (:383-399)
        probe_dataset = None
        probe_size = int(train_conf.get('train_probe_size', 64))
        if probe_size > 0 and \
                dataset_conf.get('manifest_type', 'txt') == 'txt':
            probe_dataset = self._build_dataset(
                train=False, manifest_override=dataset_conf.train_manifest)
            stride = max(1, len(probe_dataset.manifest) // probe_size)
            probe_dataset.manifest = \
                probe_dataset.manifest[::stride][:probe_size]

        frontend = None
        if device_frontend:
            from ppasr_tpu_torch.ops.frontend import make_device_frontend
            frontend = make_device_frontend(
                dict(self.configs.preprocess_conf),
                load_augmentation_config(self.augment_conf_path)
                if self.augment_conf_path else None, train=True)

        sample_rate = int(self.configs.preprocess_conf.get('sample_rate',
                                                           16000))
        # pad targets from the manifest (:436-466), alike on every rank
        pad_margin = 1.12 if train_dataset.augmentation is not None else 1.0

        def entry_pad(i):
            e = train_dataset.entry(i)
            if device_frontend:  # raw mode pads samples, not frames
                t = int(math.ceil(float(e.get('duration', 0.0))
                                  * sample_rate * pad_margin)) + 64
            else:
                t = int(math.ceil(
                    float(e.get('duration', 0.0)) * 100.0 * pad_margin)) + 4
            return t, max(len(str(e.get('text', ''))), 1)

        def pad_hint_fn(global_indices):
            pads = [entry_pad(i) for i in global_indices]
            return max(p[0] for p in pads), max(p[1] for p in pads)

        const_pad = None
        if dataset_conf.get('pad_to_max'):
            const_pad = pad_hint_fn(range(len(train_dataset)))
            logger.info(f"pad_to_max: all batches pad to frames/labels "
                        f"{const_pad}")
        if self.world > 1:
            sampler = SortagradDistributedBatchSampler(
                len(train_dataset), batch_size * accum_grad,
                num_replicas=self.world, rank=self.rank, drop_last=True,
                pad_hint_fn=None if const_pad else pad_hint_fn)
        else:
            sampler = SortagradBatchSampler(len(train_dataset),
                                            batch_size * accum_grad,
                                            drop_last=True)
        loader = DataLoader(train_dataset, sampler,
                            num_workers=int(dataset_conf.get('num_workers',
                                                             4)),
                            time_bucket=64, label_bucket=16, pad_to=const_pad)

        model = self._build_model(input_dim, vocab_size)
        # a decoder that cannot be built raises before the first step
        self._eval_decoder_for(model, test_dataset.vocab_list)
        self._init_params(model)
        from ppasr_tpu_torch.utils.model_summary import summary
        summary(model)
        self._load_pretrained(pretrained_model, model)
        state = self._create_state(model)
        barrier()  # no rank reads a checkpoint that rank 0 still writes
        last_epoch = self._load_checkpoint(resume_model or save_model_path,
                                           state)
        if torch.distributed.is_initialized():
            unused = data_parallel(state, input_dim)
            logger.info(f"rank {self.rank} of {self.world} on {self.device}: "
                        f"DDP over {torch.distributed.get_backend()}"
                        + (f", {len(unused)} parameters outside the loss "
                           f"(find_unused_parameters)" if unused else ''))
        train_step = make_train_step(accum_grad, frontend=frontend)
        chief = self.rank == 0
        writer = _summary_writer(log_dir) if chief else None
        profile_steps = (train_conf.get('profile_steps') or None) if chief \
            else None
        profiler = None

        best_error = float('inf')
        best_state_path = os.path.join(self._save_dir(save_model_path),
                                       'best_model', 'model.state')
        if os.path.exists(best_state_path):
            with open(best_state_path, 'r', encoding='utf-8') as f:
                meta = json.load(f)
            best_error = meta.get('test_cer', meta.get('test_wer'))
            best_error = float('inf') if best_error is None else best_error

        train_times = []
        for epoch in range(last_epoch, max_epoch):
            sampler.set_epoch(epoch)
            epoch_start = batch_start = time.time()
            for batch_id, (inputs, labels, in_lens, lab_lens) in \
                    enumerate(loader):
                reader_cost = time.time() - batch_start
                micro = inputs.shape[0] // accum_grad
                if micro == 0:
                    continue
                usable = micro * accum_grad
                in_key, len_key = ('wav', 'wav_lens') if device_frontend \
                    else ('speech', 'speech_lens')
                batch = {
                    in_key: inputs[:usable].reshape(accum_grad, micro,
                                                    *inputs.shape[1:]),
                    len_key: in_lens[:usable].reshape(accum_grad, micro),
                    'text': labels[:usable].reshape(accum_grad, micro, -1),
                    'text_lens': lab_lens[:usable].reshape(accum_grad,
                                                           micro)}
                batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    self.device, non_blocking=True) for k, v in batch.items()}
                if profile_steps:
                    start, stop = (int(v) for v in profile_steps)
                    if profiler is None and start <= state.step < stop:
                        profiler = self._start_profiler()
                    elif profiler is not None and state.step >= stop:
                        self._stop_profiler(profiler, log_dir)
                        profiler, profile_steps = None, None
                metrics = train_step(state, batch,
                                     fold_in(TRAIN_SEED, state.step))
                self.step_losses.append(metrics['loss'])
                batch_cost = time.time() - batch_start
                train_times.append(batch_cost)
                if batch_id % log_interval == 0:
                    loss = float(metrics['loss'])
                    lr = state.schedule(state.step)
                    audio_sec = float(np.sum(in_lens[:usable])) / (
                        sample_rate if device_frontend else 100.0)
                    ips = audio_sec / max(batch_cost, 1e-9)
                    eta = timedelta(seconds=int(
                        np.mean(train_times) * (len(loader) - batch_id)
                        * (max_epoch - epoch)))
                    logger.info(
                        f"epoch {epoch} batch {batch_id}/{len(loader)} "
                        f"loss {loss:.4f} lr {lr:.8f} "
                        f"reader_cost {reader_cost:.3f}s "
                        f"batch_cost {batch_cost:.3f}s "
                        f"ips {ips:.2f} audio-s/s eta {eta}")
                    if writer:
                        writer.add_scalar('Train/Loss', loss, state.step)
                        writer.add_scalar('Train/lr', lr, state.step)
                    train_times = []
                if batch_id > 0 and batch_id % 10000 == 0 and chief:
                    self._save_checkpoint(save_model_path, state, epoch)
                if self.stop_train:
                    break
                batch_start = time.time()

            logger.info(f"epoch {epoch} done in "
                        f"{timedelta(seconds=int(time.time() - epoch_start))}")
            error_rate, test_loss = self.evaluate(
                model=model, test_dataset=test_dataset, sample_log_n=2)
            metric_name = self.configs.get('metrics_type', 'cer')
            logger.info(f"epoch {epoch} test {metric_name}={error_rate:.5f} "
                        f"loss={test_loss:.5f}")
            if probe_dataset is not None:
                train_err, probe_loss = self.evaluate(
                    model=model, test_dataset=probe_dataset, sample_log_n=2)
                logger.info(f"epoch {epoch} train-probe {metric_name}="
                            f"{train_err:.5f} loss={probe_loss:.5f}")
                if writer:
                    writer.add_scalar(f'Train/{metric_name}', train_err,
                                      state.step)
            if writer:
                writer.add_scalar(f'Test/{metric_name}', error_rate,
                                  state.step)
                writer.add_scalar('Test/Loss', test_loss, state.step)
            if chief:
                self._save_checkpoint(save_model_path, state, epoch + 1,
                                      error_rate, test_loss)
            if error_rate < best_error:
                best_error = error_rate
                if chief:
                    self._save_checkpoint(save_model_path, state, epoch + 1,
                                          error_rate, test_loss, best=True)
            if self.stop_train:
                break
        if profiler is not None:
            self._stop_profiler(profiler, log_dir)
        if writer:
            writer.close()
        return state

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.__enter__()
        return profiler

    @staticmethod
    def _stop_profiler(profiler, log_dir):
        profiler.__exit__(None, None, None)
        out = os.path.join(log_dir, 'profile')
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, 'trace.json')
        profiler.export_chrome_trace(path)
        logger.info(f"profiler trace written to {path}")

    # -------------------------------------------------------------- evaluate

    def _eval_decoder_for(self, model, vocab):
        """The config's decoder for ``model`` (``decoders/factory``; None
        for greedy) on the trainer's device, built once per model
        (:640-692, :781-783). Raises when it cannot be built."""
        if self._eval_decoder_model is not model:
            self._eval_decoder = build_decoder(
                self.configs.get('decoder', 'ctc_greedy'),
                self.configs.get('ctc_beam_search_decoder_conf', {}), vocab,
                model, self.use_model,
                self.configs.get('model_conf', {}), self.device)
            self._eval_decoder_model = model
        return self._eval_decoder

    def _decode(self, decoder, model, x, x_lens, inputs, in_lens, vocab,
                streaming_eval):
        """One batch's [(score, text)] through the branch of ``evaluate``
        that the decoder and ``streaming_eval`` select (:800-857)."""
        rescoring = isinstance(decoder, AttentionRescoringDecoder)
        if streaming_eval and decoder is None:
            ids, mp, olens = streaming_greedy_batch(model, inputs, in_lens)
            return [_collapse(ids[b, :int(olens[b])], mp[b, :int(olens[b])],
                              vocab) for b in range(ids.shape[0])]
        if streaming_eval:
            probs, olens = streaming_encode_batch(model, inputs, in_lens)
        elif rescoring:
            enc, probs, olens = model.encode_for_rescore(x, x_lens)
            return decoder.decode_batch_rescore(enc, probs, olens)
        elif isinstance(decoder, TorchBeamSearchDecoder):
            logits, olens = model.get_encoder_logits(x, x_lens)
            return decoder.decode_batch_from_logits(logits, olens)
        else:
            probs, olens = model.get_encoder_out(x, x_lens)
        olens = np.asarray(olens.cpu() if torch.is_tensor(olens) else olens)
        if isinstance(decoder, TorchBeamSearchDecoder):
            return decoder.decode_batch(probs, olens)
        if decoder is not None and not rescoring:
            return decoder.decode_batch(probs.float().cpu().numpy(), olens)
        return greedy_decoder_batch(probs, olens, vocab)

    def evaluate(self, resume_model: str = 'models/', model=None,
                 test_dataset=None, display_result: bool = False,
                 max_batches: int = None, sample_log_n: int = 0,
                 streaming_eval: bool = False):
        """Decode the test set with the config's decoder → (error rate, mean
        loss) (:710-870); the per-utterance {'text', 'score', 'reference',
        'error'} go to ``eval_results``. Without ``model`` the checkpoint
        at ``resume_model`` is loaded. ``streaming_eval`` encodes through
        the chunked streaming path (``models/streaming_eval``), the error
        rate a live stream would see."""
        dataset_conf = self.configs.dataset_conf
        if test_dataset is None:
            test_dataset = self._build_dataset(train=False)
        vocab = test_dataset.vocab_list
        if model is None:
            model = self._build_model(test_dataset.feature_dim,
                                      test_dataset.vocab_size)
            self._load_checkpoint(resume_model, self._create_state(model),
                                  required=True)
        if streaming_eval and self.use_model == 'deepspeech2':
            raise NotImplementedError(
                "streaming_eval drives the attention-family chunk API, as in "
                "the JAX trainer; use the predictor's predict_stream for "
                "deepspeech2 (ROADMAP, raises kept from the JAX package)")
        decoder = self._eval_decoder_for(model, vocab)
        batch_size = int(dataset_conf.get(
            'eval_batch_size', 4 * int(dataset_conf.get('batch_size', 16))))
        sampler = SortagradBatchSampler(len(test_dataset), batch_size,
                                        drop_last=False, shuffle=False)
        loader = DataLoader(test_dataset, sampler, num_workers=2,
                            shuffle_in_batch=False)
        metrics_type = self.configs.get('metrics_type', 'cer')
        error_fn = cer if metrics_type == 'cer' else wer
        was_training = model.training
        model.eval()
        self.eval_results = []
        losses = []
        try:
            with torch.no_grad(), ieee_float32():
                for i, (inputs, labels, in_lens, lab_lens) in \
                        enumerate(loader):
                    if max_batches is not None and i >= max_batches:
                        break
                    x = torch.from_numpy(inputs).to(self.device)
                    x_lens = torch.from_numpy(in_lens).to(self.device)
                    results = self._decode(decoder, model, x, x_lens, inputs,
                                           in_lens, vocab, streaming_eval)
                    out = model(x, x_lens,
                                torch.from_numpy(labels).to(self.device),
                                torch.from_numpy(lab_lens).to(self.device))
                    losses.append(float(out['loss']))
                    for b, (score, text) in enumerate(results):
                        target = labels_to_string(
                            labels[b][:int(lab_lens[b])], vocab)
                        e = error_fn(text, target)
                        if display_result or \
                                len(self.eval_results) < sample_log_n:
                            logger.info(f"ref: {target} | hyp: {text} | "
                                        f"{metrics_type}: {e:.4f}")
                        self.eval_results.append(
                            {'text': text, 'score': float(score),
                             'reference': target, 'error': e})
                    if self.stop_eval:
                        break
        finally:
            model.train(was_training)
        errors = [r['error'] for r in self.eval_results]
        error_rate = float(np.mean(errors)) if errors else float('inf')
        test_loss = float(np.mean(losses)) if losses else float('inf')
        return error_rate, test_loss

    # ---------------------------------------------------------------- export

    def export(self, save_model_path: str = 'models/',
               resume_model: str = None, save_quant: bool = False,
               save_stablehlo: bool = False):
        """Write ``<save_model_path>/<model>/infer`` from the checkpoint at
        ``resume_model`` (default: ``last_model`` under
        ``save_model_path``): ``model.msgpack`` (the flax tree, which the
        JAX predictor reads too), ``inference.json`` and copies of
        ``mean_istd.json`` and the vocabulary (:874-932). ``save_quant``
        also writes ``model_quant.msgpack``, the int8 weights of
        ``utils/quant`` (:906-912), which both packages' predictors load
        when ``model.msgpack`` is absent. ``save_stablehlo`` (the JAX
        package's name) also writes the offline and chunk programs, here
        ``torch.export``'s (``infer_utils/torch_export``: for the CPU, and
        for the card when the trainer is on it), which
        ``infer_utils/inference_predictor`` serves without model code
        (:913-918); they compute in float32, as the predictors do, where
        the JAX trainer traces them in bf16 under ``enable_amp``. Returns
        the directory."""
        test_dataset = self._build_dataset(train=False)
        # float32, as the predictors serve it, also under enable_amp
        model = self._build_model(test_dataset.feature_dim,
                                  test_dataset.vocab_size, amp=False)
        self._load_checkpoint(resume_model or save_model_path,
                              self._create_state(model), required=True)
        infer_dir = os.path.join(self._save_dir(save_model_path), 'infer')
        os.makedirs(infer_dir, exist_ok=True)
        for src in [self.configs.dataset_conf.mean_istd_path,
                    self.configs.dataset_conf.dataset_vocab]:
            if src and os.path.exists(src):
                shutil.copy(src, os.path.join(infer_dir,
                                              os.path.basename(src)))
        params = export_params(model)
        save_msgpack(os.path.join(infer_dir, 'model.msgpack'), params)
        if save_quant:
            save_msgpack(os.path.join(infer_dir, 'model_quant.msgpack'),
                         quantize_params(params))
            logger.info("int8 weight-quantized artifact written")
        if save_stablehlo:
            paths = export_programs(model, infer_dir, self.use_model,
                                    test_dataset.feature_dim)
            logger.info(f"torch.export programs written: {paths}")
        with open(os.path.join(infer_dir, 'inference.json'), 'w',
                  encoding='utf-8') as f:
            json.dump({'use_model': self.use_model,
                       'streaming': self.streaming,
                       'input_dim': test_dataset.feature_dim,
                       'vocab_size': test_dataset.vocab_size,
                       'encoder_conf': dict(self.configs.get('encoder_conf',
                                                             {}) or {}),
                       'decoder_conf': dict(self.configs.get('decoder_conf',
                                                             {}) or {}),
                       'model_conf': dict(self.configs.get('model_conf', {})
                                          or {})}, f, indent=2)
        logger.info(f"exported inference artifact to {infer_dir}")
        return infer_dir


def _summary_writer(log_dir):
    """A tensorboard ``SummaryWriter`` into ``log_dir`` from tensorboardX,
    else from ``torch.utils.tensorboard``; None, with one warning, when
    neither imports."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            logger.warning("neither tensorboardX nor tensorboard imports: "
                           "the training scalars are not written")
            return None
    return SummaryWriter(log_dir)
