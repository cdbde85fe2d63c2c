"""Training frontend on the device: raw audio → fbank with dither →
SpecAugment and SpecSub (counterpart of ppasr_tpu/ops/frontend.py).

- The fbank is kernel B1's batch launch (``ops/fbank_cuda.fbank_batch``)
  with the training dither: one N(0, 1) draw per framed sample, [B, T, 400],
  from the frontend's ``torch.Generator`` (``fbank_jax``'s ``dither``,
  ppasr_tpu/ops/fbank.py:262-264).
- ``spec_augment_device`` (:84-148) is split into ``draw_spec_augment``,
  which draws each utterance's raw random integers, and
  ``apply_spec_augment``, which applies given draws to the whole batch at
  once, so a test can feed the application the integers JAX's keys give.
  Each raw draw is an integer in [0, 2**30) reduced modulo its range where
  it is used, as JAX reduces ``randint(key, (), 0, 1 << 30)``; the warp
  shift is drawn in [−w, w].
- ``make_device_frontend`` (:151-220): one Bernoulli draw per utterance
  gates SpecAugment and SpecSub together with the larger of their two
  probabilities (:205-212).

Semantics kept from the JAX package: the mask fill is the mean over the
valid region of the (warped) features unless ``replace_with_zero``; the time
warp is the identity on padding and on utterances too short to warp
(t_len − w ≤ w); the masks touch only valid frames; SpecSub reads the
features as they were before its first round; the features carry no
gradient.
"""
import torch

from ppasr_tpu_torch.ops.fbank_cuda import (WINDOW_SHIFT, WINDOW_SIZE,
                                           fbank_batch)

RAW = 1 << 30


def _raw(n, generator, device):
    return torch.randint(0, RAW, (n,), generator=generator, device=device)


def draw_spec_augment(bsz: int, generator: torch.Generator = None,
                      device=None, max_time_warp: int = 5,
                      n_freq_masks: int = 2, n_time_masks: int = 2,
                      spec_sub_num: int = 0, prob: float = 1.0) -> dict:
    """Each utterance's draws, as [B] int64 tensors (``freq``, ``time``
    [B, n, 2] width then start; ``sub`` [B, n, 3] start, length, shift) and
    the [B] bool gate ``take`` (Bernoulli ``prob``)."""
    return {
        'warp_center': _raw(bsz, generator, device),
        'warp_shift': torch.randint(-max_time_warp, max_time_warp + 1,
                                    (bsz,), generator=generator,
                                    device=device),
        'freq': _raw(bsz * n_freq_masks * 2, generator,
                     device).view(bsz, n_freq_masks, 2),
        'time': _raw(bsz * n_time_masks * 2, generator,
                     device).view(bsz, n_time_masks, 2),
        'sub': _raw(bsz * spec_sub_num * 3, generator,
                    device).view(bsz, spec_sub_num, 3),
        'take': torch.rand(bsz, generator=generator, device=device) < prob,
    }


def _time_warp_src(t_len, max_t: int, w: int, center_raw, shift):
    """[B, T] float32 source positions of the warp (ppasr_tpu/ops/
    frontend.py:37-66): stretch [0, center) over [0, warped) and
    [center, t − 1] over [warped, t); identity past t_len and where the
    utterance is too short to warp."""
    enabled = t_len - w > w
    span = torch.clamp(t_len - 2 * w, min=1)
    center = w + center_raw % span
    warped = torch.minimum(torch.clamp(center + shift, min=1), t_len - 1)
    i = torch.arange(max_t, device=t_len.device)[None, :]
    f32 = torch.float32
    left = i.to(f32) * (center.to(f32) / warped.to(f32))[:, None]
    right = center[:, None] + (i - warped[:, None]).to(f32) * (
        (t_len - 1 - center).to(f32)
        / torch.clamp(t_len - warped, min=1).to(f32))[:, None]
    src = torch.where(i < warped[:, None], left, right)
    src = torch.minimum(torch.clamp(src, min=0.0),
                        (t_len - 1).to(f32)[:, None])
    return torch.where((i < t_len[:, None]) & enabled[:, None], src,
                       i.to(f32).expand_as(src))


def _span(raw_w, raw_s, limit, max_width):
    """(start, width) with width ∈ [0, max_width], start ∈ [0, limit −
    width) (``_rand_span``, :75-81)."""
    width = raw_w % (max_width + 1)
    start = raw_s % torch.clamp(limit - width, min=1)
    return start, width


def apply_spec_augment(feat: torch.Tensor, feat_lens: torch.Tensor,
                       draws: dict, max_time_warp: int = 5,
                       max_t_ratio: float = 0.05, n_freq_masks: int = 2,
                       max_f_ratio: float = 0.15, n_time_masks: int = 2,
                       replace_with_zero: bool = False,
                       spec_sub_max_t: int = 0,
                       spec_sub_num: int = 0) -> torch.Tensor:
    """[B, T, D] features and their [B] frame counts → SpecAugment and
    SpecSub of every utterance under ``draws`` (the gate is not applied
    here)."""
    bsz, max_t, d = feat.shape
    t_len = torch.clamp(feat_lens.to(torch.long), min=1)
    t_idx = torch.arange(max_t, device=feat.device)[None, :]
    x = feat
    if max_time_warp > 0:
        src = _time_warp_src(t_len, max_t, max_time_warp,
                             draws['warp_center'], draws['warp_shift'])
        idx0 = torch.floor(src).to(torch.long)
        idx1 = torch.clamp(idx0 + 1, max=max_t - 1)
        frac = (src - idx0.to(torch.float32))[..., None].to(x.dtype)
        gather = lambda idx: torch.gather(  # noqa: E731
            x, 1, idx[..., None].expand(-1, -1, d))
        x = gather(idx0) * (1 - frac) + gather(idx1) * frac

    valid = (t_idx < t_len[:, None])[..., None]          # [B, T, 1]
    if replace_with_zero:
        fill = torch.zeros((bsz, 1, 1), dtype=x.dtype, device=x.device)
    else:
        fill = (torch.where(valid, x, 0.0).sum(dim=(1, 2))
                / (t_len.to(x.dtype) * d))[:, None, None]

    max_f = int(d * max_f_ratio)
    f_idx = torch.arange(d, device=feat.device)[None, :]
    for n in range(n_freq_masks):
        start, width = _span(draws['freq'][:, n, 0], draws['freq'][:, n, 1],
                             d, max_f)
        mask = (f_idx >= start[:, None]) & (f_idx < (start + width)[:, None])
        x = torch.where(mask[:, None, :] & valid, fill, x)

    max_w = torch.clamp((t_len.to(torch.float32) * max_t_ratio).to(torch.long),
                        min=0)
    for n in range(n_time_masks):
        start, width = _span(draws['time'][:, n, 0], draws['time'][:, n, 1],
                             t_len, max_w)
        mask = (t_idx >= start[:, None]) & (t_idx < (start + width)[:, None]) \
            & (t_idx < t_len[:, None])
        x = torch.where(mask[..., None], fill, x)

    if spec_sub_num > 0:
        orig = x
        for n in range(spec_sub_num):
            raw = draws['sub'][:, n]
            start = raw[:, 0] % t_len
            length = 1 + raw[:, 1] % spec_sub_max_t
            pos = raw[:, 2] % torch.clamp(start + 1, min=1)
            end = torch.minimum(t_len, start + length)
            mask = (t_idx >= start[:, None]) & (t_idx < end[:, None])
            src = torch.clamp(t_idx - pos[:, None], min=0)
            shifted = torch.gather(orig, 1, src[..., None].expand(-1, -1, d))
            x = torch.where(mask[..., None], shifted, x)
    return x


def _feature_stages(augment_configs):
    spec_conf, sub_conf, spec_prob, sub_prob = None, None, 0.0, 0.0
    for spec in (augment_configs or []):
        if spec.get('aug_type') != 'feature':
            continue
        if spec.get('type') == 'specaug':
            spec_conf = dict(spec.get('params', {}))
            spec_conf.pop('inplace', None)
            spec_prob = float(spec.get('prob', 0.0))
        elif spec.get('type') == 'specsub':
            sub_conf = dict(spec.get('params', {}))
            sub_prob = float(spec.get('prob', 0.0))
    if spec_conf is None and sub_conf is None:
        return None, 0.0
    kwargs = dict(spec_conf or {})
    if sub_conf is not None:
        kwargs['spec_sub_max_t'] = int(sub_conf.get('max_t', 30))
        kwargs['spec_sub_num'] = int(sub_conf.get('num_t_sub', 3))
    return kwargs, max(spec_prob, sub_prob)


def make_device_frontend(preprocess_conf: dict, augment_configs=None,
                         train: bool = True):
    """Build ``frontend(wav, wav_lens, generator=None, deterministic=False)
    → (feat [B, T, n_mels] float32, feat_lens [B] int32)``.

    ``wav`` [B, S] holds int16-scaled samples (any dtype; S a multiple of
    160 on the card), ``wav_lens`` [B] their counts. With ``train``, a
    generator and not ``deterministic``, the fbank is dithered and the
    feature stages of ``augment_configs`` (the parsed augmentation.json)
    apply; the audio stages are the dataset's, on the host."""
    conf = dict(preprocess_conf or {})
    method = conf.get('feature_method', 'fbank')
    if method != 'fbank':
        raise ValueError(
            f"device frontend supports feature_method='fbank' only, got "
            f"{method!r}")
    n_mels = int(conf.get('n_mels', 80))
    sample_rate = int(conf.get('sample_rate', 16000))
    aug_kwargs, prob = _feature_stages(augment_configs)

    @torch.no_grad()
    def frontend(wav, wav_lens, generator=None, deterministic=False):
        wav = wav.to(torch.float32).contiguous()
        random = train and not deterministic and generator is not None
        noise = None
        if random:
            bsz, s = wav.shape
            max_t = max(1 + (s - WINDOW_SIZE) // WINDOW_SHIFT, 0)
            noise = torch.randn((bsz, max_t, WINDOW_SIZE),
                                generator=generator, device=wav.device)
        feat, feat_lens = fbank_batch(wav, wav_lens, num_mel_bins=n_mels,
                                      sample_rate=sample_rate, noise=noise)
        if not random or aug_kwargs is None or prob <= 0.0:
            return feat, feat_lens
        draws = draw_spec_augment(
            feat.shape[0], generator, feat.device,
            max_time_warp=aug_kwargs.get('max_time_warp', 5),
            n_freq_masks=aug_kwargs.get('n_freq_masks', 2),
            n_time_masks=aug_kwargs.get('n_time_masks', 2),
            spec_sub_num=aug_kwargs.get('spec_sub_num', 0), prob=prob)
        augmented = apply_spec_augment(feat, feat_lens, draws, **aug_kwargs)
        if prob < 1.0:
            augmented = torch.where(draws['take'][:, None, None], augmented,
                                    feat)
        return augmented, feat_lens

    return frontend
