"""The decoder a config names, for the predictor and the trainer alike
(counterpart of ppasr_tpu/predict.py:216-287 and ppasr_tpu/trainer.py:
640-692):

- ``'ctc_greedy'``: None (the callers decode greedy themselves);
- ``'ctc_beam_search'``: ``conf['backend']`` ``'torch'`` (alias ``'jax'``,
  the JAX package's name; the default) is ``TorchBeamSearchDecoder`` on
  ``device``, ``'host'`` the numpy ``BeamSearchDecoder``, ``'native'`` the
  C++ one; an existing ``.klm`` language model goes to ``'native'``;
- ``'attention_rescoring'``: ``AttentionRescoringDecoder`` over the
  on-device beam with the same options, ``rescore_ctc_weight`` (default
  the model's ``ctc_weight``) and ``max_hyp_len`` (200) taken out of them.

Whatever cannot be built raises, where the JAX package decodes greedy: an
unknown decoder or backend, rescoring with DeepSpeech2, which has no
attention decoder, and a decoder whose constructor fails.
"""
import os

from ppasr_tpu_torch.decoders.beam_search import BeamSearchDecoder
from ppasr_tpu_torch.decoders.beam_search_torch import TorchBeamSearchDecoder
from ppasr_tpu_torch.decoders.native import NativeBeamSearchDecoder
from ppasr_tpu_torch.decoders.rescoring import AttentionRescoringDecoder
from ppasr_tpu_torch.utils.logger import setup_logger

logger = setup_logger(__name__)

DECODERS = ('ctc_greedy', 'ctc_beam_search', 'attention_rescoring')


def build_decoder(name: str, conf: dict, vocab_list, model, use_model: str,
                  model_conf: dict, device):
    """The decoder ``name`` with the beam options ``conf`` (the configs'
    ``ctc_beam_search_decoder_conf``) for ``model`` on ``device``."""
    if name not in DECODERS:
        raise ValueError(f"unknown decoder {name!r}; one of {DECODERS}")
    if name == 'ctc_greedy':
        return None
    conf = dict(conf or {})
    backend = conf.pop('backend', 'torch')
    if name == 'attention_rescoring':
        if use_model == 'deepspeech2':
            raise ValueError("deepspeech2 has no attention decoder")
        ctc_weight = conf.pop('rescore_ctc_weight',
                              dict(model_conf or {}).get('ctc_weight', 0.3))
        max_hyp_len = conf.pop('max_hyp_len', 200)
        return AttentionRescoringDecoder(
            model, vocab_list, ctc_weight=ctc_weight,
            max_hyp_len=max_hyp_len, device=device, **conf)
    lm = conf.get('language_model_path')
    if backend in ('torch', 'jax') and lm and str(lm).endswith('.klm') \
            and os.path.exists(lm):
        # a .klm holds its n-grams as hashes, which the device tables
        # cannot be built from; the native decoder reads the binary
        logger.info(".klm language model: using the native beam-search "
                    "backend")
        backend = 'native'
    if backend == 'host':
        return BeamSearchDecoder(vocab_list=vocab_list, **conf)
    if backend == 'native':
        return NativeBeamSearchDecoder(vocab_list=vocab_list, **conf)
    if backend in ('torch', 'jax'):
        return TorchBeamSearchDecoder(vocab_list=vocab_list, device=device,
                                      **conf)
    raise ValueError(f"unknown beam-search backend {backend!r}")
