"""Model factory: config → torch module (counterpart of
ppasr_tpu/models/factory.py:32-75), for the four families of the JAX
package: ``deepspeech2``, ``conformer``, ``squeezeformer`` and
``efficient_conformer``."""
from ppasr_tpu_torch.models.base import load_cmvn


def build_model(use_model: str, input_size: int, vocab_size: int,
                streaming: bool = True, encoder_conf=None, decoder_conf=None,
                model_conf=None, mean_istd_path: str = None):
    """Build the model module named by ``use_model``."""
    if use_model == 'deepspeech2':
        from ppasr_tpu_torch.models.deepspeech2 import DeepSpeech2Model
        mean, istd = load_cmvn(mean_istd_path)
        return DeepSpeech2Model(input_size=input_size, vocab_size=vocab_size,
                                streaming=streaming,
                                encoder_conf=dict(encoder_conf or {}),
                                decoder_conf=dict(decoder_conf or {}),
                                cmvn_mean=mean, cmvn_istd=istd)
    if use_model == 'conformer':
        from ppasr_tpu_torch.models.conformer import ConformerModel as cls
    elif use_model == 'squeezeformer':
        from ppasr_tpu_torch.models.squeezeformer import \
            SqueezeformerModel as cls
    elif use_model == 'efficient_conformer':
        from ppasr_tpu_torch.models.efficient_conformer import \
            EfficientConformerModel as cls
    else:
        raise ValueError(f"unsupported model: {use_model}")
    mean, istd = load_cmvn(mean_istd_path)
    return cls(input_size=input_size, vocab_size=vocab_size,
               streaming=streaming, encoder_conf=dict(encoder_conf or {}),
               decoder_conf=dict(decoder_conf or {}),
               cmvn_mean=mean, cmvn_istd=istd, **dict(model_conf or {}))
