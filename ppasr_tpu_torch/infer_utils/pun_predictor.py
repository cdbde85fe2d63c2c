"""Punctuation restoration (counterpart of
ppasr_tpu/infer_utils/pun_predictor.py:31-132): a small transformer token
classifier that labels each character with the mark to insert after it.

``PunctuationModel``: token embedding plus the sinusoid table (no ×sqrt(d)),
pre-LN blocks of multi-head self-attention over the non-pad tokens and a
tanh-GELU feed-forward, a final LayerNorm (flax's default eps, 1e-6) and the
classifier. Its submodules carry the flax names (``Embed_0``, ``ln1_<i>``,
``attn_<i>``, ...), so ``utils/checkpoint.convert_params`` maps the weights
leaf for leaf.

``PunctuationPredictor`` reads ``pun_vocab.txt``, ``pun_labels.txt``,
``pun_config.txt`` and ``pun_model.msgpack`` from ``model_dir``, or from the
artifact committed with the JAX package (``ppasr_tpu/assets/pun_models``,
read by path) when ``model_dir`` lacks them; files that are missing or fail
to load raise. The model runs on ``device``. Text longer than the model's
``max_len`` is labelled in consecutive pieces of ``max_len`` characters (the
JAX model fails on it, and its predictor then returns the text unmarked).
"""
import os
import re

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ppasr_tpu_torch.models.attention import MultiHeadedAttention
from ppasr_tpu_torch.models.base import LayerNorm
from ppasr_tpu_torch.models.embedding import sinusoid_table
from ppasr_tpu_torch.utils.checkpoint import convert_params, load_msgpack

_FILES = ('pun_vocab.txt', 'pun_labels.txt', 'pun_model.msgpack')


class PunctuationModel(nn.Module):
    def __init__(self, vocab_size: int, num_labels: int, dim: int = 256,
                 heads: int = 4, layers: int = 4, ffn: int = 1024,
                 max_len: int = 512):
        super().__init__()
        self.layers = layers
        self.max_len = max_len
        self.Embed_0 = nn.Embedding(vocab_size, dim)
        self.register_buffer('pe', torch.from_numpy(sinusoid_table(dim,
                                                                   max_len)),
                             persistent=False)
        for i in range(layers):
            self.add_module(f'ln1_{i}', LayerNorm(dim, eps=1e-6))
            self.add_module(f'attn_{i}', MultiHeadedAttention(heads, dim))
            self.add_module(f'ln2_{i}', LayerNorm(dim, eps=1e-6))
            self.add_module(f'ff1_{i}', nn.Linear(dim, ffn))
            self.add_module(f'ff2_{i}', nn.Linear(ffn, dim))
        self.ln_out = LayerNorm(dim, eps=1e-6)
        self.classifier = nn.Linear(dim, num_labels)

    def forward(self, ids):
        """ids [B, T] (0 = pad) → label logits [B, T, num_labels]."""
        x = self.Embed_0(ids) + self.pe[None, :ids.shape[1]]
        mask = (ids > 0)[:, None, :]
        for i in range(self.layers):
            y = getattr(self, f'ln1_{i}')(x)
            x = x + getattr(self, f'attn_{i}')(y, y, y, mask=mask)[0]
            y = getattr(self, f'ln2_{i}')(x)
            y = F.gelu(getattr(self, f'ff1_{i}')(y), approximate='tanh')
            x = x + getattr(self, f'ff2_{i}')(y)
        return self.classifier(self.ln_out(x))


def packaged_pun_model_dir() -> str:
    """The punctuation artifact committed with the JAX package."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, 'ppasr_tpu', 'assets', 'pun_models')


class PunctuationPredictor:
    def __init__(self, model_dir: str = 'models/pun_models', device='cuda:0'):
        def complete(d):
            return all(os.path.exists(os.path.join(d, f)) for f in _FILES)
        if not complete(model_dir):
            model_dir = packaged_pun_model_dir()
        if not complete(model_dir):
            raise FileNotFoundError(
                f"punctuation model files missing in {model_dir}")
        vocab_path, labels_path, params_path = (os.path.join(model_dir, f)
                                                for f in _FILES)
        with open(vocab_path, 'r', encoding='utf-8') as f:
            self.vocab = [line.rstrip('\n') for line in f if line.strip()]
        with open(labels_path, 'r', encoding='utf-8') as f:
            self.labels = [line.rstrip('\n') for line in f]
        self.tok_to_id = {t: i for i, t in enumerate(self.vocab)}
        arch = {}
        cfg_path = os.path.join(model_dir, 'pun_config.txt')
        if os.path.exists(cfg_path):
            with open(cfg_path, 'r', encoding='utf-8') as f:
                for line in f:
                    if '=' in line:
                        k, v = line.strip().split('=', 1)
                        arch[k] = int(v)
        self.device = torch.device(device)
        self.model = PunctuationModel(len(self.vocab), len(self.labels),
                                      **arch)
        self.model.load_state_dict(convert_params(load_msgpack(params_path)),
                                   strict=True)
        self.model.to(self.device).eval()

    @staticmethod
    def _clean(text: str) -> str:
        """Strip the marks the model inserts, and their ASCII forms."""
        return re.sub(r"[,，。？?！!；;:：、]", "", text)

    @torch.inference_mode()
    def labels_of(self, text: str) -> np.ndarray:
        """Label ids of the characters of ``text`` (already clean)."""
        ids = torch.tensor([[self.tok_to_id.get(ch, 1) for ch in text]],
                           dtype=torch.long)
        n = self.model.max_len
        return np.concatenate([
            self.model(ids[:, i:i + n].to(self.device)).argmax(-1)[0].cpu()
            .numpy() for i in range(0, ids.shape[1], n)])

    def __call__(self, text: str) -> str:
        text = self._clean(text)
        if not text:
            return text
        out = []
        for ch, lab in zip(text, self.labels_of(text)):
            out.append(ch)
            mark = self.labels[int(lab)] if int(lab) < len(self.labels) \
                else ''
            if mark and mark != 'O':
                out.append(mark)
        return ''.join(out)
