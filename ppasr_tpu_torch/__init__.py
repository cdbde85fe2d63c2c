"""ppasr_tpu_torch — the PyTorch/CUDA port of ``ppasr_tpu`` for NVIDIA Hopper.

Counterpart of ``ppasr_tpu/__init__.py``. The port imports torch, numpy,
scipy and the standard library only: never JAX, flax, msgpack, PyYAML or
anything of ``ppasr_tpu`` (whose ``__init__`` imports JAX). Code it shares
with the JAX package is copied here. Entry points run on the card
(``cuda:0``) unless the caller asks for the CPU.

Ported so far: the Conformer predictor (config and checkpoint readers,
host and device fbank with the hand-written CUDA kernel in
``csrc/fbank.cu``, the encoder with its CTC head and attention decoder;
greedy, beam-search and attention-rescoring decoding; float32 or bfloat16
compute), offline, batched (``predict_batch``), long-audio through Silero
VAD (``predict_long``) and streaming, with punctuation and ITN; the
multi-stream engine (``serving``), the batched streaming eval
(``models/streaming_eval``), CER and WER (``utils/metrics``) and the CLI
``python -m ppasr_tpu_torch.infer_path``; training in one process
(``trainer.PPASRTrainer``, ``python -m ppasr_tpu_torch.train``): the CTC and
label-smoothed attention losses, the device frontend (B1 with the training
dither, SpecAugment, SpecSub), AdamW with its schedules, gradient
accumulation and bf16 over float32 parameters, for all four model
families; and the rest of the recipe: ``python -m ppasr_tpu_torch.
create_data``, ``extract_features``, ``eval`` (every decoder), ``tune`` and
``export_model``; the deployment path: int8 artifacts (``utils/quant``),
``torch.export`` programs served without model code
(``infer_utils/torch_export``, ``infer_utils/inference_predictor``) and
the HTTP + WebSocket server (``python -m ppasr_tpu_torch.infer_server``).
See ROADMAP.md for what is still to come.
"""

__version__ = "0.1.0"
