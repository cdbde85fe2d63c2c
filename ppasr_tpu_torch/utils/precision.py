"""Float32 precision on the card for every entry point that runs a model
(``ieee_float32``), in a module of its own so that the served programs
(``infer_utils/inference_predictor``) hold it without importing the model
code that ``predict`` imports."""
import contextlib
import threading

import torch

_tf32_lock = threading.Lock()
_tf32_callers = 0
_tf32_saved = None


@contextlib.contextmanager
def ieee_float32():
    """TF32 off for matmuls and cuDNN, and cuBLAS's reduced-precision bf16
    reductions off, while any caller, in any thread, is inside the block;
    the process' flags restored when the last one leaves. The first to
    enter saves the flags, the last to leave restores them, so a caller
    leaving never turns them back on under another still inside. PyTorch
    lets cuDNN use TF32 by default, which would run the subsampling and
    depthwise convolutions at a 10-bit mantissa, and lets cuBLAS reduce
    bf16 products in bf16, where XLA accumulates them in float32. Sets the
    same flags as ``torch.backends.cudnn.flags`` and
    ``torch.backends.cuda.matmul``."""
    global _tf32_callers, _tf32_saved
    matmul = torch.backends.cuda.matmul
    with _tf32_lock:
        if _tf32_callers == 0:
            _tf32_saved = (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                           matmul.allow_bf16_reduced_precision_reduction)
            matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            matmul.allow_bf16_reduced_precision_reduction = False
        _tf32_callers += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_callers -= 1
            if _tf32_callers == 0:
                (matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                 matmul.allow_bf16_reduced_precision_reduction) = _tf32_saved
