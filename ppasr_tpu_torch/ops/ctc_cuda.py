"""Kernel C1, the CTC lattice: build, bind and launch ``csrc/ctc.cu``.

Replaces no Pallas kernel: the JAX package runs the lattice as the
``lax.scan`` of ppasr_tpu/ops/ctc.py:139-174. ``ctc_lattice_alpha`` runs the
forward recursion over a row's frames inside one block per utterance and
writes alpha and each row's NLL; ``ctc_lattice_beta`` walks the frames
downward with the adjoint of those operations and writes the gradient of
the emissions. One launch each per loss call, in place of a Python loop
over frames that autograd recorded (about 40 launches a frame). What bounds
them is the chain of T dependent steps; the source's note says what the
design does about it.

The library is built as B1's is (``ops/cuda_build.py``: plain ``nvcc`` for
``sm_90a``, a C interface, ``ctypes``), at the first call on a CUDA tensor.
``ops/ctc.py`` sends a CUDA tensor here, through ``CTCLattice``, where each
function launches its kernel or raises, and a CPU tensor to the plain
``lattice_alpha`` beside it. ``launches`` counts kernel launches and
nothing else.
"""
import ctypes
from pathlib import Path

import torch

from ppasr_tpu_torch.ops import cuda_build

SOURCE = Path(__file__).resolve().parent.parent / 'csrc' / 'ctc.cu'
MAX_S = 8192   # csrc/ctc.cu: kMaxItems × kMaxThreads; U ≤ 4,095 labels

launches = 0
_lib = None


def build(force: bool = False) -> Path:
    return cuda_build.build(SOURCE, 'ctc_lattice', force)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ctc_lattice_alpha_launch.argtypes = [p, p, p, p, p, i, i, i, p,
                                                 p, p]
        lib.ctc_lattice_beta_launch.argtypes = [p, p, p, p, p, p,
                                                ctypes.c_longlong, i, i, i,
                                                p, p]
        lib.ctc_lattice_alpha_launch.restype = i
        lib.ctc_lattice_beta_launch.restype = i
        _lib = lib
    return _lib


def _lattice_args(lattice, input_lengths, label_lengths, valid_s, can_skip):
    """Checks what the kernels take; returns the lengths as int32 on the
    lattice's device."""
    if lattice.device.type != 'cuda':
        raise ValueError(f"CTC lattice kernel needs a CUDA tensor, got "
                         f"{lattice.device}")
    if lattice.dtype != torch.float32 or not lattice.is_contiguous() or \
            lattice.ndim != 3:
        raise TypeError(f"CTC lattice kernel needs a contiguous float32 "
                        f"[B, T, S] tensor, got {lattice.dtype} "
                        f"{tuple(lattice.shape)}")
    bsz, max_t, s_len = lattice.shape
    if max_t < 1 or s_len < 1:
        raise ValueError(f"CTC lattice needs T ≥ 1 and S ≥ 1, got "
                         f"{tuple(lattice.shape)}")
    if s_len > MAX_S:
        raise ValueError(f"S = 2U + 1 = {s_len} extended labels; the CTC "
                         f"lattice kernel holds at most {MAX_S} (U ≤ "
                         f"{(MAX_S - 1) // 2})")
    for name, mask in (('valid_s', valid_s), ('can_skip', can_skip)):
        if mask.dtype != torch.bool or tuple(mask.shape) != (bsz, s_len) \
                or mask.device != lattice.device or not mask.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bool [{bsz}, "
                             f"{s_len}] tensor on {lattice.device}")
    return tuple(x.to(device=lattice.device, dtype=torch.int32).contiguous()
                 for x in (input_lengths, label_lengths))


def lattice_alpha(emit_all, input_lengths, label_lengths, valid_s, can_skip,
                  keep_alpha: bool):
    """One ``ctc_lattice_alpha`` launch: (nll [B], alpha [B, T, S] or
    None). Alpha's rows at and past a row's frame count are left
    unwritten; ``lattice_beta`` never reads them."""
    global launches
    in_lens, lab_lens = _lattice_args(emit_all, input_lengths,
                                      label_lengths, valid_s, can_skip)
    bsz, max_t, s_len = emit_all.shape
    nll = torch.empty(bsz, dtype=torch.float32, device=emit_all.device)
    alpha = torch.empty_like(emit_all) if keep_alpha else None
    lib = _library()
    with torch.cuda.device(emit_all.device):
        stream = torch.cuda.current_stream(emit_all.device).cuda_stream
        rc = lib.ctc_lattice_alpha_launch(
            emit_all.data_ptr(), valid_s.data_ptr(), can_skip.data_ptr(),
            in_lens.data_ptr(), lab_lens.data_ptr(), bsz, max_t, s_len,
            None if alpha is None else alpha.data_ptr(), nll.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"ctc_lattice_alpha launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return nll, alpha


def lattice_beta(alpha, input_lengths, label_lengths, valid_s, can_skip,
                 grad_nll):
    """One ``ctc_lattice_beta`` launch: the gradient [B, T, S] of
    Σ_b grad_nll[b] · nll[b] with respect to the emissions, from
    ``lattice_alpha``'s alpha. ``grad_nll`` [B] float32 may be an expanded
    scalar (stride 0)."""
    global launches
    in_lens, lab_lens = _lattice_args(alpha, input_lengths, label_lengths,
                                      valid_s, can_skip)
    bsz, max_t, s_len = alpha.shape
    if grad_nll.dtype != torch.float32 or tuple(grad_nll.shape) != (bsz,) \
            or grad_nll.device != alpha.device:
        raise ValueError(f"grad_nll must be a float32 [{bsz}] tensor on "
                         f"{alpha.device}")
    grad = torch.empty_like(alpha)
    lib = _library()
    with torch.cuda.device(alpha.device):
        stream = torch.cuda.current_stream(alpha.device).cuda_stream
        rc = lib.ctc_lattice_beta_launch(
            alpha.data_ptr(), valid_s.data_ptr(), can_skip.data_ptr(),
            in_lens.data_ptr(), lab_lens.data_ptr(), grad_nll.data_ptr(),
            grad_nll.stride(0), bsz, max_t, s_len, grad.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ctc_lattice_beta launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return grad
