"""The numbers that decide ``correct``, each against the cell's limit in
``limits/<workload>.json``.

For CTC posteriors served at a frame (the program's [N, V] against the
reference's, same frames):

- ``prob_maxdiff``: the largest |p_program − p_reference| over every frame
  and token;
- ``top1_gap``: the largest amount by which the reference's log-probability
  of the program's first token lies below the reference's best.

``served_mismatch`` counts utterances whose served text is not the greedy
collapse of the posteriors the model returned for them, or whose frame or
window count is not the reference's: an exact count, limit 0."""
import contextlib
import gc
import sys

import torch


class Readings:
    def __init__(self):
        self.prob_maxdiff = 0.0
        self.top1_gap = 0.0
        self.served_mismatch = 0
        self.frames = 0

    def add_probs(self, prog: torch.Tensor, ref: torch.Tensor):
        """prog, ref [N, V] posteriors of the same N frames."""
        if prog.shape != ref.shape:
            raise ValueError(f"shapes differ: {tuple(prog.shape)} against "
                             f"{tuple(ref.shape)}")
        if prog.numel() == 0:
            return
        prog, ref = prog.float(), ref.float()
        self.prob_maxdiff = max(self.prob_maxdiff,
                                (prog - ref).abs().max().item())
        logp = torch.log(ref.clamp_min(torch.finfo(torch.float32).tiny))
        gap = logp.max(-1).values - logp.gather(
            -1, prog.argmax(-1, keepdim=True))[:, 0]
        self.top1_gap = max(self.top1_gap, gap.max().item())
        self.frames += prog.shape[0]

    def values(self) -> dict:
        return {'prob_maxdiff': self.prob_maxdiff,
                'top1_gap': self.top1_gap,
                'served_mismatch': self.served_mismatch}


def collapse(ids, vocab, blank: int = 0) -> str:
    out, prev = [], -1
    for i in ids:
        i = int(i)
        if i != prev and i != blank:
            out.append(vocab[i])
        prev = i
    return ''.join(out)


def judge(values: dict, limits: dict):
    """(correct, {name: {'value', 'limit'}}); each number must be at or
    under its limit, and a NaN fails."""
    checks = {k: {'value': values[k], 'limit': limits[k]} for k in limits}
    ok = all(v['value'] <= v['limit'] for v in checks.values())
    return ok, checks


def print_checks(checks: dict):
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def release():
    """Free what the program held before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@contextlib.contextmanager
def precision(tf32: bool):
    """The reference's arithmetic: float32 with TF32 off, or, for the
    control, TF32 on (matrix products and cuDNN convolutions)."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = tf32
    try:
        with torch.no_grad():
            yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
