"""Model summary: parameter counts per module (counterpart of
ppasr_tpu/utils/model_summary.py:17-33), grouped by the first
``max_depth + 1`` parts of each parameter's name."""
from ppasr_tpu_torch.utils.logger import setup_logger

logger = setup_logger(__name__)


def summary(model, max_depth: int = 2, print_fn=None) -> int:
    """Print a per-module parameter-count table; returns total params."""
    print_fn = print_fn or logger.info
    counts = {}
    for name, p in model.named_parameters():
        group = '/'.join(name.split('.')[:max_depth + 1])
        counts[group] = counts.get(group, 0) + p.numel()
    total = sum(counts.values())
    width = max((len(k) for k in counts), default=10) + 2
    print_fn("-" * (width + 16))
    for k in sorted(counts):
        print_fn(f"{k:<{width}}{counts[k]:>12,}")
    print_fn("-" * (width + 16))
    print_fn(f"{'total':<{width}}{total:>12,}  "
             f"({total * 4 / 1024 / 1024:.1f} MB fp32)")
    return total
