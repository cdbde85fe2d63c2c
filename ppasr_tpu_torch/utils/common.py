"""Small shared utilities (counterpart of ppasr_tpu/utils/common.py:15-66):
attribute-access config dicts (``AttrDict``, ``dict_to_object``) and the
argparse helpers ``add_arguments`` and ``print_arguments``. The JAX
package's ``add_arguments`` takes ``distutils.util.strtobool``, and Python
3.12 no longer ships ``distutils``, so the port has its own ``strtobool``.
"""
from ppasr_tpu_torch.utils.logger import setup_logger

logger = setup_logger(__name__)


class AttrDict(dict):
    """dict with attribute access, recursively applied by ``dict_to_object``."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value


def dict_to_object(d):
    """Recursively convert a plain dict into an AttrDict."""
    if isinstance(d, dict):
        return AttrDict({k: dict_to_object(v) for k, v in d.items()})
    if isinstance(d, (list, tuple)):
        return type(d)(dict_to_object(v) for v in d)
    return d


def strtobool(value: str) -> bool:
    """'y', 'yes', 't', 'true', 'on', '1' → True; 'n', 'no', 'f', 'false',
    'off', '0' → False, in any case; anything else raises ``ValueError``
    (as ``distutils.util.strtobool`` did, returning a bool)."""
    v = str(value).lower()
    if v in ('y', 'yes', 't', 'true', 'on', '1'):
        return True
    if v in ('n', 'no', 'f', 'false', 'off', '0'):
        return False
    raise ValueError(f"invalid truth value {value!r}")


def add_arguments(argname, type, default, help, argparser, **kwargs):
    """argparse helper; a ``bool`` option parses its value with
    ``strtobool``."""
    type = strtobool if type == bool else type
    argparser.add_argument("--" + argname,
                           default=default,
                           type=type,
                           help=help + ' 默认: %(default)s.',
                           **kwargs)


def print_arguments(args=None, configs=None, title=None):
    """Log the resolved CLI arguments and the config tree."""
    if args is not None:
        logger.info("----------- 额外配置参数 -----------")
        for arg, value in sorted(vars(args).items()):
            logger.info(f"{arg}: {value}")
        logger.info("------------------------------------------------")
    if configs is not None:
        logger.info(f"----------- {title or '配置文件参数'} -----------")

        def _print(d, indent=0):
            for k, v in d.items():
                if isinstance(v, dict):
                    logger.info(f"{' ' * indent}{k}:")
                    _print(v, indent + 2)
                else:
                    logger.info(f"{' ' * indent}{k}: {v}")
        _print(configs)
        logger.info("------------------------------------------------")


def labels_to_string(labels, vocabulary, eos: int = None,
                     blank_index: int = 0) -> str:
    """ids → text, dropping blank, −1 padding and eos (copy of
    ppasr_tpu/utils/common.py:101-114)."""
    if eos is None:
        eos = len(vocabulary) - 1
    return "".join(vocabulary[int(t)] for t in labels
                   if int(t) not in (blank_index, -1, eos))
