"""The benchmark and smoke CLIs of the port, one module per root harness of
the JAX package (``bench.py``, ``bench_flashattention.py``,
``bench_decode.py``, ``bench_serving.py``, ``bench_train.py``, ``lab.py``,
``smoke.py``), with the same names, flags, defaults and JSON keys, plus
``--device``: each runs on the card unless asked for the CPU
(``--device cpu``, the plain versions; with no card and no such request it
raises).  Run one as ``python -m flashattention_tpu_torch.cli.<name>``; each
has ``main(argv=None)``.  Where a JAX key names a TPU it names the card
here, and every row carries ``card``: the ``nvidia-smi`` name and power
limit of the card it ran on (None on the CPU, whose times are host-clock
times and never a device metric).
"""

from __future__ import annotations

import argparse

import torch

from flashattention_tpu_torch.utils import benchit
from flashattention_tpu_torch.utils.device import resolve_device

__all__ = ["add_device", "card_of", "make_random"]


def add_device(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default=None,
                        help="cuda (default: the card) or cpu (the plain versions)")


def card_of(device: torch.device):
    """The ``nvidia-smi`` ``name, power.limit`` line of ``device``'s card;
    None on the CPU."""
    return benchit.card_info() if device.type == "cuda" else None


def make_random(seed: int, shape, dtype, device) -> torch.Tensor:
    """Uniform in [-1, 1) from a generator seeded with ``seed`` on ``device``
    (``utils.testing.make_random``, one generator a tensor as the JAX CLIs
    split one key a tensor)."""
    from flashattention_tpu_torch.utils.testing import make_random as mr

    return mr(torch.Generator(device=device).manual_seed(seed), shape, dtype)


def parse(parser: argparse.ArgumentParser, argv):
    """Parse ``argv`` and resolve ``--device``: ``(args, device)``."""
    args = parser.parse_args(argv)
    return args, resolve_device(args.device)
