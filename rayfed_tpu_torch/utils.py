# Copyright 2026 The rayfed-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""Shared utilities: dependency resolution, logging, address validation
(copied from the JAX package's ``utils.py``), and device resolution, the
counterpart of its ``is_tpu_backend``.

Every entry point that places state takes a ``device``. Left unset (or
``"auto"``) it means the CUDA card, and with no card that is an error, not
a quiet fall back to the CPU: the CPU runs only when the caller asks for
it, as the tests do.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, Optional, Tuple, Union

import torch

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.fed_object import FedObject

logger = logging.getLogger(__name__)

DeviceLike = Optional[Union[str, int, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless device says
    otherwise. Raises when CUDA is asked for (explicitly or by default)
    and no card is available."""
    if device is None or device == "auto":
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rayfed_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def is_cuda_backend(device: DeviceLike = None) -> bool:
    """True when work for ``device`` (default: the auto choice) runs on
    CUDA. Every flash-vs-plain "auto" gate in the port uses this."""
    if device is None or device == "auto":
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def resolve_dependencies(
    current_party: str, current_fed_task_id: int, *args, **kwargs
) -> Tuple[tuple, dict]:
    """Replace every ``FedObject`` in the argument pytree with a value future.

    Own-party objects yield their live future; foreign objects yield a
    ``recv`` future parked on the (producer id, this consumer id) rendezvous,
    cached on the handle so repeated consumption does not re-receive
    (ref ``fed/utils.py:48-83``).
    """
    flattened_args, tree_spec = tree_util.tree_flatten((args, kwargs))
    indexes = []
    resolved = []
    for idx, arg in enumerate(flattened_args):
        if isinstance(arg, FedObject):
            indexes.append(idx)
            if arg.get_party() == current_party:
                resolved.append(arg.get_value_future())
            else:
                fut = arg.get_value_future()
                if fut is None:
                    from rayfed_tpu_torch.proxy.barriers import recv

                    fut = recv(
                        current_party,
                        arg.get_party(),
                        arg.get_fed_task_id(),
                        current_fed_task_id,
                    )
                    arg._cache_value_future(fut)
                resolved.append(fut)
    if indexes:
        for idx, actual_val in zip(indexes, resolved):
            flattened_args[idx] = actual_val
    args, kwargs = tree_util.tree_unflatten(flattened_args, tree_spec)
    return args, kwargs


class _ContextFilter(logging.Filter):
    """Injects party / job name into every record
    (ref ``fed/utils.py:99-146``, format ``constants.py:30``)."""

    def __init__(self, party: str, job_name: str):
        super().__init__()
        self._party = party
        self._job_name = job_name

    def filter(self, record: logging.LogRecord) -> bool:
        record.party = self._party
        record.jobname = self._job_name
        return True


def setup_logger(
    logging_level,
    logging_format: str,
    date_format: str = "%Y-%m-%d %H:%M:%S",
    party_val: str = "",
    job_name: str = "",
) -> None:
    root = logging.getLogger()
    if isinstance(logging_level, str):
        logging_level = getattr(logging, logging_level.upper())
    root.setLevel(logging_level)
    # Replace our previous handler if re-initialized (repeat init tests).
    for h in list(root.handlers):
        if getattr(h, "_fedtpu_handler", False):
            root.removeHandler(h)
    handler = logging.StreamHandler()
    handler._fedtpu_handler = True  # type: ignore[attr-defined]
    handler.setFormatter(logging.Formatter(logging_format, datefmt=date_format))
    handler.addFilter(_ContextFilter(party_val, job_name))
    root.addHandler(handler)


_ADDR_RE = re.compile(r"^(?P<host>[^:/ ]+):(?P<port>\d{1,5})$")


def parse_address(address: str) -> "tuple[str, int]":
    """Split a validated ``host:port`` into its parts — the one place
    the accepted address format is interpreted (transports and the
    readiness probe must agree on it)."""
    host, port = address.rsplit(":", 1)
    return host, int(port)


def validate_address(address: str) -> None:
    """Accept ``host:port`` or ``hostname:port``; reject schemes and
    malformed ports (behavioral contract of ref ``fed/utils.py:198-239``,
    tested by ``fed/tests/without_ray_tests/test_utils.py``)."""
    if not isinstance(address, str):
        raise ValueError(f"address must be a string, got {type(address)}")
    m = _ADDR_RE.match(address)
    if not m:
        raise ValueError(
            f"Invalid address '{address}': expected 'host:port' "
            "with no URL scheme."
        )
    port = int(m.group("port"))
    if not 0 < port < 65536:
        raise ValueError(f"Invalid port in address '{address}'.")


def validate_addresses(addresses: Dict[str, Any]) -> None:
    if not isinstance(addresses, dict) or not addresses:
        raise ValueError("addresses must be a non-empty {party: 'host:port'} dict")
    for party, addr in addresses.items():
        if not isinstance(party, str) or not party:
            raise ValueError(f"party name must be a non-empty string, got {party!r}")
        validate_address(addr)


def dict2tuple(dic: Dict) -> tuple:
    """Stable tuple form of a dict for hashing/logging
    (ref ``fed/utils.py:182-195``)."""
    if dic is None:
        return ()
    return tuple(sorted(dic.items()))
