"""Host helpers of the port's distributed layer (``paddle_tpu/distributed/utils.py``):
the host name and address, free local ports and a console logger.

The reference's cluster, pod and launcher classes wait for the launcher
(ROADMAP.md, Queue 1 item 13d), and its ``global_scatter``/``global_gather``
expert exchange for expert parallelism (item 13c).
"""
from __future__ import annotations

import logging
import socket
from typing import Optional


def get_host_name_ip():
    """``(host name, its IPv4 address)``, or ``(None, None)``."""
    try:
        name = socket.gethostname()
        return name, socket.gethostbyname(name)
    except OSError:
        return None, None


def find_free_ports(num: int) -> Optional[set]:
    """``num`` distinct TCP ports free on this host (all held open until
    every one is found, so they differ)."""
    out = set()
    socks = []
    try:
        for _ in range(num):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.bind(("", 0))
            socks.append(s)
            out.add(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return out


def get_logger(log_level=20, name="root"):
    """The logger ``name`` at ``log_level``, with one stream handler."""
    logger = logging.getLogger(name)
    logger.setLevel(log_level)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(levelname)s %(asctime)s %(message)s"))
        logger.addHandler(h)
    return logger
