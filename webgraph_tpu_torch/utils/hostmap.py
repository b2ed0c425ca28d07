"""BuildHostMap — URL list to host-graph mapping (BuildHostMap.java:76).

Reads one URL per line; emits, for each URL (= node of a web graph), the id
of its host, hosts being numbered in order of appearance.  Outputs match the
reference: the node -> host map (binary big-endian longs) and the host list
(one host per line, appearance order).  The port's own copy of
``webgraph_tpu/utils/hostmap.py``: host code, the same results and files.
"""

from __future__ import annotations

from typing import IO, List, Tuple, Union
from urllib.parse import urlsplit

import numpy as np

__all__ = ["build_host_map", "host_of"]


def host_of(url: str) -> str:
    """The host part of a URL (netloc without port/userinfo)."""
    s = urlsplit(url.strip())
    host = s.netloc or s.path.split("/")[0]
    if "@" in host:
        host = host.rsplit("@", 1)[1]
    if ":" in host:
        host = host.rsplit(":", 1)[0]
    return host.lower()


def build_host_map(lines: Union[IO[str], List[str]]
                   ) -> Tuple[np.ndarray, List[str]]:
    """Returns (node_to_host int64[n], hosts list in appearance order)."""
    node_to_host: List[int] = []
    hosts: List[str] = []
    index = {}
    for line in lines:
        line = line.strip()
        if not line:
            continue
        h = host_of(line)
        hid = index.get(h)
        if hid is None:
            hid = len(hosts)
            index[h] = hid
            hosts.append(h)
        node_to_host.append(hid)
    return np.asarray(node_to_host, dtype=np.int64), hosts


def write_host_map(map_path: str, hosts_path: str, node_to_host: np.ndarray,
                   hosts: List[str]) -> None:
    np.asarray(node_to_host, dtype=np.int64).astype(">i8").tofile(map_path)
    with open(hosts_path, "w") as f:
        for h in hosts:
            f.write(h + "\n")
