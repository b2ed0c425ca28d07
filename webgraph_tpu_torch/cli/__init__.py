"""Command-line tools of the port: ``python -m webgraph_tpu_torch <command>``.

Counterpart of ``webgraph_tpu/cli``: the reference's mains as subcommands,
with the same arguments and printed lines -- ``bvgraph`` (BVGraph.main),
``efgraph`` (EFGraph.main), ``transform`` (Transform.main:2092-2106 verb
set), ``ascii``/``scattered`` (import formats), ``stats`` (Stats.main),
``hyperball`` (HyperBall.main), ``bfs``/``cc``/``scc`` (algo mains),
``speedtest`` (test/SpeedTest).  Each runs on the GPU unless ``--device``
names another device.
"""

from .main import main

__all__ = ["main"]
