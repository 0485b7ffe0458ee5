"""The workload plane, the port's part of it so far: :mod:`.mixes`, the
benches' named numpy request mixes (a copy of the JAX package's, draw
for draw: the serving bench's ``interference`` and the fleet bench's
``fleet_bursty`` / ``fleet_spike``).  The scenario core, catalog and
player are not ported yet."""

from .mixes import MIXES, build_mix

__all__ = ["MIXES", "build_mix"]
