"""``device.idle_share`` in the cells whose host sets the pace (small partitions), where
the host's speed moves it from run to run far more than in the cells the
card sets the pace of: the same reading (``device.idle_share.py``), split so that
each keeps a bound or a moved metric of its own."""

import pathlib

from sortbench.harness import load_reader

read = load_reader(pathlib.Path(__file__).parent, "device.idle_share")
