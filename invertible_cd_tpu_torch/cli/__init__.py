"""The port's entry points, run as `python -m invertible_cd_tpu_torch.cli.<name>`."""
from __future__ import annotations

import argparse
import json
import sys


def apply_config_file(p: argparse.ArgumentParser, argv):
    """--config file.json sets parser defaults (CLI flags still override);
    keys starting with "_" and keys the parser does not know are ignored.
    Returns the argument list to parse."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--config" in argv:
        with open(argv[argv.index("--config") + 1]) as f:
            cfg = json.load(f)
        known = {a.dest for a in p._actions}
        p.set_defaults(**{k: v for k, v in cfg.items() if not k.startswith("_") and k in known})
    return argv
