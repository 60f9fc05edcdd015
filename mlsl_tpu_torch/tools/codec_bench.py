"""B1 and B2, the int8 block codec, at the shapes their paths give them, for
one checkout or for several in turns on one card.

Run from the root of a checkout, on a machine with a card:

    python3 -m mlsl_tpu_torch.tools.codec_bench [TREE ...]

Each TREE is the root of a checkout: this one when none is given, or, say, an
earlier commit unpacked with ``git archive`` into ``build/parent``. Each is
timed in a process of its own, in the order given, with that checkout's
``mlsl_tpu_torch`` and its kernels built from its own sources, so ``build/parent
. . build/parent`` times a parent and a change in turns (parent, change,
change, parent). The rows and their timing are this checkout's chip_smoke.py
(``codec_rows``, ``codec_entry``): for each row the time as the path pays it
(``ms``, the wrapper's host work included), the device time alone
(``graph_ms``, 20 calls in one CUDA graph), the plain version's time and the
bound. Prints the card's name and power limit, then one JSON line a tree and
row; exits non-zero when a kernel's result differs from its plain version's.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
KEYS = ("name", "shape", "ms", "graph_ms", "plain_ms", "bound_ms", "max_abs_err")


def _smoke():
    """This checkout's chip_smoke.py (a TREE may hold its own, older one)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_tree(tree: Path) -> list:
    """Every codec row timed with ``tree``'s kernels (in this process)."""
    sys.path.insert(0, str(tree))
    import torch
    from mlsl_tpu_torch.ops import quant_kernels as qk

    cs = _smoke()
    dev = torch.device("cuda", 0)
    bw, f32, _ = cs.card_rates(torch.cuda.get_device_name(0))
    return [{"tree": str(tree), **{k: e[k] for k in KEYS}}
            for e in (cs.codec_entry(torch, qk, kind, rows, block, bw, f32, {}, dev, tag=tag)
                      for kind, rows, block, tag in cs.codec_rows())]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", default=["."], help="checkout roots, in turn")
    ap.add_argument("--one", help=argparse.SUPPRESS)   # a child: time this tree
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("codec_bench: torch.cuda.is_available() is false: this needs a card")
    if args.one:
        rows = time_tree(Path(args.one))
        for row in rows:
            print(json.dumps(row), flush=True)
        return int(any(row["max_abs_err"] != 0 for row in rows))
    print(_smoke().nvidia_smi_line(), flush=True)
    rc = 0
    for tree in args.trees:
        tree = Path(tree).resolve()
        rc |= subprocess.run([sys.executable, __file__, "--one", str(tree)], cwd=tree).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
