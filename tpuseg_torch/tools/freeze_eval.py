"""One-time generation of the frozen hard eval asset (port of
``tools/freeze_eval.py``).

    python -m tpuseg_torch.tools.freeze_eval [--prefix PATH] [--force]

Writes ``<prefix>.{tsbin,tsidx,sha256}`` (default prefix:
``assets/eval_hard64``) through ``data/eval_asset.py::freeze_eval_records``
at the distribution the committed asset was made with: 64 images, seed 99,
hard, max_leaves 14.  Refuses when ``<prefix>.sha256`` exists and
``--force`` is not given: the point of the asset is that every quality
number is measured on the same bytes.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional

from tpuseg_torch.data.eval_asset import default_asset_prefix, freeze_eval_records


def main(argv: Optional[List[str]] = None) -> Dict[str, str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prefix", default=default_asset_prefix())
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    prefix = args.prefix
    if os.path.isfile(prefix + ".sha256") and not args.force:
        sys.exit(
            f"{prefix}.sha256 already exists — the asset is frozen. "
            "Pass --force only if you intend to re-pin it."
        )
    hashes = freeze_eval_records(prefix)
    for name, digest in sorted(hashes.items()):
        print(f"{digest}  {name}")
    print(f"frozen eval asset written to {prefix}.*")
    return hashes


if __name__ == "__main__":
    main()
