"""Native-resolution quality report (port of ``tools/native_res_report.py``).

    python -m tpuseg_torch.tools.native_res_report [--n 24] [--res 512]
        [--seed 7] [--batch 8] [--report PATH] [--work DIR] [--device cpu]

The reference's prediction path resizes every input to the 256x256 model
shape and upsamples the id map back to the native size, so native-size
ground truth is scored against upsampled 256-grid masks.  ``pred_list
--bucketed`` instead runs the whole network at the native shape.  This
tool scores the same fresh hard scenes at a non-256 native size through
the port's CLI chain both ways:

  A. resize256: 256 resize in, nearest upsample out (reference semantics);
  B. native --bucketed: native-shape inference, no resample either side.

Both runs are ``--f32``, so the comparison isolates the resolution
semantics.  The NATIVE_RES section is written into ``--report`` (default
``tpuseg_torch_report/REPORT.md`` under the temporary directory): it
replaces the marked section there, or is appended; ``quality_report``
keeps it across rewrites.  The repo's ``REPORT.md`` is written only when
given as ``--report``.  Scenes and predictions go under ``--work``
(default: a new temporary directory, kept).  The CLIs run as subprocesses
from the repo root, on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Tuple

from tpuseg_torch import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CKPT = os.path.join(REPO, "assets", "synthetic_ckpt.msgpack")
REPORT = os.path.join(tempfile.gettempdir(), "tpuseg_torch_report",
                      "REPORT.md")
A1 = ("data", "raw", "CVPPP", "CVPPP2017_LSC_training", "training", "A1")
MARK_BEGIN = "<!-- NATIVE_RES:BEGIN -->"
MARK_END = "<!-- NATIVE_RES:END -->"
# the two paths: tag -> extra pred_list flags
PATHS = {"resize256": [], "native_bucketed": ["--bucketed"]}


def sh(cmd: List[str], tail: int = 1500) -> str:
    """Run ``cmd`` from the repo root; its stdout, or RuntimeError when it
    exits non-zero."""
    print("+", " ".join(cmd), flush=True)
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO)
    print(out.stdout[-tail:], flush=True)
    if out.returncode != 0:
        print(out.stderr[-2000:], flush=True)
        raise RuntimeError(cmd)
    return out.stdout


def cli(name: str, *args: str) -> List[str]:
    return [sys.executable, "-m", f"tpuseg_torch.cli.{name}", *args]


def parse_metrics(ev_out: str):
    """Anchored parse of ``cli/evaluate.py``'s exact labels; raises on no
    match instead of taking a number from an unrelated line."""
    pats = {
        "sbd": r"^MEAN SBD\s*:\s*([-+0-9.eE]+|nan)\s*$",
        "dic": r"^MEAN \|DIC\|\s*:\s*([-+0-9.eE]+|nan)\s*$",
        "fg": r"^MEAN FG DICE\s*:\s*([-+0-9.eE]+|nan)\s*$",
    }
    vals = {}
    for line in ev_out.splitlines():
        for key, pat in pats.items():
            m = re.match(pat, line.strip())
            if m and key not in vals:
                vals[key] = float(m.group(1))
    missing = [k for k in pats if k not in vals]
    if missing:
        raise RuntimeError(
            f"evaluate output did not match expected labels {missing}; "
            f"raw output:\n{ev_out}"
        )
    return vals["sbd"], vals["dic"], vals["fg"]


def parse_launches(pred_out: str) -> Tuple[int, int]:
    """The ``ir_chain`` launches and extraction rounds ``cli/pred_list.py``
    reports."""
    m = re.search(r"^ir_chain launches (\d+) over (\d+) extraction rounds$",
                  pred_out, re.M)
    if m is None:
        raise RuntimeError(f"pred_list printed no launch count:\n{pred_out}")
    return int(m.group(1)), int(m.group(2))


def merge_section(text: str, section: str) -> str:
    """``text`` with its NATIVE_RES section replaced by ``section``, or
    with ``section`` appended where it has none."""
    if MARK_BEGIN in text:
        pre = text[: text.index(MARK_BEGIN)]
        post = text[text.index(MARK_END) + len(MARK_END):]
        return pre + section + post
    return text.rstrip() + "\n\n" + section + "\n"


def write_report(path: str, section: str) -> None:
    text = open(path).read() if os.path.isfile(path) else ""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(merge_section(text, section))


def run(n: int = 24, res: int = 512, seed: int = 7, batch: int = 8,
        report: str = REPORT, device: str = "cuda",
        work: Optional[str] = None) -> Dict:
    """Generate the scenes under ``work`` (default: a new temporary
    directory, kept), run both paths, write the section; returns
    ``{"lst", "section", tag: {"sbd", "dic", "fg", "pred_dir",
    "ir_chain_launches", "rounds"}}``."""
    resolve_device(device)
    from tpuseg_torch.data.synthetic import write_synthetic_eval_tree

    tmp = work or tempfile.mkdtemp(prefix="tpuseg_torch_native_")
    lst = write_synthetic_eval_tree(tmp, n, seed=seed, height=res, width=res,
                                    hard=True, max_leaves=14)
    meta = os.path.dirname(lst)
    img_dir = os.path.join(tmp, *A1)
    out: Dict = {"lst": lst}
    for tag, extra in PATHS.items():
        pred_dir = os.path.join(tmp, "out_" + tag)
        pred = sh(cli("pred_list", "--lst", lst, "--model", CKPT,
                      "--dataset", "CVPPP", "--batchsize", str(batch),
                      "--output", pred_dir, "--f32", "--device", device,
                      *extra))
        ev = sh(cli("evaluate", "--pred_dir", pred_dir, "--dataset", "CVPPP",
                    "--metadata", meta, "--img_dir", img_dir,
                    "--device", device))
        sbd, dic, fg = parse_metrics(ev)
        launches, rounds = parse_launches(pred)
        out[tag] = {"sbd": sbd, "dic": dic, "fg": fg, "pred_dir": pred_dir,
                    "ir_chain_launches": launches, "rounds": rounds}

    a, b = out["resize256"], out["native_bucketed"]
    out["section"] = "\n".join([
        MARK_BEGIN,
        "## Native-resolution quality (tpuseg_torch/tools/native_res_report.py)",
        "",
        f"{n} fresh hard scenes at {res}x{res} native (seed {seed}), scored "
        f"via the port's CLI chain on `{device}`, f32 both ways. 'resize256' "
        "is the reference's semantics — model at 256², nearest-upsampled "
        "masks scored against native GT; 'native' is `pred_list "
        "--bucketed` running the network at the native shape.",
        "",
        "| path | SBD | |DiC| | FG dice |",
        "|---|---|---|---|",
        f"| resize256 (reference semantics) | {a['sbd']} | {a['dic']} | "
        f"{a['fg']} |",
        f"| native --bucketed | {b['sbd']} | {b['dic']} | {b['fg']} |",
        "",
        f"Delta (native - resize256): SBD {b['sbd'] - a['sbd']:+.4f}, "
        f"|DiC| {b['dic'] - a['dic']:+.3f}.",
        MARK_END,
    ])
    write_report(report, out["section"])
    print(out["section"], flush=True)
    print(f"report: {report}; scenes and predictions under {tmp}", flush=True)
    return out


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--report", default=REPORT)
    ap.add_argument("--work", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.n, args.res, args.seed, args.batch, args.report,
               args.device, args.work)


if __name__ == "__main__":
    main()
